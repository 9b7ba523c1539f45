"""Hand-written CUDA kernels of the tile blend, their plain PyTorch
versions, and the autograd Function that joins forward and backward.

Three kernels live in ``lvdgs_torch/csrc/blend.cu``; each replaces one
Pallas TPU kernel of ``lvdgs_tpu/ops/rasterizer_pallas.py``:

- ``blend_forward``  <- ``_make_fwd_kernel`` (front-to-back blend),
- ``blend_backward`` <- ``_make_bwd_kernel`` (its VJP),
- ``median_depth``   <- ``_make_median_kernel`` (transmittance-median depth).

Layouts are those of the Pallas kernels: tile params ``tp`` are (K, T, 10)
float32 with fields [mean_x, mean_y, conic_a, conic_b, conic_c, r, g, b,
depth, opacity], front slot first; ``counts`` (T,) int32 holds the valid
prefix length of each tile's slot list; pixels are the 256 pixels of a
16x16 tile, row-major.

Each wrapper launches its kernel for CUDA tensors and uses the plain
version only for CPU tensors; any other device raises. There is no
fallback from a CUDA tensor to the plain version.

Stop rule, shared by every kernel and its plain version: a tile marches its
slots in order and stops before slot k once k reaches its count or no pixel
of the tile has transmittance above the threshold (T_EPS for the blend,
0.5 for the median). The Pallas kernels test the same condition per group
of ``tile_group`` tiles and every 4 slots, so after a pixel saturates they
may multiply its transmittance by a few more slots than this rule does.
Contributions are identical (a pixel at T <= T_EPS contributes nothing);
the final transmittance of saturated pixels and the backward's
``-g_T * T_final / (1 - alpha)`` term through them differ by T_EPS-sized
amounts.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

NF = 10
TILE = 16
P = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1.0e-4
MAX_K = 1024  # slots per tile the kernels' shared-memory counters hold

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "blend.cu"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


class LaunchCounter:
    """Number of kernel launches made by one wrapper. Thread-safe: the
    dataset's prefetch thread renders through the same kernels."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


# ---------------------------------------------------------------------------
# build and load


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build_library(fmad: bool = False) -> Path:
    """Compile blend.cu into a plain-C shared library under
    ``lvdgs_torch/_build/<hash of source and flags>/`` unless it is there
    already. Returns the library's path.

    The kernels are built with ``-fmad=false``: no multiply-add
    contraction, so they round every operation as the plain PyTorch
    versions do (one kernel per op). Their alpha and stop-rule gates are
    hard thresholds, where one rounding step can switch a whole slot's term
    on or off; with the same rounding, forward and median reproduce the
    plain versions bit for bit. ``fmad=True`` builds with nvcc's default
    contraction; chip_smoke.py times that build against this one."""
    flags = [*_NVCC_FLAGS, f"-fmad={'true' if fmad else 'false'}"]
    src = _SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = _BUILD_ROOT / key
    lib = out_dir / "libblend.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libblend.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


_LOAD_LOCK = threading.Lock()


@functools.cache
def _load(fmad: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(fmad)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lvdgs_blend_fwd.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.lvdgs_blend_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    lib.lvdgs_median_depth.argtypes = [p, p, p, p, i, i, i, p]
    for fn in (lib.lvdgs_blend_fwd, lib.lvdgs_blend_bwd, lib.lvdgs_median_depth):
        fn.restype = ctypes.c_int
    return lib


def _library(fmad: bool = False) -> ctypes.CDLL:
    """The kernel library, built and loaded once (the dataset's prefetch
    thread may ask for it at the same time as the main thread)."""
    with _LOAD_LOCK:
        return _load(fmad)


def load_kernels() -> float:
    """Build (if needed) and load the kernel library; returns seconds."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _check_inputs(tp: torch.Tensor, counts: torch.Tensor, *others: torch.Tensor) -> None:
    if tp.dim() != 3 or tp.shape[2] != NF or tp.dtype != torch.float32:
        raise ValueError(f"tp must be (K, T, {NF}) float32, got {tuple(tp.shape)} {tp.dtype}")
    K, T, _ = tp.shape
    if counts.shape != (T,) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be ({T},) int32, got {tuple(counts.shape)} {counts.dtype}")
    if K > MAX_K:
        raise ValueError(f"at most {MAX_K} slots per tile, got {K}")
    for x in (tp, counts, *others):
        if x.device != tp.device:
            raise ValueError("all inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")
        if x.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {x.device}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU tensors only)


def _pixel_coords(T: int, ntx: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    tids = torch.arange(T, device=device)
    lin = torch.arange(P, device=device)
    px = ((tids % ntx) * TILE)[:, None].to(torch.float32) + (lin % TILE)[None].to(torch.float32)
    py = ((tids // ntx) * TILE)[:, None].to(torch.float32) + (lin // TILE)[None].to(torch.float32)
    return px, py


def _alpha_at(p: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Alpha of one slot (p: (T, NF)) on the (T, P) pixel grid."""
    dx = px - p[:, 0:1]
    dy = py - p[:, 1:2]
    power = -0.5 * (p[:, 2:3] * dx * dx + p[:, 4:5] * dy * dy) - p[:, 3:4] * dx * dy
    G = torch.exp(power)
    raw = p[:, 9:10] * G
    ok = (power <= 0.0) & (raw >= ALPHA_MIN)
    alpha = torch.where(ok, torch.clamp(raw, max=ALPHA_MAX), torch.zeros_like(raw))
    return alpha, G, dx, dy, raw


def blend_forward_plain(tp: torch.Tensor, counts: torch.Tensor, ntx: int):
    K, T, _ = tp.shape
    px, py = _pixel_coords(T, ntx, tp.device)
    trans = torch.ones((T, P), dtype=torch.float32, device=tp.device)
    acc = torch.zeros((T, 4, P), dtype=torch.float32, device=tp.device)
    nt = torch.zeros((T, K), dtype=torch.int32, device=tp.device)
    alive = torch.ones((T,), dtype=torch.bool, device=tp.device)
    for k in range(K):
        alive = alive & (k < counts) & (trans > T_EPS).any(dim=1)
        if not bool(alive.any()):
            break
        p = tp[k]
        alpha, _G, _dx, _dy, _raw = _alpha_at(p, px, py)
        alpha = torch.where(alive[:, None], alpha, torch.zeros_like(alpha))
        w = torch.where(trans > T_EPS, alpha * trans, torch.zeros_like(alpha))
        acc = acc + w[:, None, :] * p[:, 5:9, None]
        nt[:, k] = (w > 0.0).sum(dim=1).to(torch.int32)
        trans = trans * (1.0 - alpha)
    return acc, trans, nt


def blend_backward_plain(tp, counts, acc, trans_final, dacc, dtrans, ntx: int):
    K, T, _ = tp.shape
    px, py = _pixel_coords(T, ntx, tp.device)
    dtp = torch.zeros((K, T, NF), dtype=torch.float32, device=tp.device)
    trans = torch.ones((T, P), dtype=torch.float32, device=tp.device)
    prefix = torch.zeros((T, 4, P), dtype=torch.float32, device=tp.device)
    alive = torch.ones((T,), dtype=torch.bool, device=tp.device)
    zero = torch.zeros((), dtype=torch.float32, device=tp.device)
    for k in range(K):
        alive = alive & (k < counts) & (trans > T_EPS).any(dim=1)
        if not bool(alive.any()):
            break
        p = tp[k]
        alpha, G, dx, dy, raw = _alpha_at(p, px, py)
        alpha = torch.where(alive[:, None], alpha, zero)
        contributes = trans > T_EPS
        w = torch.where(contributes, alpha * trans, zero)
        col = p[:, 5:9, None]  # (T, 4, 1)
        prefix = prefix + w[:, None, :] * col
        one_m = 1.0 - alpha
        suffix = acc - prefix
        # dL/dalpha = <g_acc, T_k c_k - S_k/(1-alpha_k)> - g_T * T_N/(1-alpha_k)
        term = torch.where(
            contributes[:, None, :], trans[:, None, :] * col - suffix / one_m[:, None, :], zero
        )
        galpha = (dacc * term).sum(dim=1) - dtrans * trans_final / one_m
        galpha = torch.where(alpha > 0.0, galpha, zero)
        unclamped = raw < ALPHA_MAX
        d_op_px = torch.where(unclamped, galpha * G, zero)
        d_pow = torch.where(unclamped, galpha * alpha, zero)
        ca, cb, cc = p[:, 2:3], p[:, 3:4], p[:, 4:5]
        dtp[k, :, 0] = (d_pow * (ca * dx + cb * dy)).sum(dim=1)
        dtp[k, :, 1] = (d_pow * (cc * dy + cb * dx)).sum(dim=1)
        dtp[k, :, 2] = (d_pow * (-0.5 * dx * dx)).sum(dim=1)
        dtp[k, :, 3] = (d_pow * (-dx * dy)).sum(dim=1)
        dtp[k, :, 4] = (d_pow * (-0.5 * dy * dy)).sum(dim=1)
        dtp[k, :, 5:9] = (dacc * w[:, None, :]).sum(dim=2)
        dtp[k, :, 9] = d_op_px.sum(dim=1)
        trans = trans * one_m
    return dtp


def median_depth_plain(tp: torch.Tensor, counts: torch.Tensor, ntx: int):
    K, T, _ = tp.shape
    px, py = _pixel_coords(T, ntx, tp.device)
    trans = torch.ones((T, P), dtype=torch.float32, device=tp.device)
    dmed = torch.zeros((T, P), dtype=torch.float32, device=tp.device)
    alive = torch.ones((T,), dtype=torch.bool, device=tp.device)
    for k in range(K):
        alive = alive & (k < counts) & (trans > 0.5).any(dim=1)
        if not bool(alive.any()):
            break
        p = tp[k]
        alpha, _G, _dx, _dy, _raw = _alpha_at(p, px, py)
        alpha = torch.where(alive[:, None], alpha, torch.zeros_like(alpha))
        t_new = trans * (1.0 - alpha)
        # exactly one slot per pixel takes accumulated opacity past 0.5
        crossed = (trans > 0.5) & (t_new <= 0.5)
        dmed = torch.where(crossed, p[:, 8:9].expand_as(dmed), dmed)
        trans = t_new
    return dmed, 1.0 - trans


# ---------------------------------------------------------------------------
# wrappers


def blend_forward(tp: torch.Tensor, counts: torch.Tensor, ntx: int):
    """Front-to-back blend. Returns (acc (T, 4, P), trans (T, P),
    n_touched per slot (T, K) int32)."""
    _check_inputs(tp, counts)
    if tp.device.type == "cpu":
        return blend_forward_plain(tp, counts, ntx)
    K, T, _ = tp.shape
    acc = torch.empty((T, 4, P), dtype=torch.float32, device=tp.device)
    trans = torch.empty((T, P), dtype=torch.float32, device=tp.device)
    nt = torch.empty((T, K), dtype=torch.int32, device=tp.device)
    if T == 0:
        return acc, trans, nt
    err = _library().lvdgs_blend_fwd(
        tp.data_ptr(), counts.data_ptr(), acc.data_ptr(), trans.data_ptr(), nt.data_ptr(),
        K, T, ntx, _stream(),
    )
    _check_launch(err, "blend_forward")
    blend_forward.launches.add()
    return acc, trans, nt


def blend_backward(tp, counts, acc, trans, dacc, dtrans, ntx: int):
    """VJP of blend_forward w.r.t. tp -> dtp (K, T, NF)."""
    _check_inputs(tp, counts, acc, trans, dacc, dtrans)
    if tp.device.type == "cpu":
        return blend_backward_plain(tp, counts, acc, trans, dacc, dtrans, ntx)
    K, T, _ = tp.shape
    dtp = torch.empty((K, T, NF), dtype=torch.float32, device=tp.device)
    if T == 0:
        return dtp
    err = _library().lvdgs_blend_bwd(
        tp.data_ptr(), counts.data_ptr(), acc.data_ptr(), trans.data_ptr(),
        dacc.data_ptr(), dtrans.data_ptr(), dtp.data_ptr(), K, T, ntx, _stream(),
    )
    _check_launch(err, "blend_backward")
    blend_backward.launches.add()
    return dtp


def median_depth(tp: torch.Tensor, counts: torch.Tensor, ntx: int):
    """Transmittance-median depth -> (dmed (T, P), opacity at the stop
    (T, P)). dmed is 0 where opacity never reaches 0.5; the opacity is exact
    there and >= 0.5 elsewhere."""
    _check_inputs(tp, counts)
    if tp.device.type == "cpu":
        return median_depth_plain(tp, counts, ntx)
    K, T, _ = tp.shape
    dmed = torch.empty((T, P), dtype=torch.float32, device=tp.device)
    opac = torch.empty((T, P), dtype=torch.float32, device=tp.device)
    if T == 0:
        return dmed, opac
    err = _library().lvdgs_median_depth(
        tp.data_ptr(), counts.data_ptr(), dmed.data_ptr(), opac.data_ptr(), K, T, ntx, _stream(),
    )
    _check_launch(err, "median_depth")
    median_depth.launches.add()
    return dmed, opac


blend_forward.launches = LaunchCounter()
blend_backward.launches = LaunchCounter()
median_depth.launches = LaunchCounter()

KERNEL_WRAPPERS = (blend_forward, blend_backward, median_depth)


class BlendFunction(torch.autograd.Function):
    """blend_forward with blend_backward as its VJP (no gradient to counts
    or to the per-slot touch counts)."""

    @staticmethod
    def forward(ctx, tp, counts, ntx):
        acc, trans, nt = blend_forward(tp, counts, ntx)
        ctx.save_for_backward(tp, counts, acc, trans)
        ctx.ntx = ntx
        ctx.mark_non_differentiable(nt)
        return acc, trans, nt

    @staticmethod
    def backward(ctx, dacc, dtrans, _dnt):
        tp, counts, acc, trans = ctx.saved_tensors
        dacc = torch.zeros_like(acc) if dacc is None else dacc.contiguous()
        dtrans = torch.zeros_like(trans) if dtrans is None else dtrans.contiguous()
        dtp = blend_backward(tp, counts, acc, trans, dacc, dtrans, ctx.ntx)
        return dtp, None, None


def blend(tp: torch.Tensor, counts: torch.Tensor, ntx: int):
    """Differentiable (w.r.t. tp) front-to-back blend."""
    return BlendFunction.apply(tp, counts, ntx)
