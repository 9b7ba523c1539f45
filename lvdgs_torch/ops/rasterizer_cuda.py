"""Hand-written CUDA kernels of the tile blend, their plain PyTorch
versions, and the autograd Functions that join forward and backward.

Seven kernels, each replacing one Pallas TPU kernel (or one variant) of
``lvdgs_tpu/ops/rasterizer_pallas.py``. In ``lvdgs_torch/csrc/blend.cu``:

- ``blend_forward``  <- ``_make_fwd_kernel`` (front-to-back blend),
- ``blend_backward`` <- ``_make_bwd_kernel`` (its VJP),
- ``median_depth``   <- ``_make_median_kernel`` (transmittance-median depth);

in ``lvdgs_torch/csrc/blend_packed.cu``:

- ``packed_blend_forward``  <- ``_make_packed_fwd_kernel`` (the blend over
  group-CSR chunk lists; with ``probe_wmax`` the saturation-feedback probe),
- ``packed_blend_backward`` <- ``_make_packed_bwd_kernel`` (its VJP),
- ``packed_blend_forward_bf16``, ``packed_blend_backward_bf16`` <- the same
  two with ``bf16=True``: each slot's weight math in bfloat16, rounded at
  the points of the Pallas expression (``_alpha_at_bf16``), the rest in
  float32.

The resident-table probe's two kernels (``lvdgs_torch/csrc/resident.cu``)
are built here with the others; their wrappers are in ``resident_cuda``.

Layouts are those of the Pallas kernels: dense tile params ``tp`` are
(K, T, 10) float32 with fields [mean_x, mean_y, conic_a, conic_b, conic_c,
r, g, b, depth, opacity], front slot first; ``counts`` (T,) int32 holds the
valid prefix length of each tile's slot list; pixels are the 256 pixels of a
16x16 tile, row-major. Packed params are (NB, KC, TG, 10): chunk b holds
slots [k0[b], k0[b] + KC) of the TG tiles of group cg[b] (see
``packed_blend_forward``).

Each wrapper launches its kernel for CUDA tensors and uses the plain
version only for CPU tensors; any other device raises. There is no
fallback from a CUDA tensor to the plain version.

Stop rule, shared by every kernel and its plain version: a tile marches its
slots in order and stops before slot k once k reaches its count (packed:
its group's last chunk) or no pixel of the tile has transmittance above the
threshold (T_EPS for the blend, 0.5 for the median). The Pallas kernels
test the same condition per group of ``tile_group`` tiles and every 4 slots
(packed: per group and chunk of KC slots), so after a pixel saturates they
may multiply its transmittance by a few more slots than this rule does.
Contributions are identical (a pixel at T <= T_EPS contributes nothing);
the final transmittance of saturated pixels and the backward's
``-g_T * T_final / (1 - alpha)`` term through them differ by T_EPS-sized
amounts. The blend forwards (dense and packed) also return each tile's
march length (the slots it marched under this rule); the backward kernels
march that many slots instead of testing the rule again, and their plain
versions test the rule themselves and refuse a march length that differs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
import time
import types
from pathlib import Path

import torch

NF = 10
TILE = 16
P = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1.0e-4
KC = 32  # slots per chunk of the packed layout

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
# one shared library per source, built by one nvcc each, all at once
_SOURCES = ("blend", "blend_packed", "resident")
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class LaunchCounter:
    """Number of kernel launches made by one wrapper, in all and per launch
    shape where the wrapper names one (the packed kernels: (NB, G)).
    Thread-safe: the dataset's prefetch thread renders through the same
    kernels."""

    def __init__(self) -> None:
        self._n = 0
        self._shapes: dict = {}
        self._lock = threading.Lock()

    def add(self, shape=None) -> None:
        with self._lock:
            self._n += 1
            if shape is not None:
                self._shapes[shape] = self._shapes.get(shape, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._shapes = {}

    @property
    def count(self) -> int:
        return self._n

    @property
    def by_shape(self) -> dict:
        with self._lock:
            return dict(self._shapes)


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


def build_libraries(fmad: bool = False) -> dict:
    """Compile each source of ``lvdgs_torch/csrc`` into its own plain-C
    shared library under ``lvdgs_torch/_build/<hash of the sources and
    flags>/`` unless it is there already; the nvcc processes run at the same
    time. Returns {source name: library path}.

    The kernels are built with ``-fmad=false``: no multiply-add
    contraction, so they round every operation as the plain PyTorch
    versions do (one kernel per op). Their alpha and stop-rule gates are
    hard thresholds, where one rounding step can switch a whole slot's term
    on or off; with the same rounding, the forward kernels and the median
    reproduce the plain versions bit for bit. ``fmad=True`` builds with
    nvcc's default contraction; chip_smoke.py times that build against this
    one. nvcc's ``-Xptxas -v`` report (registers, spills, shared memory per
    kernel) is kept beside each library as ``lib<name>.ptxas.txt``."""
    flags = [*_NVCC_FLAGS, f"-fmad={'true' if fmad else 'false'}"]
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(f for f in _CSRC.iterdir() if f.suffix in (".cu", ".cuh")):
        h.update(f.name.encode() + f.read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    libs = {name: out_dir / f"lib{name}.so" for name in _SOURCES}
    todo = [name for name, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, tmp, proc in procs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu ({proc.returncode}):\n{err}")
        else:
            (out_dir / f"lib{name}.ptxas.txt").write_text(err)
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


_LOAD_LOCK = threading.Lock()


@functools.cache
def _load(fmad: bool) -> types.SimpleNamespace:
    libs = {name: ctypes.CDLL(str(path)) for name, path in build_libraries(fmad).items()}
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = {
        ("blend", "lvdgs_blend_fwd"): [p, p, p, p, p, p, i, i, i, p],
        ("blend", "lvdgs_blend_bwd"): [p, p, p, p, p, p, p, p, i, i, i, p],
        ("blend", "lvdgs_median_depth"): [p, p, p, p, i, i, i, p],
        ("blend_packed", "lvdgs_packed_fwd"): [p, p, p, p, p, p, p, p, i, i, i, i, i, p],
        ("blend_packed", "lvdgs_packed_bwd"): [p, p, p, p, p, p, p, p, p, p, i, i, i, i, p],
        ("blend_packed", "lvdgs_packed_fwd_bf16"): [p, p, p, p, p, p, p, p, i, i, i, i, i, p],
        ("blend_packed", "lvdgs_packed_bwd_bf16"): [p, p, p, p, p, p, p, p, p, p, i, i, i, i, p],
        ("resident", "lvdgs_resident_gather"): [p, p, p, i, i, i, i, p],
        ("resident", "lvdgs_resident_scatter"): [p, p, p, i, i, i, i, p],
        ("resident", "lvdgs_resident_scatter_add"): [p, p, p, i, i, i, i, p],
        ("blend", "lvdgs_blend_attrs"): [i, p, p],
        ("blend_packed", "lvdgs_packed_attrs"): [i, p, p],
        ("resident", "lvdgs_resident_attrs"): [i, p, p],
    }
    fns = {}
    for (lib, name), types_ in argtypes.items():
        fn = getattr(libs[lib], name)
        fn.argtypes = types_
        fn.restype = ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(libraries=libs, **fns)


def _library(fmad: bool = False) -> types.SimpleNamespace:
    """The kernel libraries' C functions, built and loaded once (the
    dataset's prefetch thread may ask for them at the same time as the main
    thread)."""
    with _LOAD_LOCK:
        return _load(fmad)


def load_kernels() -> float:
    """Build (if needed) and load the kernel libraries; returns seconds."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


def library_attrs(attrs_fn) -> dict:
    """{kernel: {registers, local_bytes, static_smem, blocks_per_sm,
    threads}} of every kernel that one library's attrs function lists
    (csrc/kernel_attrs.cuh): cudaFuncGetAttributes (registers per thread,
    local memory per thread: spills and local arrays, static shared memory
    per block) and cudaOccupancyMaxActiveBlocksPerMultiprocessor at the
    kernel's launch block size. `attrs_fn` is the ctypes function with
    argtypes (int, void*, void*)."""
    res = {}
    for k in itertools.count():
        name, out = ctypes.c_char_p(), (ctypes.c_int * 5)()
        err = attrs_fn(k, ctypes.byref(name), out)
        if err == -1:
            return res
        _check_launch(err, "kernel attrs")
        res[name.value.decode()] = dict(zip(
            ("registers", "local_bytes", "static_smem", "blocks_per_sm", "threads"), out))


def kernel_attrs() -> dict:
    """library_attrs of every kernel of the shipped build."""
    lib = _library()
    return {**library_attrs(lib.lvdgs_blend_attrs), **library_attrs(lib.lvdgs_packed_attrs),
            **library_attrs(lib.lvdgs_resident_attrs)}


def ptxas_log(name: str = "blend_packed") -> str:
    """nvcc's -Xptxas -v report of the shipped build of csrc/<name>.cu."""
    return build_libraries()[name].with_name(f"lib{name}.ptxas.txt").read_text()


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _check_inputs(tp: torch.Tensor, counts: torch.Tensor, *others: torch.Tensor) -> None:
    if tp.dim() != 3 or tp.shape[2] != NF or tp.dtype != torch.float32:
        raise ValueError(f"tp must be (K, T, {NF}) float32, got {tuple(tp.shape)} {tp.dtype}")
    K, T, _ = tp.shape
    if counts.shape != (T,) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be ({T},) int32, got {tuple(counts.shape)} {counts.dtype}")
    for x in (tp, counts, *others):
        if x.device != tp.device:
            raise ValueError("all inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")
        if x.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {x.device}")


def _check_packed_inputs(tp, cg, k0, goff, tids, n_groups: int, *others) -> None:
    if tp.dim() != 4 or tp.shape[1] != KC or tp.shape[3] != NF or tp.dtype != torch.float32:
        raise ValueError(f"tp must be (NB, {KC}, TG, {NF}) float32, got {tuple(tp.shape)} {tp.dtype}")
    NB, _, TG, _ = tp.shape
    for name, x, shape in (("cg", cg, (NB,)), ("k0", k0, (NB,)), ("goff", goff, (1,)),
                           ("tids", tids, (NB, TG))):
        if x.shape != shape or x.dtype != torch.int32:
            raise ValueError(f"{name} must be {shape} int32, got {tuple(x.shape)} {x.dtype}")
    if not 1 <= n_groups <= NB:
        raise ValueError(f"n_groups {n_groups} out of range for {NB} chunks")
    for x in (tp, cg, k0, goff, tids, *others):
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


def _pixel_coords(T: int, ntx: int, device, tids=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, P) pixel coordinates of tiles 0..T-1, or of the tile ids `tids`."""
    tids = torch.arange(T, device=device) if tids is None else tids.reshape(-1)
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


def _alpha_at_bf16(p: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """_alpha_at with the weight math in bfloat16, as the Pallas packed
    kernels' bf16 variant: coordinates relative to each tile's origin
    (px[:, :1], py[:, :1], the tile's first pixel), every operation a
    bfloat16 one, exp on the rounded power; raw is widened to float32 and
    the ok test compares the widened power. Returns float32 (alpha, G, dx,
    dy, raw), G, dx and dy the widened bf16 values the backward uses."""
    bt = torch.bfloat16
    ox, oy = px[:, :1], py[:, :1]
    dx = (px - ox).to(bt) - (p[:, 0:1] - ox).to(bt)  # local coordinates < 16: bf16-exact
    dy = (py - oy).to(bt) - (p[:, 1:2] - oy).to(bt)
    ca, cb, cc = p[:, 2:3].to(bt), p[:, 3:4].to(bt), p[:, 4:5].to(bt)
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    G = torch.exp(power)
    raw = (p[:, 9:10].to(bt) * G).float()
    ok = (power.float() <= 0.0) & (raw >= ALPHA_MIN)
    alpha = torch.where(ok, torch.clamp(raw, max=ALPHA_MAX), torch.zeros_like(raw))
    return alpha, G.float(), dx.float(), dy.float(), raw


def _slot_forward(p, px, py, alive, trans, acc, bf16: bool = False):
    """One marched slot of the forward, for the tiles of the rows of p
    (those not `alive` take alpha 0). Returns (blend weights (T, P),
    trans', acc')."""
    alpha = (_alpha_at_bf16 if bf16 else _alpha_at)(p, px, py)[0]
    alpha = torch.where(alive[:, None], alpha, torch.zeros_like(alpha))
    w = torch.where(trans > T_EPS, alpha * trans, torch.zeros_like(alpha))
    acc = acc + w[:, None, :] * p[:, 5:9, None]
    return w, trans * (1.0 - alpha), acc


def _slot_backward(p, px, py, alive, trans, prefix, acc, trans_final, dacc, dtrans,
                   bf16: bool = False):
    """One marched slot of the backward (with `bf16`, the bf16 weights
    replayed and everything after them in float32, with the float32 conic).
    Returns (d params (T, NF), trans', prefix')."""
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    alpha, G, dx, dy, raw = (_alpha_at_bf16 if bf16 else _alpha_at)(p, px, py)
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
    d = torch.empty((p.shape[0], NF), dtype=torch.float32, device=p.device)
    d[:, 0] = (d_pow * (ca * dx + cb * dy)).sum(dim=1)
    d[:, 1] = (d_pow * (cc * dy + cb * dx)).sum(dim=1)
    d[:, 2] = (d_pow * (-0.5 * dx * dx)).sum(dim=1)
    d[:, 3] = (d_pow * (-dx * dy)).sum(dim=1)
    d[:, 4] = (d_pow * (-0.5 * dy * dy)).sum(dim=1)
    d[:, 5:9] = (dacc * w[:, None, :]).sum(dim=2)
    d[:, 9] = d_op_px.sum(dim=1)
    return d, trans * one_m, prefix


def blend_forward_plain(tp: torch.Tensor, counts: torch.Tensor, ntx: int):
    K, T, _ = tp.shape
    px, py = _pixel_coords(T, ntx, tp.device)
    trans = torch.ones((T, P), dtype=torch.float32, device=tp.device)
    acc = torch.zeros((T, 4, P), dtype=torch.float32, device=tp.device)
    nt = torch.zeros((T, K), dtype=torch.int32, device=tp.device)
    march = torch.zeros((T,), dtype=torch.int32, device=tp.device)
    alive = torch.ones((T,), dtype=torch.bool, device=tp.device)
    for k in range(K):
        alive = alive & (k < counts) & (trans > T_EPS).any(dim=1)
        if not bool(alive.any()):
            break
        march += alive.to(torch.int32)
        w, trans, acc = _slot_forward(tp[k], px, py, alive, trans, acc)
        nt[:, k] = (w > 0.0).sum(dim=1).to(torch.int32)
    return acc, trans, nt, march


def blend_backward_plain(tp, counts, acc, trans_final, dacc, dtrans, ntx: int, march=None):
    """Marches by the stop rule itself; a given `march` (the forward's march
    lengths, which the kernel marches instead) must equal what it marched,
    else ValueError."""
    K, T, _ = tp.shape
    px, py = _pixel_coords(T, ntx, tp.device)
    dtp = torch.zeros((K, T, NF), dtype=torch.float32, device=tp.device)
    trans = torch.ones((T, P), dtype=torch.float32, device=tp.device)
    prefix = torch.zeros((T, 4, P), dtype=torch.float32, device=tp.device)
    marched = torch.zeros((T,), dtype=torch.int32, device=tp.device)
    alive = torch.ones((T,), dtype=torch.bool, device=tp.device)
    for k in range(K):
        alive = alive & (k < counts) & (trans > T_EPS).any(dim=1)
        if not bool(alive.any()):
            break
        marched += alive.to(torch.int32)
        dtp[k], trans, prefix = _slot_backward(tp[k], px, py, alive, trans, prefix, acc,
                                               trans_final, dacc, dtrans)
    if march is not None and not torch.equal(march, marched):
        raise ValueError("march is not the march lengths of the forward on these inputs")
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


def _group_chunks(cg: torch.Tensor, n_groups: int):
    """Per group g < n_groups: (first chunk, number of chunks) in the sorted
    chunk-group map cg (padding chunks carry cg = n_groups)."""
    g = torch.arange(n_groups + 1, dtype=cg.dtype, device=cg.device)
    bounds = torch.searchsorted(cg, g)
    return bounds[:-1], bounds[1:] - bounds[:-1]


def _packed_tiles(tp, cg, goff, tids, n_groups: int, ntx: int):
    """The (group, lane) tiles of a packed block, one row per tile in group
    order: (first chunk (G,), chunks (G,), pixel coordinates px, py
    (G*TG, P)). A group's tile ids are those of its first chunk."""
    NB, _, TG, _ = tp.shape
    start, nch = _group_chunks(cg, n_groups)
    tid = tids[start.clamp(max=NB - 1).long()] + goff.reshape(())  # (G, TG)
    px, py = _pixel_coords(n_groups * TG, ntx, tp.device, tids=tid)
    return start, nch, px, py


def _packed_slots(tp, start, nch, trans_of):
    """Slot positions of a packed march in order, for all tiles at once:
    yields (alive (G*TG,), chunk of each group (G,), `has` (G,): whether the
    group has that chunk, slot index kc). A tile stops before the slot at
    which its group has no chunk left or no pixel of it has transmittance
    above T_EPS (`trans_of()` reads the march's current (G*TG, P)
    transmittance); the march ends when every tile has stopped."""
    NB, _, TG, _ = tp.shape
    G = start.shape[0]
    alive = (nch > 0).repeat_interleave(TG)
    for c in range(int(nch.max()) if G else 0):
        has = c < nch
        b = (start + c).clamp(max=NB - 1).long()
        for kc in range(KC):
            alive = alive & has.repeat_interleave(TG) & (trans_of() > T_EPS).any(dim=1)
            if not bool(alive.any()):
                return
            yield alive, b, has, kc


def _to_group_major(x: torch.Tensor, G: int, TG: int, fill: float) -> torch.Tensor:
    """(G*TG, C, P) or (G*TG, P) tile rows -> (G+1, C, TG, P) or (G+1, TG, P),
    with row G (no tile) filled with `fill`."""
    x = x.reshape(G, TG, *x.shape[1:])
    if x.dim() == 4:
        x = x.transpose(1, 2)
    return torch.cat([x, torch.full((1, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)])


def _from_group_major(x: torch.Tensor, G: int) -> torch.Tensor:
    """Inverse of _to_group_major (row G dropped)."""
    x = x[:G]
    if x.dim() == 4:
        x = x.transpose(1, 2)
    return x.reshape(G * x.shape[1], *x.shape[2:])


def packed_blend_forward_plain(tp, cg, k0, goff, tids, n_groups: int, ntx: int,
                               with_nt: bool = True, probe_wmax: bool = False, bf16: bool = False):
    if bf16 and probe_wmax:
        raise ValueError("the saturation probe has no bf16 form")
    NB, _, TG, _ = tp.shape
    G = n_groups
    dev = tp.device
    start, nch, px, py = _packed_tiles(tp, cg, goff, tids, G, ntx)
    state = {"trans": torch.ones((G * TG, P), dtype=torch.float32, device=dev)}
    acc = torch.zeros((G * TG, 4, P), dtype=torch.float32, device=dev)
    nt = torch.zeros((NB, KC, TG), dtype=torch.int32, device=dev)
    march = torch.zeros((G + 1) * TG, dtype=torch.int32, device=dev)
    for alive, b, has, kc in _packed_slots(tp, start, nch, lambda: state["trans"]):
        march[:G * TG] += alive.to(torch.int32)
        p = tp[b, kc].reshape(G * TG, NF)
        w, state["trans"], acc = _slot_forward(p, px, py, alive, state["trans"], acc, bf16)
        if probe_wmax:
            val = torch.ceil(w.max(dim=1).values * 65536.0).to(torch.int32)
        elif with_nt:
            val = (w > 0.0).sum(dim=1).to(torch.int32)
        else:
            continue
        nt[b[has], kc] = val.reshape(G, TG)[has]
    return (_to_group_major(acc, G, TG, 0.0), _to_group_major(state["trans"], G, TG, 1.0), nt,
            march.reshape(G + 1, TG))


def packed_blend_backward_plain(tp, cg, k0, goff, tids, acc, trans_final, dacc, dtrans,
                                n_groups: int, ntx: int, bf16: bool = False, march=None):
    """Marches by the stop rule itself; a given `march` (the forward's march
    lengths, which the kernel marches instead) must equal what it marched,
    else ValueError."""
    NB, _, TG, _ = tp.shape
    G = n_groups
    dev = tp.device
    start, nch, px, py = _packed_tiles(tp, cg, goff, tids, G, ntx)
    acc, trans_final, dacc, dtrans = (_from_group_major(x, G) for x in (acc, trans_final, dacc, dtrans))
    state = {"trans": torch.ones((G * TG, P), dtype=torch.float32, device=dev)}
    prefix = torch.zeros((G * TG, 4, P), dtype=torch.float32, device=dev)
    dtp = torch.zeros((NB, KC, TG, NF), dtype=torch.float32, device=dev)
    marched = torch.zeros((G + 1) * TG, dtype=torch.int32, device=dev)
    for alive, b, has, kc in _packed_slots(tp, start, nch, lambda: state["trans"]):
        marched[:G * TG] += alive.to(torch.int32)
        p = tp[b, kc].reshape(G * TG, NF)
        d, state["trans"], prefix = _slot_backward(p, px, py, alive, state["trans"], prefix, acc,
                                                   trans_final, dacc, dtrans, bf16)
        dtp[b[has], kc] = d.reshape(G, TG, NF)[has]
    if march is not None and not torch.equal(march.reshape(-1), marched):
        raise ValueError("march is not the march lengths of the forward on these inputs")
    return dtp


# ---------------------------------------------------------------------------
# wrappers


def blend_forward(tp: torch.Tensor, counts: torch.Tensor, ntx: int):
    """Front-to-back blend. Returns (acc (T, 4, P), trans (T, P),
    n_touched per slot (T, K) int32, march (T,) int32). march is the number
    of slots each tile marched under the stop rule; blend_backward takes it
    and marches as many."""
    _check_inputs(tp, counts)
    if tp.device.type == "cpu":
        return blend_forward_plain(tp, counts, ntx)
    K, T, _ = tp.shape
    acc = torch.empty((T, 4, P), dtype=torch.float32, device=tp.device)
    trans = torch.empty((T, P), dtype=torch.float32, device=tp.device)
    nt = torch.empty((T, K), dtype=torch.int32, device=tp.device)
    march = torch.empty((T,), dtype=torch.int32, device=tp.device)
    if T == 0:
        return acc, trans, nt, march
    err = _library().lvdgs_blend_fwd(
        tp.data_ptr(), counts.data_ptr(), acc.data_ptr(), trans.data_ptr(), nt.data_ptr(),
        march.data_ptr(), K, T, ntx, _stream(),
    )
    _check_launch(err, "blend_forward")
    blend_forward.launches.add()
    return acc, trans, nt, march


def blend_backward(tp, counts, march, acc, trans, dacc, dtrans, ntx: int):
    """VJP of blend_forward w.r.t. tp -> dtp (K, T, NF), given the
    forward's march lengths, acc and trans; slots the march never reaches get
    zeros. `march` must be what blend_forward returned on these inputs: the
    kernel marches that many slots per tile (never past the count) and
    cannot check it; on the CPU the plain version checks it and raises
    ValueError where it differs."""
    _check_inputs(tp, counts, march, acc, trans, dacc, dtrans)
    K, T, _ = tp.shape
    for name, x, shape, dtype in (("march", march, (T,), torch.int32),
                                  ("acc", acc, (T, 4, P), torch.float32),
                                  ("dacc", dacc, (T, 4, P), torch.float32),
                                  ("trans", trans, (T, P), torch.float32),
                                  ("dtrans", dtrans, (T, P), torch.float32)):
        if x.shape != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(x.shape)} {x.dtype}")
    if tp.device.type == "cpu":
        return blend_backward_plain(tp, counts, acc, trans, dacc, dtrans, ntx, march=march)
    dtp = torch.empty((K, T, NF), dtype=torch.float32, device=tp.device)
    if T == 0:
        return dtp
    err = _library().lvdgs_blend_bwd(
        tp.data_ptr(), counts.data_ptr(), march.data_ptr(), acc.data_ptr(), trans.data_ptr(),
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


def _packed_forward(tp, cg, k0, goff, tids, n_groups: int, ntx: int, with_nt: bool,
                    probe_wmax: bool, bf16: bool):
    """B4 (`bf16`: B4-bf16) for CUDA tensors, its plain version for CPU ones."""
    _check_packed_inputs(tp, cg, k0, goff, tids, n_groups)
    if tp.device.type == "cpu":
        return packed_blend_forward_plain(tp, cg, k0, goff, tids, n_groups, ntx, with_nt,
                                          probe_wmax=probe_wmax, bf16=bf16)
    NB, _, TG, _ = tp.shape
    acc = torch.empty((n_groups + 1, 4, TG, P), dtype=torch.float32, device=tp.device)
    trans = torch.empty((n_groups + 1, TG, P), dtype=torch.float32, device=tp.device)
    nt = torch.empty((NB, KC, TG), dtype=torch.int32, device=tp.device)
    march = torch.empty((n_groups + 1, TG), dtype=torch.int32, device=tp.device)
    mode = 2 if probe_wmax else (1 if with_nt else 0)
    lib = _library()
    fn, wrapper = ((lib.lvdgs_packed_fwd_bf16, packed_blend_forward_bf16) if bf16
                   else (lib.lvdgs_packed_fwd, packed_blend_forward))
    err = fn(tp.data_ptr(), cg.data_ptr(), tids.data_ptr(), goff.data_ptr(), acc.data_ptr(),
             trans.data_ptr(), nt.data_ptr(), march.data_ptr(), NB, n_groups, TG, ntx, mode,
             _stream())
    _check_launch(err, wrapper.__name__)
    wrapper.launches.add((NB, n_groups))
    return acc, trans, nt, march


def packed_blend_forward(tp, cg, k0, goff, tids, n_groups: int, ntx: int,
                         with_nt: bool = True, probe_wmax: bool = False):
    """Front-to-back blend over packed (group-CSR) chunk lists.

    tp: (NB, KC, TG, NF) float32, chunk b holding slots [k0[b], k0[b] + KC)
    of the TG tiles of group cg[b], front slot first, sentinel rows
    (opacity 0) in empty slots. cg (NB,) int32 is sorted, a group's chunks
    are consecutive in slot order, and padding chunks carry cg = n_groups.
    tids (NB, TG) int32: the tile id of each (chunk, lane); goff (1,) int32
    shifts them (tile-sharded rendering). k0 is taken for the interface of
    the Pallas kernel; chunk order within a group already gives it.

    Returns (acc (G+1, 4, TG, P), trans (G+1, TG, P), nt (NB, KC, TG) int32,
    march (G+1, TG) int32) in group order, row G a filler (zeros, ones,
    zeros). nt holds per-slot touched pixel counts (`with_nt`), or with
    `probe_wmax` each slot's largest blend weight as ceil(w * 65536), or
    zeros. march is the number of slots each tile marched under the stop
    rule; packed_blend_backward takes it and marches as many."""
    return _packed_forward(tp, cg, k0, goff, tids, n_groups, ntx, with_nt, probe_wmax, False)


def packed_blend_forward_bf16(tp, cg, k0, goff, tids, n_groups: int, ntx: int,
                              with_nt: bool = True):
    """packed_blend_forward with each slot's weight math in bfloat16 (the
    reference's ``bf16=True``); no probe form."""
    return _packed_forward(tp, cg, k0, goff, tids, n_groups, ntx, with_nt, False, True)


def _packed_backward(tp, cg, k0, goff, tids, march, acc, trans, dacc, dtrans, n_groups: int,
                     ntx: int, bf16: bool):
    """B5 (`bf16`: B5-bf16) for CUDA tensors, its plain version for CPU ones
    (which applies the stop rule itself and refuses a `march` that differs
    from what it marched)."""
    _check_packed_inputs(tp, cg, k0, goff, tids, n_groups, march, acc, trans, dacc, dtrans)
    NB, _, TG, _ = tp.shape
    for name, x, shape, dtype in (
            ("march", march, (n_groups + 1, TG), torch.int32),
            ("acc", acc, (n_groups + 1, 4, TG, P), torch.float32),
            ("dacc", dacc, (n_groups + 1, 4, TG, P), torch.float32),
            ("trans", trans, (n_groups + 1, TG, P), torch.float32),
            ("dtrans", dtrans, (n_groups + 1, TG, P), torch.float32)):
        if x.shape != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(x.shape)} {x.dtype}")
    if tp.device.type == "cpu":
        return packed_blend_backward_plain(tp, cg, k0, goff, tids, acc, trans, dacc, dtrans,
                                           n_groups, ntx, bf16=bf16, march=march)
    dtp = torch.empty((NB, KC, TG, NF), dtype=torch.float32, device=tp.device)
    lib = _library()
    fn, wrapper = ((lib.lvdgs_packed_bwd_bf16, packed_blend_backward_bf16) if bf16
                   else (lib.lvdgs_packed_bwd, packed_blend_backward))
    err = fn(tp.data_ptr(), cg.data_ptr(), tids.data_ptr(), goff.data_ptr(), march.data_ptr(),
             acc.data_ptr(), trans.data_ptr(), dacc.data_ptr(), dtrans.data_ptr(), dtp.data_ptr(),
             NB, n_groups, TG, ntx, _stream())
    _check_launch(err, wrapper.__name__)
    wrapper.launches.add((NB, n_groups))
    return dtp


def packed_blend_backward(tp, cg, k0, goff, tids, march, acc, trans, dacc, dtrans, n_groups: int,
                          ntx: int):
    """VJP of packed_blend_forward w.r.t. tp -> dtp (NB, KC, TG, NF), given
    the forward's march lengths, acc and trans; slots the march never
    reaches (and padding chunks) get zeros. `march` must be what
    packed_blend_forward returned on these inputs: the kernel marches that
    many slots per tile and cannot check it (another forward's march gives
    wrong gradients); on the CPU the plain version checks it and raises
    ValueError where it differs."""
    return _packed_backward(tp, cg, k0, goff, tids, march, acc, trans, dacc, dtrans, n_groups, ntx,
                            False)


def packed_blend_backward_bf16(tp, cg, k0, goff, tids, march, acc, trans, dacc, dtrans,
                               n_groups: int, ntx: int):
    """VJP of packed_blend_forward_bf16: the bf16 weights replayed, the rest
    in float32. `march` as in packed_blend_backward, from the bf16 forward."""
    return _packed_backward(tp, cg, k0, goff, tids, march, acc, trans, dacc, dtrans, n_groups, ntx,
                            True)


blend_forward.launches = LaunchCounter()
blend_backward.launches = LaunchCounter()
median_depth.launches = LaunchCounter()
packed_blend_forward.launches = LaunchCounter()
packed_blend_backward.launches = LaunchCounter()
packed_blend_forward_bf16.launches = LaunchCounter()
packed_blend_backward_bf16.launches = LaunchCounter()

KERNEL_WRAPPERS = (blend_forward, blend_backward, median_depth, packed_blend_forward,
                   packed_blend_backward, packed_blend_forward_bf16, packed_blend_backward_bf16)


class BlendFunction(torch.autograd.Function):
    """blend_forward with blend_backward as its VJP (no gradient to counts
    or to the per-slot touch counts). The forward's march lengths are saved
    for the backward, which marches as many slots per tile."""

    @staticmethod
    def forward(ctx, tp, counts, ntx):
        acc, trans, nt, march = blend_forward(tp, counts, ntx)
        ctx.save_for_backward(tp, counts, march, acc, trans)
        ctx.ntx = ntx
        ctx.mark_non_differentiable(nt)
        return acc, trans, nt

    @staticmethod
    def backward(ctx, dacc, dtrans, _dnt):
        tp, counts, march, acc, trans = ctx.saved_tensors
        dacc = torch.zeros_like(acc) if dacc is None else dacc.contiguous()
        dtrans = torch.zeros_like(trans) if dtrans is None else dtrans.contiguous()
        dtp = blend_backward(tp, counts, march, acc, trans, dacc, dtrans, ctx.ntx)
        return dtp, None, None


def blend(tp: torch.Tensor, counts: torch.Tensor, ntx: int):
    """Differentiable (w.r.t. tp) front-to-back blend."""
    return BlendFunction.apply(tp, counts, ntx)


class PackedBlendFunction(torch.autograd.Function):
    """packed_blend_forward with packed_blend_backward as its VJP (with
    `bf16` their bf16 variants; no gradient to the chunk maps or to the
    per-slot counts). The forward's march lengths are saved for the
    backward, which marches as many slots per tile."""

    @staticmethod
    def forward(ctx, tp, cg, k0, goff, tids, n_groups, ntx, with_nt, bf16):
        acc, trans, nt, march = _packed_forward(tp, cg, k0, goff, tids, n_groups, ntx, with_nt,
                                                False, bf16)
        ctx.save_for_backward(tp, cg, k0, goff, tids, march, acc, trans)
        ctx.n_groups, ctx.ntx, ctx.bf16 = n_groups, ntx, bf16
        ctx.mark_non_differentiable(nt)
        return acc, trans, nt

    @staticmethod
    def backward(ctx, dacc, dtrans, _dnt):
        tp, cg, k0, goff, tids, march, acc, trans = ctx.saved_tensors
        dacc = torch.zeros_like(acc) if dacc is None else dacc.contiguous()
        dtrans = torch.zeros_like(trans) if dtrans is None else dtrans.contiguous()
        dtp = _packed_backward(tp, cg, k0, goff, tids, march, acc, trans, dacc, dtrans,
                               ctx.n_groups, ctx.ntx, ctx.bf16)
        return dtp, None, None, None, None, None, None, None, None


def blend_packed(tp, cg, k0, goff, tids, n_groups: int, ntx: int, with_nt: bool = True,
                 bf16: bool = False):
    """Differentiable (w.r.t. tp) blend over packed chunk lists; `bf16`
    runs each slot's weight math in bfloat16 (RenderConfig.blend_bf16)."""
    return PackedBlendFunction.apply(tp, cg, k0, goff, tids, n_groups, ntx, with_nt, bf16)
