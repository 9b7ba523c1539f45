"""The resident-table probe's two CUDA kernels, their plain PyTorch versions
and their launch counts.

Each replaces one Pallas TPU kernel of ``tools/perf_resident.py``, the probe
that holds the whole (rows, 16) field table in VMEM and does per-slot row
loads and accumulates inside the kernel. In ``lvdgs_torch/csrc/resident.cu``:

- ``resident_gather``  (R1) <- ``gather_kernel``: per (group, lane), the sum
  over k of ``fields[idx[g, k, tg]]``;
- ``resident_scatter`` (R2) <- ``scatter_kernel``: a zeroed table with
  ``out[idx[g, k, tg]] += upd[g, k, tg]`` for every slot.

``idx`` (G, K, TG) and ``upd`` (G, K, TG, 16) are the flat buffers the tool
passes: it reshapes (K, T) arrays to (G, K, TG) without transposing, so
slot (g, k, tg) is flat element (g * K + k) * TG + tg. Build with
``idx.reshape(G, K, TG)`` of the (K, T) array, as the tool does.

Each wrapper launches its kernel for CUDA tensors and uses the plain version
only for CPU tensors; any other device raises. Summation order: R1 and its
plain version add in k order from zero, as the Pallas kernel's loop does.
R2's plain version adds in flat slot order, as the Pallas grid does
(``index_add_`` on the CPU); the kernel adds with atomics, in another order
on every run, so it agrees with the plain version to rounding, not bit for
bit. The kernel reads ``upd`` and adds into the table 16 bytes at a time,
so ``resident_scatter`` refuses an ``upd`` that is not 16-byte aligned, on
every device.
"""
from __future__ import annotations

import torch

from .rasterizer_cuda import LaunchCounter, _check_launch, _library, _stream

NF = 16  # fields per row
MAX_TG = 1024 // NF  # lanes per group: one thread per (lane, field) in a block


def _check(idx: torch.Tensor, other: torch.Tensor, other_shape: tuple, name: str) -> None:
    if idx.dim() != 3 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be (G, K, TG) int32, got {tuple(idx.shape)} {idx.dtype}")
    if not 1 <= idx.shape[2] <= MAX_TG:
        raise ValueError(f"at most {MAX_TG} lanes per group, got {idx.shape[2]}")
    if other.dtype != torch.float32 or tuple(other.shape) != other_shape:
        raise ValueError(f"{name} must be {other_shape} float32, got {tuple(other.shape)} {other.dtype}")
    for x in (idx, other):
        if x.device != idx.device:
            raise ValueError("all inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")
        if x.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {x.device}")


def _check_rows(idx: torch.Tensor, rows: int) -> None:
    """Every index must name a row: on the card an index out of [0, rows)
    would read (R1) or write (R2) outside the table. One reduction and one
    host sync."""
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= rows:
            raise ValueError(f"indices must lie in [0, {rows}), got [{lo}, {hi}]")


# ---------------------------------------------------------------------------
# plain PyTorch versions


def resident_gather_plain(idx: torch.Tensor, fields: torch.Tensor) -> torch.Tensor:
    G, K, TG = idx.shape
    out = torch.zeros((G * TG, fields.shape[1]), dtype=torch.float32, device=fields.device)
    for k in range(K):
        out = out + fields[idx[:, k, :].reshape(-1).long()]
    return out


def resident_scatter_plain(idx: torch.Tensor, upd: torch.Tensor, rows: int) -> torch.Tensor:
    out = torch.zeros((rows, upd.shape[-1]), dtype=torch.float32, device=upd.device)
    return out.index_add_(0, idx.reshape(-1).long(), upd.reshape(-1, upd.shape[-1]))


# ---------------------------------------------------------------------------
# wrappers


def resident_gather(idx: torch.Tensor, fields: torch.Tensor, check_rows: bool = True) -> torch.Tensor:
    """R1: (G * TG, 16), row g * TG + tg the sum over k in order of
    fields[idx[g, k, tg]]. fields is (rows, 16) float32; an index outside
    [0, rows) raises. `check_rows=False` skips that check (a reduction and
    a host sync) for a caller that has made it on the same indices."""
    _check(idx, fields, (fields.shape[0], NF), "fields")
    if check_rows:
        _check_rows(idx, fields.shape[0])
    if idx.device.type == "cpu":
        return resident_gather_plain(idx, fields)
    G, K, TG = idx.shape
    out = torch.empty((G * TG, NF), dtype=torch.float32, device=idx.device)
    if G == 0:
        return out
    err = _library().lvdgs_resident_gather(idx.data_ptr(), fields.data_ptr(), out.data_ptr(), G, K,
                                           TG, fields.shape[0], _stream())
    _check_launch(err, "resident_gather")
    resident_gather.launches.add()
    return out


def resident_scatter(idx: torch.Tensor, upd: torch.Tensor, rows: int,
                     check_rows: bool = True) -> torch.Tensor:
    """R2: a (rows, 16) table of zeros with upd[g, k, tg] added to row
    idx[g, k, tg] for every slot. upd is (G, K, TG, 16) float32, 16-byte
    aligned; an index outside [0, rows) raises (`check_rows` as in
    resident_gather)."""
    _check(idx, upd, (*idx.shape, NF), "upd")
    if upd.data_ptr() % 16:
        raise ValueError("upd must be 16-byte aligned (the kernel loads 4 fields at a time)")
    if rows < 1:
        raise ValueError(f"rows must be positive, got {rows}")
    if check_rows:
        _check_rows(idx, rows)
    if idx.device.type == "cpu":
        return resident_scatter_plain(idx, upd, rows)
    G, K, TG = idx.shape
    out = torch.empty((rows, NF), dtype=torch.float32, device=idx.device)
    err = _library().lvdgs_resident_scatter(idx.data_ptr(), upd.data_ptr(), out.data_ptr(), G, K, TG,
                                            rows, _stream())
    _check_launch(err, "resident_scatter")
    resident_scatter.launches.add()
    return out


resident_gather.launches = LaunchCounter()
resident_scatter.launches = LaunchCounter()

KERNEL_WRAPPERS = (resident_gather, resident_scatter)
