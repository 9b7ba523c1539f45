"""Kernel timing on the card with CUDA events, the card's peaks for the
least time a kernel could take, and the card's name and power limit that
every kept number stands beside."""
from __future__ import annotations

import subprocess

import torch

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit): HBM3
# bandwidth and FP32 (non-tensor) operations; bf16 outside the tensor cores
# runs two values per lane, twice the FP32 rate (H100 architecture
# whitepaper)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_VECTOR_OPS_PER_S = 2 * FP32_OPS_PER_S


def bound_ms(bytes_moved: float, ops: float, bf16_ops: float = 0.0) -> tuple[float, str]:
    """(least time in ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over their peak rates (`ops` FP32,
    `bf16_ops` bf16 outside the tensor cores)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / FP32_OPS_PER_S + bf16_ops / BF16_VECTOR_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 10, warmup: int = 2, inner: int = 1) -> float:
    """Median over `reps` CUDA-event timings, after warm-up, of `inner`
    back-to-back calls of fn(), per call (several calls per event pair keep
    the events' own overhead out of a short kernel's time)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, reps: int = 10, inner: int = 20) -> float:
    """Median over `reps` CUDA-event timings of one replay of a CUDA graph
    that holds `inner` back-to-back calls of fn(), per call: the device's
    time for the calls' launches without the host's time to make them,
    which a kernel of a few microseconds launched from Python through
    ctypes does not cover (time_ms then measures the host). fn must only
    launch work on the current stream: no allocation, no sync."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]
