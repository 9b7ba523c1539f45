"""The traced run's device trace: `torch.profiler` with CUDA activity only
(the kernels, copies and sets of every stream of the process, through
CUPTI), kept in memory and read once it stops. Nothing is written to
disk.

The trace's clock is tied to the host's by a marker kernel launched right
after the profiler starts, at a host time taken just before it. Every
interval is in host seconds (`time.perf_counter`) from then on."""
from __future__ import annotations

import time

MARKER = "spin_kernel"


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t_start = self.t_stop = None
        self._marker_host = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA], record_shapes=False,
                            with_stack=False, profile_memory=False)
        self.prof.start()
        torch.cuda.synchronize(self.device)
        self._marker_host = time.perf_counter()
        torch.cuda._sleep(1000)  # the clock marker: a kernel of its own name
        torch.cuda.synchronize(self.device)
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize(self.device)
        self.t_stop = time.perf_counter()
        self.prof.stop()

    def events(self) -> list:
        """[(name, start, end)] of every device activity, host seconds,
        sorted by start, the clock marker left out."""
        from torch.autograd import DeviceType

        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            raw.append((e.name(), start, start + dur))
        markers = sorted((r for r in raw if MARKER in r[0]), key=lambda r: r[1])
        if not markers:
            raise RuntimeError("the clock marker kernel is not in the device trace")
        # the clock marker started a launch latency after the host's time: a
        # few microseconds, small against the gaps and spans read here
        offset = self._marker_host - markers[0][1] * 1e-9
        out = [(n, s * 1e-9 + offset, e * 1e-9 + offset) for n, s, e in raw if MARKER not in n]
        out.sort(key=lambda r: r[1])
        return out


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """[(start, end)] of the stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps
