"""Tagged console logging, and the program's span and counter recorder.

Same interface as the reference package's logger: rich when available,
plain prints otherwise. ``LVDGS_LOG=0`` silences it.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time
from typing import NamedTuple, Optional

_VERBOSE = os.environ.get("LVDGS_LOG", "1") != "0"

try:  # rich is optional
    from rich.console import Console

    _console = Console()

    def Log(*args, tag: str = "LVD-GS") -> None:
        if not _VERBOSE:
            return
        style_map = {
            "LVD-GS": "bold green",
            "GUI": "bold magenta",
            "Eval": "bold red",
            "Bench": "bold cyan",
        }
        style = style_map.get(tag, "bold blue")
        _console.print(f"[{style}]\\[{tag}][/{style}]", *args)

except ImportError:  # pragma: no cover

    def Log(*args, tag: str = "LVD-GS") -> None:
        if _VERBOSE:
            print(f"[{tag}]", *args, file=sys.stderr)


# the recorder's ring: the process's last RING_CAPACITY spans and counter
# events, oldest dropped first
RING_CAPACITY = 1 << 16


class Span(NamedTuple):
    """One closed span: `start` and `end` are time.perf_counter() seconds;
    `parent` is the id of the innermost span open on the same thread when
    it opened (None at the top)."""
    name: str
    start: float
    end: float
    id: int
    parent: Optional[int]
    seq: int
    frame: Optional[int]


class Count(NamedTuple):
    """One counter event, taken at `t` inside the span `span` (the innermost
    open on its thread, or None)."""
    name: str
    value: float
    t: float
    span: Optional[int]
    seq: int
    frame: Optional[int]


_ring: collections.deque = collections.deque(maxlen=RING_CAPACITY)
_ids = itertools.count(1)
# per thread: `stack`, the open spans [(name, id, parent, profiler range)],
# innermost last; `active`, the recorder that span() and sync() report to
_tls = threading.local()
# set while SLAM.run's profile_dir profiler runs: each span then also opens
# a torch.profiler.record_function range of its name
_annotate = False


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def _open_range(name: str):
    import torch

    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


def set_annotation(on: bool) -> None:
    """Spans open torch.profiler ranges of their names while `on` (SLAM.run
    sets it around its profile_dir profiler, and only there: under any
    other profiler the ranges would be events of their own)."""
    global _annotate
    _annotate = bool(on)


class PhaseTimer:
    """The program's spans and counters, and per-phase wall totals.

    Every `tic(name)` / `toc(name)` pair records a Span in the process's
    ring (`recorded` reads it), nested under the innermost span open on the
    same thread, stamped with the timer's `seq` (the sequence: the rank
    under a mesh) and `frame`; `toc` returns the span's seconds and adds
    them to the per-name `totals` and `counts`. `count(name, value)`
    records a counter event against the innermost open span. A phase that
    ends on the device must be synchronised by the caller before `toc` for
    the time to mean device time (see SLAM.synced_timers).

    Module-level code reaches the recorder that `activate` made this
    thread's through `span` and `sync`; without one they record nothing.
    Every span closes through `self.toc`, looked up on the instance at each
    call, so a `toc` replaced on the instance sees all of them."""

    def __init__(self, seq: int = 0) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._start: dict[str, float] = {}
        self.seq = seq
        self.frame: Optional[int] = None

    def tic(self, name: str) -> None:
        stack = _stack()
        parent = stack[-1][1] if stack else None
        rf = _open_range(name) if _annotate else None
        stack.append((name, next(_ids), parent, rf))
        self._start[name] = time.perf_counter()

    def toc(self, name: str) -> float:
        end = time.perf_counter()
        start = self._start.pop(name)
        dt = end - start
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        stack = _stack()
        i = len(stack) - 1
        while i >= 0 and stack[i][0] != name:
            i -= 1
        if i < 0:  # opened on another thread
            sid, parent = next(_ids), None
        else:
            # spans opened inside this one and left open (an exception)
            # close with it
            for _name, _sid, _parent, rf in reversed(stack[i:]):
                if rf is not None:
                    rf.__exit__(None, None, None)
            _name, sid, parent, _rf = stack[i]
            del stack[i:]
        _ring.append(Span(name, start, end, sid, parent, self.seq, self.frame))
        return dt

    def count(self, name: str, value) -> None:
        stack = _stack()
        _ring.append(Count(name, value, time.perf_counter(), stack[-1][1] if stack else None, self.seq,
                           self.frame))

    @contextlib.contextmanager
    def activate(self, frame: Optional[int] = None):
        """Make this the thread's active recorder (and `frame` the frame
        its spans carry) inside the block."""
        prev, prev_frame = getattr(_tls, "active", None), self.frame
        _tls.active, self.frame = self, frame
        try:
            yield self
        finally:
            _tls.active, self.frame = prev, prev_frame

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_ms": 1e3 * v / max(1, self.counts[k])}
            for k, v in self.totals.items()
        }


class _Span:
    __slots__ = ("rec", "name")

    def __init__(self, rec: PhaseTimer, name: str) -> None:
        self.rec, self.name = rec, name

    def __enter__(self) -> None:
        self.rec.tic(self.name)

    def __exit__(self, *exc) -> bool:
        self.rec.toc(self.name)
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A span of the thread's active recorder around a `with` block (none
    without one)."""
    rec = getattr(_tls, "active", None)
    return _NO_SPAN if rec is None else _Span(rec, name)


def sync():
    """The `sync` span around a statement that waits for the device: a
    device-to-host read, a host-to-device copy from pageable memory, a
    boolean-mask index. It adds no device work. Inside another `sync` it
    opens none."""
    rec = getattr(_tls, "active", None)
    if rec is None:
        return _NO_SPAN
    stack = _stack()
    return _NO_SPAN if stack and stack[-1][0] == "sync" else _Span(rec, "sync")


_constants: dict = {}


def device_constant(values, dtype, device):
    """`torch.tensor(values, dtype=dtype)` on `device`, made at the first
    call (inside a `sync` span: a copy from pageable host memory waits for
    the device's queue) and shared by the later ones. Never written to."""
    key = (values, dtype, str(device))
    t = _constants.get(key)
    if t is None:
        import torch

        with sync():
            t = _constants[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def count(name: str, value) -> None:
    """A counter event of the thread's active recorder (none without one)."""
    rec = getattr(_tls, "active", None)
    if rec is not None:
        rec.count(name, value)


def open_spans() -> tuple:
    """The names of the spans open on this thread, outermost first."""
    return tuple(e[0] for e in _stack())


def recorded(t0: float, t1: float) -> tuple[list, list]:
    """(spans, counter events) of the ring that lie within [t0, t1]
    (time.perf_counter() seconds), in the order they closed or were taken."""
    items = _ring.copy()
    spans = [r for r in items if type(r) is Span and r.start >= t0 and r.end <= t1]
    counts = [r for r in items if type(r) is Count and t0 <= r.t <= t1]
    return spans, counts
