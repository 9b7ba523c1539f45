"""The program's own spans and counters (the recorder of
`lvdgs_torch.core.log`) for the per-layer readers.

Every span of the program is stamped with `time.perf_counter()`, the
clock `devtrace.py` puts the device's events on, so a kernel belongs to
the span in which it started on the device. In the traced run each phase
ends with a device synchronise (SLAM's `phase_sync`), so no kernel of one
phase starts inside another's span. A program without the recorder gives
None, and its readers report nothing."""
from __future__ import annotations

from bisect import bisect_right


def window(record: dict):
    """(spans, counter events) that lie within the measured records, or
    None where the program keeps none."""
    recs = record.get("records")
    if not recs:
        return None
    try:
        from lvdgs_torch.core.log import recorded
    except ImportError:
        return None
    return recorded(recs[0]["t0"], recs[-1]["t1"])


def named(spans: list, name: str, lo: float = float("-inf"), hi: float = float("inf")) -> list:
    """The spans called `name` that lie within [lo, hi]."""
    return [s for s in spans if s.name == name and s.start >= lo and s.end <= hi]


def counted(counts: list, name: str, spans: list) -> float:
    """The sum of the `name` counter events taken inside `spans`."""
    ids = {s.id for s in spans}
    return sum(c.value for c in counts if c.name == name and c.span in ids)


def traced_spans(record: dict, name: str):
    """(trace, the `name` spans of the measured records inside the traced
    period), or None without a trace or a recorder."""
    tr, got = record.get("trace"), window(record)
    if not tr or got is None:
        return None
    return tr, named(got[0], name, tr["t_start"], tr["t_stop"]), got[1]


def kernels_in(trace: dict, spans: list) -> int:
    """Kernels (not copies or sets) of the trace whose device start lies
    inside one of `spans` (which do not overlap)."""
    spans = sorted(spans, key=lambda s: s.start)
    starts = [s.start for s in spans]
    n = 0
    for name, st, _e in trace["events"]:
        if name.startswith(("Memcpy", "Memset")):
            continue
        i = bisect_right(starts, st) - 1
        n += i >= 0 and st < spans[i].end
    return n
