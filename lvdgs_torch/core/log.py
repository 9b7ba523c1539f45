"""Tagged console logging and per-phase wall timers.

Same interface as the reference package's logger: rich when available,
plain prints otherwise. ``LVDGS_LOG=0`` silences it.
"""
from __future__ import annotations

import os
import sys
import time

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


class PhaseTimer:
    """Lightweight per-phase wall timers. A phase that ends on the device
    must be synchronised by the caller before `toc` for the time to mean
    device time (see SLAM.synced_timers)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._start: dict[str, float] = {}

    def tic(self, name: str) -> None:
        self._start[name] = time.perf_counter()

    def toc(self, name: str) -> float:
        dt = time.perf_counter() - self._start.pop(name)
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return dt

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_ms": 1e3 * v / max(1, self.counts[k])}
            for k, v in self.totals.items()
        }
