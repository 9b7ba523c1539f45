"""The one traffic generator: a sequence of the synthetic street, a `SLAM`
of the port driven frame by frame through `process_frame`.

A mix file (`traffic/<mix>.json`) gives:
- `n_frames`: the frames of the street (all of them rendered on the
  device in set-up; nothing is rendered in the window);
- `warmup_keyframes`: set-up processes frames until the SLAM holds this
  many keyframes (2: init mapping, then the first keyframe after it);
- `periods`: the whole keyframe periods at the window's start that the
  metrics are taken over (`measured_periods`), the same work in every run;
- `overrides`: config sections merged into the config.

The street and the SLAM's generator come from the seed: the seed changes
the scene and not the sizes.

The window: the sequence processes its next frame while the window is
open and starts no frame once it has closed. Every frame is recorded:
host-clock start and end, whether it made a keyframe, and the SLAM's
phase timers and mapping iterations it added."""
from __future__ import annotations

import time

# SLAM.timer phases a frame can add to
PHASES = ("camera", "tracking", "kf_fusion", "kf_seed", "kf_mapping", "kf_prune")


class Sequence:
    def __init__(self, config: dict, traffic: dict, device):
        self.config = config
        self.traffic = traffic
        self.device = device
        self.slam = None
        self.frames: list = []
        self.next_frame = 0
        self.records: list = []
        self.spans: list | None = None  # [(phase, start, end)] in a traced run

    # set-up -------------------------------------------------------------

    def setup(self) -> None:
        from lvdgs_torch.slam.system import SLAM

        t = time.perf_counter()
        self.slam = SLAM(self.config, device=self.device)
        n = min(int(self.traffic["n_frames"]), len(self.slam.dataset))
        self.frames = [self.slam.dataset[k] for k in range(n)]
        self.setup_s = {"slam": time.perf_counter() - t}
        want = int(self.traffic.get("warmup_keyframes", 2))
        while len(self.slam.kf_indices) < want:
            if self.next_frame >= len(self.frames):
                raise RuntimeError("warm-up ran out of frames")
            t = time.perf_counter()
            self.slam.process_frame(self.next_frame, self.frames[self.next_frame])
            key = "init" if self.next_frame == 0 else "warmup_frames"
            self.setup_s[key] = self.setup_s.get(key, 0.0) + time.perf_counter() - t
            self.next_frame += 1

    # window -------------------------------------------------------------

    def record_spans(self) -> None:
        """Keep every SLAM.timer span of the window (what the host was
        doing, for the idle gaps of the trace)."""
        timer = self.slam.timer
        self.spans = spans = []
        toc = timer.toc

        def toc_span(name):
            start = timer._start.get(name)
            dt = toc(name)
            spans.append((name, start, start + dt))
            return dt

        timer.toc = toc_span

    def run_window(self, deadline: float, on_first_period=None) -> None:
        """Process frames until `deadline`; `on_first_period()` runs once
        the window's first keyframe has been mapped (or the window ends)."""
        slam = self.slam
        while time.perf_counter() < deadline and self.next_frame < len(self.frames):
            idx = self.next_frame
            before = dict(slam.timer.totals)
            kfs, its = len(slam.kf_indices), slam.iteration_count
            t0 = time.perf_counter()
            slam.process_frame(idx, self.frames[idx])
            t1 = time.perf_counter()
            self.next_frame += 1
            kf = len(slam.kf_indices) > kfs
            rec = {"frame": idx, "t0": t0, "t1": t1, "kf": kf,
                   "timers": {p: slam.timer.totals.get(p, 0.0) - before.get(p, 0.0) for p in PHASES},
                   "iters": slam.iteration_count - its}
            if kf:
                # cameras rendered per mapping iteration: the window and
                # the replay keyframes drawn from those outside it
                n_win = len(slam.current_window)
                n_elig = max(slam.kfbuf.count - n_win, 0)
                rec["cams"] = n_win + min(slam.mcfg.n_random, n_elig)
            self.records.append(rec)
            if kf and on_first_period is not None:
                on_first_period()
                on_first_period = None
        if on_first_period is not None:
            on_first_period()


def measured_periods(records: list, deadline: float, periods: int) -> list:
    """The records of the first `periods` whole keyframe periods in the
    window: the work the metrics are taken over. A period runs from the
    end of one keyframe's mapping to the end of the next (the window's
    start counts as the end of the warm-up's last keyframe); one that ends
    after the window has closed is not whole. Fewer whole periods than
    asked for give those there are."""
    out, n = [], 0
    for r in records:
        if n == periods or r["t1"] > deadline:
            break
        out.append(r)
        n += r["kf"]
    while out and not out[-1]["kf"]:
        out.pop()
    return out


def period_rate(measured: list, t0: float) -> tuple[int, float]:
    """(frames, seconds) of measured periods that start at the window's
    start t0."""
    if not measured:
        return 0, 0.0
    return len(measured), measured[-1]["t1"] - t0


def first_period(records: list) -> list:
    """The records of the first period in the window."""
    out = []
    for r in records:
        out.append(r)
        if r["kf"]:
            return out
    return []
