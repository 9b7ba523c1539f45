"""The program's span and counter recorder (lvdgs_torch/core/log.py) and the
spans and counters the SLAM loop records with it.

The recorder's own cases and a tiny street SLAM (128x48, the KITTI-07
camera scaled, packed renders) run on the CPU in seconds. The test marked
`cuda` holds every synchronising CUDA call of a tracked frame and a
keyframe inside a `sync` span; it skips without a card. This file imports
neither JAX nor the reference package, so it also runs where only PyTorch
is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""
import dataclasses
import json
import math
import os
import threading
import time
import warnings

import pytest
import torch

from lvdgs_torch.core import log
from lvdgs_torch.core.config import load_config
from lvdgs_torch.core.log import PhaseTimer, recorded
from lvdgs_torch.slam import mapping, system
from torch_parity import cuda_device  # noqa: F401 - fixture

ROOT = os.path.join(os.path.dirname(__file__), "..")
STREET = os.path.join(ROOT, "configs", "mono", "synthetic", "street.yaml")
SPAN_NAMES = ("frame", "camera", "tracking", "track.seed", "track.bin", "track.steps", "track.final",
              "sync", "mapping", "kf_fusion", "fusion.depth", "fusion.align", "kf_seed",
              "seed.capacity", "seed.points", "kf_mapping", "map.bin", "map.render", "map.backward",
              "map.update", "kf_prune", "prune.covis", "prune.state")
# each phase's leaf spans, which cover its work
LEAVES = {"tracking": {"track.seed", "track.bin", "track.steps", "track.final"},
          "kf_fusion": {"fusion.depth", "fusion.align"}, "kf_seed": {"seed.capacity", "seed.points"},
          "kf_mapping": {"map.bin", "map.render", "map.backward", "map.update"},
          "kf_prune": {"prune.covis", "prune.state"}}


def _since(t0):
    return recorded(t0, float("inf"))


# ---------------------------------------------------------------------------
# the recorder


def test_spans_nest_on_the_perf_counter_clock():
    timer = PhaseTimer(seq=3)
    timer.frame = 7
    t0 = time.perf_counter()
    timer.tic("outer")
    t1 = time.perf_counter()
    timer.tic("inner")
    timer.count("things", 5)
    dt = timer.toc("inner")
    timer.toc("outer")
    t2 = time.perf_counter()
    spans, counts = _since(t0)
    inner, outer = spans
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent == outer.id and outer.parent is None
    assert t0 <= outer.start <= t1 <= inner.start <= inner.end <= outer.end <= t2
    assert dt == inner.end - inner.start
    assert (inner.seq, inner.frame) == (3, 7)
    (c,) = counts
    assert (c.name, c.value, c.span, c.seq) == ("things", 5, inner.id, 3)
    assert timer.counts == {"inner": 1, "outer": 1} and timer.totals["inner"] == dt
    assert recorded(t2, float("inf")) == ([], [])


def test_the_ring_keeps_the_newest_spans():
    timer = PhaseTimer()
    t0 = time.perf_counter()
    for k in range(log.RING_CAPACITY + 10):
        timer.tic("s")
        timer.toc("s")
    spans, _ = _since(t0)
    assert len(spans) == log.RING_CAPACITY
    assert spans[-1].id - spans[0].id == log.RING_CAPACITY - 1


def test_each_thread_keeps_its_own_stack():
    timer = PhaseTimer()
    t0 = time.perf_counter()
    ready = threading.Barrier(2)

    def work(tag):
        timer.tic(f"outer{tag}")
        ready.wait(timeout=10)  # both outer spans open at once
        timer.tic(f"inner{tag}")
        timer.toc(f"inner{tag}")
        ready.wait(timeout=10)
        timer.toc(f"outer{tag}")

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    by_name = {s.name: s for s in _since(t0)[0]}
    for tag in "ab":
        assert by_name[f"inner{tag}"].parent == by_name[f"outer{tag}"].id
        assert by_name[f"outer{tag}"].parent is None


def test_module_spans_reach_a_toc_replaced_on_the_instance():
    """The benchmark keeps every span by replacing `toc` on the SLAM's timer
    and reading `_start` before it: the module-level spans, counters and
    syncs go through the active recorder's `toc` as well."""
    timer = PhaseTimer()
    kept = []
    toc = timer.toc

    def toc_span(name):
        start = timer._start.get(name)
        dt = toc(name)
        kept.append((name, start, start + dt))
        return dt

    timer.toc = toc_span
    assert log.open_spans() == ()
    with log.span("nothing"), log.sync():  # no active recorder: no span
        log.count("nothing", 1)
    t0 = time.perf_counter()
    with timer.activate(frame=4):
        with log.span("a"):
            with log.sync():
                with log.sync():  # a sync inside a sync opens none
                    assert log.open_spans() == ("a", "sync")
            log.count("n", 2)
    assert [k[0] for k in kept] == ["sync", "a"]
    spans, counts = _since(t0)
    assert [(s.name, s.start, s.end) for s in spans] == kept
    assert spans[0].parent == spans[1].id and spans[0].frame == 4
    assert counts[0].span == spans[1].id
    assert timer.frame is None and log.open_spans() == ()


def test_a_toc_closes_the_spans_left_open_inside_it():
    timer = PhaseTimer()
    t0 = time.perf_counter()
    timer.tic("outer")
    timer.tic("left open")
    timer.toc("outer")
    timer.tic("next")
    timer.toc("next")
    outer, nxt = _since(t0)[0]
    assert nxt.parent is None and log.open_spans() == ()


# ---------------------------------------------------------------------------
# the SLAM loop


REBIN = 4  # the tracker's rebin period here: up to 3 periods in 10 iterations


def _tiny_slam(n_frames: int, device="cpu", **results) -> system.SLAM:
    """street.yaml at 128x48, single-threaded as the benchmark's cell, with
    short budgets; the tiny map stays all in view, so kf_overlap above 1
    makes every kf_interval-th frame a keyframe."""
    cfg = load_config(STREET)
    cal = cfg["Dataset"]["Calibration"]
    s = 128 / cal["width"]
    cal.update(width=128, height=48, fx=cal["fx"] * s, fy=cal["fy"] * s, cx=64.0, cy=24.0)
    cfg["Dataset"].update(n_frames=n_frames, dynamic_objects=0)
    cfg["Training"].update(init_itr_num=10, tracking_itr_num=10, mapping_itr_num=10, kf_interval=2,
                           kf_overlap=1.01, plateau_min_iters=4, single_thread=True,
                           mono_scale_servo=False)
    cfg["Performance"].update(max_per_tile=64, tile_chunk=16, map_capacity=16384,
                              packed_tracking_budget=32, packed_mapping_budget=32)
    cfg["Results"].update(save_results=False, eval_rendering=False, color_refinement=False, **results)
    slam = system.SLAM(cfg, save_dir=None, device=device)
    slam.tcfg = dataclasses.replace(slam.tcfg, rebin_every=REBIN)
    return slam


@pytest.fixture(scope="module")
def street_run():
    """Five frames of the tiny street on the CPU (keyframes 2 and 4), with
    the tracker's returned iterations and the mapping renders counted
    beside the recorder."""
    slam = _tiny_slam(5)
    iterations, renders = [], []
    track_camera, rasterize = system.track_camera, mapping.rasterize

    def counted_track(*args):
        res = track_camera(*args)
        iterations.append(res.iterations)
        return res

    def counted_render(*args, **kw):
        renders.append(1)
        return rasterize(*args, **kw)

    system.track_camera, mapping.rasterize = counted_track, counted_render
    t0 = time.perf_counter()
    try:
        for idx in range(len(slam.dataset)):
            slam.process_frame(idx)
    finally:
        system.track_camera, mapping.rasterize = track_camera, rasterize
    spans, counts = _since(t0)
    return slam, spans, counts, iterations, len(renders)


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_frames_hold_their_phases_and_the_tracker_its_iterations(street_run):
    slam, spans, counts, iterations, _ = street_run
    frames = [s for s in spans if s.name == "frame"]
    assert [s.frame for s in frames] == list(range(5))
    tracked = frames[1:]
    assert len(iterations) == len(tracked) and slam.kf_indices == [0, 2, 4]
    for fr, its in zip(tracked, iterations):
        kids = {s.name for s in _children(spans, fr)}
        assert {"camera", "tracking"} <= kids, kids
        (track,) = [s for s in _children(spans, fr) if s.name == "tracking"]
        got = [c.value for c in counts if c.name == "track.iterations" and c.span == track.id]
        assert got == [its]
        rec = slam.frames[fr.frame]
        assert rec["iterations"] == its and rec["seq"] == 0
        # the pose-out time: after the pose record's host read, in the span
        assert track.start < rec["pose_out"] <= track.end
    for s in spans:
        if s.frame in range(5) and s.name != "frame":
            assert s.parent is not None
        if s.name in LEAVES:
            assert LEAVES[s.name] <= {c.name for c in _children(spans, s)}, s.name
    assert {s.name for s in spans} >= set(LEAVES)


def test_each_period_ends_in_one_read(street_run):
    """One `sync` a rebin period, then the pose read, after the pose seed:
    periods are ceil(iterations / REBIN)."""
    _slam, spans, _counts, iterations, _ = street_run
    tracks = [s for s in spans if s.name == "tracking"]
    for track, its in zip(tracks, iterations):
        kids = sorted(_children(spans, track), key=lambda s: s.start)
        bins = [s for s in kids if s.name == "track.bin"]
        assert len(bins) == math.ceil(its / REBIN) >= 1
        reads = [s for s in kids if s.name == "sync" and s.start > bins[0].start]
        assert len(reads) == len(bins) + 1
        order = [s.name for s in kids if s.start >= bins[0].start]
        assert order == ["track.bin", "track.steps", "sync"] * (len(bins) - 1) + [
            "track.bin", "track.steps", "sync", "track.final", "sync"]


def test_mapping_counts_the_cameras_it_rendered(street_run):
    _slam, spans, counts, _its, renders = street_run
    assert renders > 0
    assert sum(c.value for c in counts if c.name == "map.cam_iters") == renders
    maps = [s for s in spans if s.name == "kf_mapping"]
    assert maps
    for m in maps:
        kids = {s.name for s in spans if s.parent == m.id}
        assert {"map.bin", "map.render", "map.backward", "map.update"} <= kids, kids
        # one `map.render` an iteration; each run here maps 10
        assert sum(s.name == "map.render" for s in spans if s.parent == m.id) == 10


def test_spans_annotate_only_the_profile_dir_trace(tmp_path):
    """Under another profiler the spans emit no range; the profiler that
    Results.profile_dir starts shows them over their work."""
    slam = _tiny_slam(3, profile_dir=str(tmp_path), profile_after=0, profile_frames=0)
    slam.kf_interval = 5  # tracked frames only
    slam.tcfg = dataclasses.replace(slam.tcfg, max_iters=REBIN)
    def annotations(path):
        return {e.get("name") for e in json.loads(path.read_text())["traceEvents"]
                if e.get("cat") == "user_annotation"}

    slam.process_frame(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        slam.process_frame(1)
    prof.export_chrome_trace(str(tmp_path / "other.json"))
    assert not annotations(tmp_path / "other.json") & set(SPAN_NAMES)
    slam.run(n_frames=3, progress=False)  # frame 2 under profile_dir's profiler
    (trace,) = [p for p in tmp_path.rglob("*.json") if p.name != "other.json"]
    names = annotations(trace)
    assert {"frame", "camera", "tracking", "track.bin", "track.steps", "sync"} <= names, names
    assert not log._annotate


@pytest.mark.cuda
def test_sync_calls_fall_inside_sync_spans(cuda_device):  # noqa: F811
    """Every synchronising CUDA call of a tracked frame and of a keyframe
    (torch.cuda.set_sync_debug_mode) happens inside a `sync` span."""
    slam = _tiny_slam(8, device=cuda_device)
    # the frames rendered first, as SLAM.run's loader and the benchmark do:
    # the synthetic street's renders are the input, not the frame path
    samples = [slam.dataset[i] for i in range(len(slam.dataset))]
    slam.process_frame(0, samples[0])
    slam.process_frame(1, samples[1])
    torch.cuda.synchronize()
    outside, seen = [], []

    def showwarning(message, category, filename, lineno, file=None, line=None):
        # the frame path's calls: those made while a `frame` span is open
        if "synchroniz" in str(message) and "frame" in log.open_spans():
            seen.append(filename)
            if "sync" not in log.open_spans():
                outside.append(f"{filename}:{lineno} in {log.open_spans()}")

    kfs = len(slam.kf_indices)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = showwarning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            idx = 2
            while len(slam.kf_indices) == kfs and idx < len(samples):
                slam.process_frame(idx, samples[idx])
                idx += 1
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert len(slam.kf_indices) > kfs, "no keyframe in the frames run"
    assert seen and not outside, outside[:10]

