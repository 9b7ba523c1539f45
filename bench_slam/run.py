"""The benchmark of `lvdgs_torch`, the PyTorch and CUDA port of LVD-GS SLAM.

    python3 bench_slam/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the card this process sees: set-up (the
kernels loaded or built, the street rendered on the card and the SLAM
warmed up through init mapping and its first keyframe), then a window of
`--seconds` in which the SLAM processes frames through
`SLAM.process_frame`, then the check of what the window produced against
the plain reference. Prints the metrics as one JSON line, last on
standard output; the compared numbers beside their limits are the last
lines on standard error and the last key of that line.

With `--trace 0` the metrics are the cell's end-to-end ones:
- fps (frames/s): the frames of the window's first whole keyframe
  periods (the mix's `periods`; sequence.measured_periods) over their
  wall time from the window's start;
- pose_ms (ms): the mean over the tracked frames of those periods of
  SLAM.timer's camera + tracking (tracking ends in a host transfer);
- setup_s (s): from this process's start to the window's.
With `--trace 1` they are the per-layer ones (metrics/<name>.py), read
from a run with synchronised phase timers and a device trace of the
window's first whole keyframe period.

Exits with 3 and prints no result without CUDA or with fewer cards than
the cell asks for, and with 4 if JAX or the JAX package is loaded."""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(ROOT) not in sys.path:
    sys.path.insert(1, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "lvdgs_tpu")
CONTROLS = {"bf16": {"Performance": {"blend_bf16": True}}}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc cache is lvdgs_torch/_build/)."""
    cache = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def sample_plan(seed: int, check: dict) -> dict:
    """The calls whose outputs are compared, drawn from the seed: the k-th
    tracking call, the k-th keyframe mapping run, and the j-th packed blend
    forward and backward of the window."""
    import numpy as np

    rng = np.random.default_rng([int(seed) % 2**63, 17])
    plan: dict = {"track": set(), "map": set(), "fwd": set(), "bwd": set()}

    def draw(kind: str, count: int, span: int) -> None:
        for _ in range(count):
            plan[kind].add(int(rng.integers(span)))

    draw("track", check["track"], check["track_span"])
    draw("map", check["map"], 1)
    draw("fwd", check["fwd"], check["call_span"])
    draw("bwd", check["bwd"], check["call_span"])
    return plan


def e2e_metrics(measured: list, clock: dict) -> dict:
    from sequence import period_rate

    frames, secs = period_rate(measured, clock["t0"])
    pose = [r["timers"]["camera"] + r["timers"]["tracking"] for r in measured
            if r["timers"]["tracking"] > 0.0]
    return {
        "fps": (frames / secs if secs > 0 else 0.0, "frames/s"),
        "pose_ms": (1e3 * sum(pose) / len(pose) if pose else None, "ms"),
        "setup_s": (clock["t0"] - T_PROCESS, "s"),
    }


def phase_at(spans: list, t: float) -> str:
    """What the host was doing at time t: the SLAM phase of the innermost
    timer span open then."""
    inner = [(a, name) for name, a, b in spans if a <= t < b]
    return max(inner)[1] if inner else "between"


def breakdown(trace: dict, spans: list) -> dict:
    from devtrace import idle_gaps

    lo, hi = trace["t_start"], trace["t_stop"]
    by_name: dict = {}
    for n, s, e in trace["events"]:
        by_name[n] = by_name.get(n, 0.0) + (min(e, hi) - max(s, lo)) * (s < hi and e > lo)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(((s, e) for _n, s, e in trace["events"]), lo, hi),
                  key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[phase_at(spans, 0.5 * (a + b)), b - a] for a, b in gaps]}


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: str | None = None) -> tuple[dict, list]:
    """One run of `cell` -> (result line, [(number, reading, limit)])."""
    import torch

    import check
    from capture import Capture
    from cells import sequence_config
    from devtrace import DeviceTrace, union_seconds
    from sequence import Sequence, first_period, measured_periods

    torch.set_num_threads(1)
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    if on_cuda:
        from lvdgs_torch.ops import rasterizer_cuda

        log(f"set-up: kernels loaded in {rasterizer_cuda.load_kernels():.3f} s, "
            f"{time.perf_counter() - T_PROCESS:.3f} s after start")
        torch.cuda.reset_peak_memory_stats(dev)
    traffic = cell.traffic
    overrides = json.loads(json.dumps(traffic.get("overrides", {})))
    for section, values in CONTROLS.get(control, {}).items():
        overrides.setdefault(section, {}).update(values)
    if trace:
        overrides.setdefault("Performance", {})["synced_timers"] = True
    seq = Sequence(sequence_config(cell.config, seed, overrides), traffic, dev)
    capture = Capture(sample_plan(seed, traffic["check"]))
    dtrace = DeviceTrace(dev) if trace and on_cuda else None

    seq.setup()
    if on_cuda:
        torch.cuda.synchronize(dev)
    on_first_period = None
    if trace:
        seq.record_spans()
        if dtrace is not None:
            dtrace.start()
            capture.launches = True

        def on_first_period():
            capture.launches = False
            if dtrace is not None:
                dtrace.stop()

    capture.install()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    try:
        seq.run_window(deadline, on_first_period)
    finally:
        capture.uninstall()
    if on_cuda:
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_cuda else 0
    clock = {"t0": t0, "deadline": deadline}
    # a traced run's metrics are those of the traced first period (stopping
    # the profiler takes seconds of the window, after that period)
    periods = 1 if trace else int(traffic["periods"])
    measured = measured_periods(seq.records, deadline, periods)
    metrics = e2e_metrics(measured, clock)
    kfs = [r for r in seq.records if r["kf"]]
    log(f"set-up {json.dumps({k: round(v, 3) for k, v in seq.setup_s.items()})}; window from "
        f"{t0 - T_PROCESS:.3f} s after start, last frame done {t_end - t0:.3f} s later; "
        f"window frames {len(seq.records)}, keyframes {len(kfs)} at "
        f"{[round(r['t1'] - t0, 2) for r in kfs]} s, mapping {[r['cams'] for r in kfs]} cameras; "
        f"measured frames {len(measured)}, mapping iterations {[r['iters'] for r in measured if r['kf']]}, "
        f"tracking iterations {capture.iterations}")
    # the work: the whole keyframe periods; one that the window did not
    # hold has failed
    attempted = periods
    failed = attempted - sum(r["kf"] for r in measured)
    device_info = {"platform": "gpu" if on_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": attempted, "failed": failed}
    record = {"t0": t0, "deadline": deadline, "records": measured,
              "first_period": first_period(seq.records), "trace": None, "launches": []}
    if dtrace is not None:
        events = dtrace.events()
        log(f"trace: {len(events)} device events")
        record["trace"] = {"t_start": dtrace.t_start, "t_stop": dtrace.t_stop, "events": events}
        record["launches"] = [{**L, "marched": int(L["march"].sum())} for L in capture.launch_log]
        device_info["busy_s"] = union_seconds(((s, e) for _n, s, e in events), dtrace.t_start,
                                              dtrace.t_stop)
        device_info["window_s"] = dtrace.t_stop - dtrace.t_start
        result["breakdown"] = breakdown(record["trace"], seq.spans)
    if trace:
        from cells import metric_reader

        out = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(record)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        names = {m["name"] for m in cell.end_to_end}
        out = {k: {"value": v, "unit": u} for k, (v, u) in metrics.items() if k in names and v is not None}
    result["metrics"] = out
    result["device"] = device_info

    # the program's state goes before the reference runs; the frames the
    # mapping check reads stay (the benchmark's own inputs)
    frames_of = {f: seq.frames[f][0] for snap in capture.map for f in snap["kf_frame"]}
    capture.launch_log.clear()
    record = dtrace = None
    seq.slam = None
    seq.frames = []
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    ok, table = check.judge(capture, frames_of, cell.limits)
    log(f"check: {len(capture.track)} tracking, {len(capture.map)} mapping, {len(capture.fwd)} forward and "
        f"{len(capture.bwd)} backward samples against the reference in {time.perf_counter() - t:.3f} s")
    result["correct"] = bool(ok)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in table.items()}
    return result, [(k, v, lim) for k, (v, lim) in table.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=sorted(CONTROLS),
                    help="run the program with this lower-precision path on (the control of the check)")
    args = ap.parse_args(argv)
    cache_env(ROOT)
    os.environ.setdefault("USE_FLAX", "0")

    from cells import find_cell

    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result, table = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", args.control)
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}; the benchmark runs without them",
              file=sys.stderr)
        return 4
    for name, val, lim in table:
        print(f"check {name}: {val!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
