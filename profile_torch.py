#!/usr/bin/env python3
"""Where a tracking call and a mapping run of lvdgs_torch spend their time.

    python3 profile_torch.py [--frames 6] [--device cuda]

Runs the street scene (configs/mono/synthetic/street.yaml at 1226x370, dense
rendering, as chip_smoke.py does) for a few frames to build a real map and
window, then profiles one `track_camera` call on the next frame and one
20-iteration `mapping_run` on the current window with torch.profiler. Prints,
for each: wall time, device-busy share (kernel time over wall time), the
number of host-device synchronisations (CUDA sync debug mode), the blend
kernels' launch counts, and the operators and kernels that take the most
device and host time.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))


def build_slam(frames: int, device):
    from lvdgs_torch.core.config import load_config
    from lvdgs_torch.slam.system import SLAM

    config = load_config(os.path.join(ROOT, "configs/mono/synthetic/street.yaml"))
    config["Performance"].update({"packed_tracking_budget": 0, "packed_mapping_budget": 0})
    config["Training"]["mono_scale_servo"] = False
    config["Dataset"]["n_frames"] = frames + 1
    slam = SLAM(config, save_dir=None, device=device)
    for idx in range(frames):
        slam.process_frame(idx)
    return slam


def profile(label: str, fn, device, top: int = 12) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from lvdgs_torch.ops import rasterizer_cuda as rc

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    fn()  # warm-up: allocator, cuBLAS handles
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
    for w in rc.KERNEL_WRAPPERS:
        w.launches.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with tprofile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    if cuda:
        torch.cuda.set_sync_debug_mode(0)
    launches = {w.__name__: w.launches.count for w in rc.KERNEL_WRAPPERS}
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    kernel_us = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type.name == "CUDA")
    print(f"\n== {label}: wall {wall * 1e3:.1f} ms, kernels {kernel_us / 1e3:.1f} ms "
          f"(device busy {100 * kernel_us / 1e3 / (wall * 1e3):.1f}%), "
          f"{len(syncs)} host-device synchronisations, blend kernel launches {launches}", flush=True)
    where = {}
    for w in syncs:
        key = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
        where[key] = where.get(key, 0) + 1
    for key, n in sorted(where.items(), key=lambda kv: -kv[1])[:8]:
        print(f"   sync x{n} at {key}")
    sort = "self_device_time_total" if cuda else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort, row_limit=top, max_name_column_width=60), flush=True)
    if cuda:
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=top,
                                        max_name_column_width=60), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=6, help="street frames run before profiling")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from lvdgs_torch.slam.mapping import mapping_run
    from lvdgs_torch.slam.tracking import track_camera

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    slam = build_slam(args.frames, device)
    print(f"map: {slam.gmap.num_active} active of {slam.gmap.capacity}, window {slam.current_window}",
          flush=True)

    idx = args.frames
    cam = slam._pose_seed(idx, slam._build_camera(idx))

    def track():
        res = track_camera(slam.gmap.params(), slam.gmap.active, cam, slam.intr, slam.rcfg, slam.tcfg)
        print(f"   tracking iterations: {res.iterations}", flush=True)

    def mapping():
        # on copies: the profiled run must not change the state it is run on twice
        gmap, opt_state = slam.gmap.clone(), slam.opt_state.clone()
        kfbuf = slam.kfbuf.replace(R=slam.kfbuf.R.clone(), T=slam.kfbuf.T.clone(),
                                   exposure_ab=slam.kfbuf.exposure_ab.clone())
        mapping_run(gmap, opt_state, kfbuf, slam._window_slots(), torch.Generator().manual_seed(0),
                    slam.iteration_count, 20, intr=slam.intr, rcfg=slam.rcfg, opt=slam.opt,
                    mcfg=slam.mcfg)

    profile(f"track_camera (frame {idx})", track, device)
    profile(f"mapping_run (20 iterations, window of {len(slam.current_window)})", mapping, device)


if __name__ == "__main__":
    main()
