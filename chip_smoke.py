#!/usr/bin/env python3
"""Smoke test of the lvdgs_torch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which must pass:
1. build the CUDA kernels from lvdgs_torch/csrc with nvcc;
2. hold each kernel against its plain PyTorch version on the card at the
   street-scene shapes (1226x370 -> 77x24 = 1848 tiles, 256 slots per tile),
   and time both with CUDA events;
3. drive the SLAM loop (SLAM.run) on configs/mono/synthetic/street.yaml at
   full width with dense rendering, then check that every kernel was
   launched, that poses and map are finite, and that the card's render of a
   small scene agrees with the CPU render and the NumPy oracle;
4. print the per-kernel JSON line, then the result line.

Exits non-zero, printing no result, when CUDA is unavailable, when run
outside a checkout, or when any phase fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and FP32 (non-tensor)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per (pixel, marched slot), counted from the kernel source
# (blend.cu): alpha = 16 (2 sub, 9 mul/add for the conic power, exp, the
# opacity product, 3 compares/min), then per kernel:
OPS_FWD = 16 + 1 + 8 + 2  # weight, 4 colour/depth multiply-adds, transmittance
OPS_BWD = 16 + 1 + 8 + 2 + 30 + 4 + 25 + 10  # + dL/dalpha, gates, 10 grads, reductions
OPS_MED = 16 + 2 + 2  # transmittance, crossing test

REPLACES = {
    "blend_forward": "lvdgs_tpu/ops/rasterizer_pallas.py:86",
    "blend_backward": "lvdgs_tpu/ops/rasterizer_pallas.py:136",
    "median_depth": "lvdgs_tpu/ops/rasterizer_pallas.py:310",
}
# the TPU kernels' names in ROADMAP.md and PERF.md
KERNEL_IDS = {"blend_forward": "B1", "blend_backward": "B2", "median_depth": "B3"}
SOURCE = "lvdgs_torch/csrc/blend.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2, inner: int = 1) -> float:
    """Median over `reps` CUDA-event timings, after warm-up, of `inner`
    back-to-back calls of fn(), per call (several calls per event pair keep
    the events' own overhead out of a short kernel's time)."""
    import torch

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


def street_block(K: int, T: int, ntx: int, seed: int, device):
    """Random depth-sorted slot lists with ragged counts, shaped like the
    street scene's: Gaussians scattered around each tile, 1-60 px wide."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    tid = torch.arange(T, device=device)
    cx = ((tid % ntx) * 16 + 8).to(torch.float32)
    cy = ((tid // ntx) * 16 + 8).to(torch.float32)
    u = lambda *shape: torch.rand(*shape, generator=g, device=device)  # noqa: E731
    tp = torch.empty((K, T, 10), device=device)
    tp[..., 0] = cx[None] + (u(K, T) - 0.5) * 40.0
    tp[..., 1] = cy[None] + (u(K, T) - 0.5) * 40.0
    sigma = 1.0 + 20.0 * u(K, T) ** 2  # pixels
    a = 1.0 / sigma**2
    tp[..., 2] = a
    tp[..., 3] = (u(K, T) - 0.5) * 0.5 * a
    tp[..., 4] = a * (0.5 + u(K, T))
    tp[..., 5:8] = u(K, T, 3)
    tp[..., 8] = torch.sort(1.0 + 60.0 * u(K, T), dim=0).values
    # some opacities reach the 0.99 clamp, whose gate the backward must keep
    tp[..., 9] = 0.05 + 0.95 * u(K, T)
    counts = (u(T) * (K + 1)).floor().clamp(max=K).to(torch.int32)
    return tp.contiguous(), counts


def marched_slots(tp, counts, ntx: int, threshold: float) -> int:
    """(tile, slot) pairs the kernels march under the shared stop rule."""
    import torch
    from lvdgs_torch.ops import rasterizer_cuda as rc

    K, T, _ = tp.shape
    px, py = rc._pixel_coords(T, ntx, tp.device)
    trans = torch.ones((T, rc.P), device=tp.device)
    alive = torch.ones(T, dtype=torch.bool, device=tp.device)
    total = torch.zeros((), dtype=torch.int64, device=tp.device)
    for k in range(K):
        alive = alive & (k < counts) & (trans > threshold).any(dim=1)
        total += alive.sum()
        alpha = rc._alpha_at(tp[k], px, py)[0]
        trans = trans * (1.0 - torch.where(alive[:, None], alpha, torch.zeros_like(alpha)))
    return int(total)


def bound_ms(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(name: str, out, ref) -> tuple[float, float]:
    """(max abs error, the error held against the tolerance) of one
    kernel's outputs against its plain version's. The backward's per-slot
    sums over 256 pixels run in another order than the plain version's, so
    its error is taken relative to each field's largest gradient."""
    if name != "blend_backward":
        err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(out, ref))
        return err, err
    scale = ref.abs().amax(dim=(0, 1), keepdim=True) + 1e-12
    return float((out - ref).abs().max()), float(((out - ref).abs() / scale).max())


def check_kernels(tp, counts, ntx: int, label: str) -> dict:
    """Each kernel against its plain version on one (K, T, 10) slot block,
    with a random cotangent for the backward; then both timed, and the
    kernels timed again as built with multiply-add contraction."""
    import torch
    from lvdgs_torch.ops import rasterizer_cuda as rc

    K, T, _ = tp.shape
    g = torch.Generator(device=tp.device).manual_seed(1)
    dacc = torch.randn((T, 4, rc.P), generator=g, device=tp.device)
    dtrans = torch.randn((T, rc.P), generator=g, device=tp.device)
    # the kernels read only the slots they march, so the bound counts those
    # slots' 40 bytes, not the whole (K, T, 10) block, plus the counts and
    # io_bytes: the other inputs read once and the outputs written once
    marched = {thr: marched_slots(tp, counts, ntx, thr) for thr in (rc.T_EPS, 0.5)}
    acc, trans, nt = rc.blend_forward(tp, counts, ntx)
    report = {
        "blend_forward": dict(args=(tp, counts, ntx), plain=rc.blend_forward_plain,
                              wrapper=rc.blend_forward, threshold=rc.T_EPS, ops=OPS_FWD, tol=1e-5,
                              io_bytes=(acc.numel() + trans.numel() + nt.numel()) * 4),
        # the tolerance is 1e-5 of each field's largest gradient
        "blend_backward": dict(args=(tp, counts, acc, trans, dacc, dtrans, ntx),
                               plain=rc.blend_backward_plain, wrapper=rc.blend_backward,
                               threshold=rc.T_EPS, ops=OPS_BWD, tol=1e-5,
                               io_bytes=(acc.numel() + trans.numel() + dacc.numel()
                                          + dtrans.numel() + K * T * rc.NF) * 4),
        "median_depth": dict(args=(tp, counts, ntx), plain=rc.median_depth_plain,
                             wrapper=rc.median_depth, threshold=0.5, ops=OPS_MED, tol=1e-5,
                             io_bytes=2 * T * rc.P * 4),
    }
    fmad_lib = rc._library(fmad=True)
    fmad_fn = {"blend_forward": fmad_lib.lvdgs_blend_fwd, "blend_backward": fmad_lib.lvdgs_blend_bwd,
               "median_depth": fmad_lib.lvdgs_median_depth}
    for name, r in report.items():
        args = r["args"]
        out = r["wrapper"](*args)
        ref = r["plain"](*args)
        torch.cuda.synchronize()
        r["max_abs_err"], err = errors(name, out, ref)
        ok = err <= r["tol"]
        what = "of each field's largest gradient" if name == "blend_backward" else "absolute"
        print(f"kernel {name} [{label}]: max_abs_err {r['max_abs_err']:.3e}, error {err:.3e} against a "
              f"tolerance of {r['tol']:.0e} ({what}) {'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version")
        r["ms"] = time_ms(lambda: r["wrapper"](*args), reps=10, inner=20)
        r["plain_ms"] = time_ms(lambda: r["plain"](*args), reps=10, warmup=1)
        m = marched[r["threshold"]]
        r["bound_ms"], r["bound_by"] = bound_ms(m * rc.NF * 4 + T * 4 + r["io_bytes"], m * rc.P * r["ops"])
        print(f"kernel {name} [{label}]: {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {m} tile-slots marched)", flush=True)

        # the same kernel built with contraction, on the same inputs and
        # outputs of the same shapes, timed in turns with the shipped build
        outs = [torch.empty_like(o) for o in (out if isinstance(out, tuple) else (out,))]
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        ptrs = [x.data_ptr() for x in (*ins, *outs)]

        def call(fn=fmad_fn[name], ptrs=ptrs, name=name):
            rc._check_launch(fn(*ptrs, K, T, ntx, rc._stream()), name)

        call()
        torch.cuda.synchronize()
        fmad_err = errors(name, outs if len(outs) > 1 else outs[0], ref)[1]
        fmad_ms = time_ms(call, reps=10, inner=20)
        again_ms = time_ms(lambda: r["wrapper"](*args), reps=10, inner=20)
        print(f"kernel {name} [{label}]: with multiply-add contraction {fmad_ms:.4f} ms against "
              f"{r['ms']:.4f} / {again_ms:.4f} ms as shipped (-fmad=false), error {fmad_err:.3e} "
              f"({what})", flush=True)
    return report


def main_path_block(slam):
    """The (K, T, 10) slot block and counts that the main path's last render
    blends: the final map seen from the newest keyframe."""
    import torch
    from lvdgs_torch.ops import rasterizer as tr

    p, active = slam.gmap.params(), slam.gmap.active
    slot = slam.kf_slots[slam.kf_indices[-1]]
    ntx, nty = slam.rcfg.grid(slam.intr)
    proj = tr.project_gaussians(p["means"], p["quats"], p["log_scales"], active,
                                slam.kfbuf.R[slot], slam.kfbuf.T[slot], slam.intr)
    tile_idx, slot_valid = tr._bin_for(proj, slam.rcfg, ntx, nty)
    colors = torch.clamp(0.5 + tr.SH_C0 * p["features_dc"], 0.0, 1.0)
    opac = torch.where(active, torch.sigmoid(p["logit_opacities"]), torch.zeros_like(p["logit_opacities"]))
    tp = tr._tile_params(tile_idx, proj["mean2d"], proj["conic"], colors, opac, proj["depth"])
    return tp, slot_valid.sum(dim=1, dtype=torch.int32), ntx


def small_render_check(device) -> None:
    """The card's render of a small scene against the CPU render (plain
    kernels) and the NumPy oracle, values and gradients."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from reference_rasterizer import render_np

    from lvdgs_torch.core.camera import Intrinsics
    from lvdgs_torch.ops.rasterizer import RenderConfig, rasterize

    intr = Intrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
    cfg = RenderConfig(max_per_tile=64, tile_chunk=16)
    rng = np.random.default_rng(0)
    n = 100
    scene = {
        "means": np.concatenate([rng.normal(size=(n, 2)) * 1.2, rng.uniform(2, 6, (n, 1))], 1),
        "features_dc": rng.normal(size=(n, 3)) * 0.5,
        "log_scales": rng.uniform(-2.5, -1.0, (n, 3)),
        "quats": rng.normal(size=(n, 4)),
        "logit_opacities": rng.uniform(-1.0, 2.5, n),
    }
    outs = {}
    for dev in (device, torch.device("cpu")):
        p = {k: torch.tensor(v, dtype=torch.float32, device=dev, requires_grad=True)
             for k, v in scene.items()}
        out = rasterize(p, torch.ones(n, dtype=torch.bool, device=dev), torch.eye(3, device=dev),
                        torch.zeros(3, device=dev), intr, cfg)
        loss = ((out.image - 0.3) ** 2).mean() + 0.05 * (out.depth ** 2).mean()
        loss.backward()
        outs[dev.type] = (out.image.detach().cpu().numpy(), out.depth.detach().cpu().numpy(),
                          {k: v.grad.cpu().numpy() for k, v in p.items()})
    (img_g, dep_g, gr_g), (img_c, dep_c, gr_c) = outs["cuda"], outs["cpu"]
    if not (np.abs(img_g - img_c).max() < 1e-5 and np.abs(dep_g - dep_c).max() < 1e-4):
        fail("card render disagrees with the CPU render")
    grad_err = max(float(np.abs(gr_g[k] - gr_c[k]).max() / (np.abs(gr_c[k]).max() + 1e-8)) for k in gr_c)
    if not grad_err <= 1e-3:
        fail(f"card gradients disagree with the CPU gradients: {grad_err:.3e} of the largest")
    ref = render_np(scene, np.ones(n, bool), np.eye(3), np.zeros(3), intr)
    if not np.abs(img_g - ref["render"]).max() < 4e-3:
        fail("card render disagrees with the NumPy oracle")
    print(f"small-scene render: card == CPU (image {np.abs(img_g - img_c).max():.3e} of 1e-5, gradients "
          f"{grad_err:.3e} of each field's largest, of 1e-3) and NumPy oracle (4e-3) ok", flush=True)


def run_slam(device, frames: int):
    """Phase 3: the SLAM main path on the street scene."""
    import numpy as np
    import torch

    from lvdgs_torch.core.config import load_config
    from lvdgs_torch.eval.ate import eval_ate
    from lvdgs_torch.ops import rasterizer_cuda as rc
    from lvdgs_torch.slam.system import SLAM

    config = load_config(os.path.join(ROOT, "configs/mono/synthetic/street.yaml"))
    perf = config["Performance"]
    perf["packed_tracking_budget"] = 0
    perf["packed_mapping_budget"] = 0
    perf["synced_timers"] = True
    config["Training"]["mono_scale_servo"] = False
    config["Results"]["eval_rendering"] = True
    n_frames_full = config["Dataset"]["n_frames"]
    config["Dataset"]["n_frames"] = frames
    cal = config["Dataset"]["Calibration"]
    print(f"main path: street.yaml at {cal['width']}x{cal['height']}, max_per_tile "
          f"{perf['max_per_tile']}, map_capacity {perf['map_capacity']}, kf_capacity "
          f"{perf['kf_capacity']}, window_size {config['Training']['window_size']}, packed budgets 0, "
          f"mono_scale_servo False", flush=True)
    if frames != n_frames_full:
        print(f"cut: Dataset.n_frames {n_frames_full} -> {frames}", flush=True)

    slam = SLAM(config, save_dir=None, device=device)
    for w in rc.KERNEL_WRAPPERS:
        w.launches.reset()
    t0 = time.perf_counter()
    results = slam.run(progress=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches.count for w in rc.KERNEL_WRAPPERS}

    ate = eval_ate(slam.frames, slam.kf_indices, None, frames, final=True, monocular=True)
    n_after_init = len(slam.kf_indices) - 1
    print(f"main path: {results['n_frames']} frames, {results['n_keyframes']} keyframes "
          f"({n_after_init} after init), {slam.gmap.num_active} active Gaussians, "
          f"{results['fps']:.4f} fps ({wall:.1f} s), ATE RMSE {ate:.4f} m, "
          f"PSNR {results.get('mean_psnr', float('nan')):.3f} dB over "
          f"{results.get('n_eval_frames', 0)} frames", flush=True)
    for name, t in results["timers"].items():
        print(f"timer {name}: {t['total_s']:.3f} s total, {t['count']} calls, "
              f"{t['mean_ms']:.2f} ms mean", flush=True)
    print(f"launches on the main path: {json.dumps(launches)}", flush=True)

    if n_after_init < 2:
        fail(f"only {n_after_init} keyframes after init; the path needs at least 2")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was never launched on the main path")
    poses = np.stack([np.concatenate([np.ravel(f["R"]), np.ravel(f["T"])])
                      for f in slam.frames.values()])
    if not np.isfinite(poses).all():
        fail("non-finite pose")
    act = slam.gmap.active
    for k, v in slam.gmap.params().items():
        if not bool(torch.isfinite(v[act]).all()):
            fail(f"non-finite map field {k}")
    if not np.isfinite(ate):
        fail("non-finite ATE")
    return launches, slam


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=20, help="street frames to run")
    args = parser.parse_args()

    if not os.path.isdir(os.path.join(ROOT, "lvdgs_torch")):
        fail("lvdgs_torch/ not found next to chip_smoke.py: run from a checkout of the repo")
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    from lvdgs_torch.ops import rasterizer_cuda as rc

    t0 = time.perf_counter()
    rc.load_kernels()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    rc._library(fmad=True)
    print(f"kernels built with multiply-add contraction, for comparison, in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    ntx, nty, K = 77, 24, 256  # the street frame: 1226x370 in 16x16 tiles
    tp, counts = street_block(K, ntx * nty, ntx, seed=0, device=device)
    report = check_kernels(tp, counts, ntx, "random street-shaped slots")
    small_render_check(device)
    launches, slam = run_slam(device, args.frames)
    # the same checks on the slots the main path blends (printed only)
    check_kernels(*main_path_block(slam), "main-path slots")

    kernels = []
    for name, r in report.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "id": KERNEL_IDS[name], "status": "ported",
        })
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
