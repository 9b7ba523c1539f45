#!/usr/bin/env python3
"""Smoke test of the lvdgs_torch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which must pass:
1. build the CUDA kernels from lvdgs_torch/csrc with nvcc (one nvcc per
   source and build, all at once);
2. hold each kernel against its plain PyTorch version on the card at the
   street-scene shapes (1226x370 -> 77x24 = 1848 tiles, 256 slots per
   tile; packed: 116 groups of 16 tiles, NB = 348, 464 and 928 chunks for
   the tracking, mapping and probe budgets), and time both with CUDA
   events; show that the packed blend equals the dense one bit for bit
   where its budget does not bind; and check the card's render of a small
   scene against the CPU render and the NumPy oracle;
3. drive the SLAM loop (SLAM.run) on configs/mono/synthetic/street.yaml at
   full width twice: as configured (packed tracking at 96 and mapping at
   128 slots per tile, with saturation feedback), which must launch B1, B3,
   B4 and B5, and dense (budgets 0, as many frames), which must launch B1,
   B2 and B3; each must end with finite poses and map, at least 2
   keyframes after init, ATE RMSE < 0.08 m and PSNR > 17 dB; then hold the
   kernels against their plain versions again on the slots the packed run's
   final map gives from its newest keyframe;
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
    "packed_blend_forward": "lvdgs_tpu/ops/rasterizer_pallas.py:466",
    "packed_blend_backward": "lvdgs_tpu/ops/rasterizer_pallas.py:569",
}
# the TPU kernels' names in ROADMAP.md and PERF.md
KERNEL_IDS = {"blend_forward": "B1", "blend_backward": "B2", "median_depth": "B3",
              "packed_blend_forward": "B4", "packed_blend_backward": "B5"}
SOURCES = {"blend_forward": "lvdgs_torch/csrc/blend.cu", "blend_backward": "lvdgs_torch/csrc/blend.cu",
           "median_depth": "lvdgs_torch/csrc/blend.cu",
           "packed_blend_forward": "lvdgs_torch/csrc/blend_packed.cu",
           "packed_blend_backward": "lvdgs_torch/csrc/blend_packed.cu"}
# limits of the SLAM runs (tests/test_e2e_synthetic.py)
ATE_LIMIT, PSNR_LIMIT = 0.08, 17.0
TG = 16  # tiles per group of the packed layout


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
    scale = ref.abs().amax(dim=tuple(range(ref.dim() - 1)), keepdim=True) + 1e-12
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


def packed_from_dense(tp, counts, budget: int, sort_by_depth: bool, seed: int):
    """A packed block made by pack_bins from a dense (K, T, 10) block: the
    kernels' inputs [tp, cg, k0, goff, tids] and the number of groups. With
    `sort_by_depth` the tiles get random caps and depth-sorted grouping, as
    under saturation feedback; without, plain grouping, as the probe packs."""
    import torch
    from lvdgs_torch.ops import rasterizer as tr

    K, T, NF = tp.shape
    dev = tp.device
    C = K * T
    # fields row t * K + k is slot k of tile t
    fields = torch.cat([tp.permute(1, 0, 2).reshape(C, NF), tp.new_zeros(1, NF)])
    slot_valid = torch.arange(K, device=dev)[None] < counts[:, None].long()
    tile_idx = torch.where(slot_valid, torch.arange(C, device=dev).reshape(T, K), C)
    cap = None
    if sort_by_depth:
        g = torch.Generator(device=dev).manual_seed(seed)
        cap = torch.randint(0, K + 1, (T,), generator=g, device=dev, dtype=torch.int32)
    pb = tr.pack_bins(tile_idx, slot_valid, C, tile_group=TG, slot_budget_per_tile=budget,
                      tile_cap=cap, sort_by_depth=sort_by_depth)
    goff = torch.zeros(1, dtype=torch.int32, device=dev)
    return [tr._gather_rows(fields, pb.gid).contiguous(), pb.cg, pb.k0, goff, pb.tids], -(-T // TG)


def packed_marched_slots(args, G: int, ntx: int) -> int:
    """(tile, slot) pairs the packed kernels march under the shared stop
    rule."""
    import torch
    from lvdgs_torch.ops import rasterizer_cuda as rc

    tp, cg, _k0, goff, tids = args
    start, nch, px, py = rc._packed_tiles(tp, cg, goff, tids, G, ntx)
    state = {"trans": torch.ones(px.shape, device=tp.device)}
    acc = torch.zeros((px.shape[0], 4, rc.P), device=tp.device)
    total = torch.zeros((), dtype=torch.int64, device=tp.device)
    for alive, b, _has, kc in rc._packed_slots(tp, start, nch, lambda: state["trans"]):
        total += alive.sum()
        p = tp[b, kc].reshape(-1, rc.NF)
        _w, state["trans"], acc = rc._slot_forward(p, px, py, alive, state["trans"], acc)
    return int(total)


def check_packed(args, G: int, ntx: int, label: str, timing: bool = True) -> dict:
    """B4 (with touch counts, without, and as the probe) and B5 against their
    plain versions on one packed block, with a random cotangent for B5;
    then each timed against its plain version, and against the build with
    multiply-add contraction."""
    import torch
    from lvdgs_torch.ops import rasterizer_cuda as rc

    tp, cg, k0, goff, tids = args
    NB, _, tg, _ = tp.shape
    dev = tp.device
    marched = packed_marched_slots(args, G, ntx)
    g = torch.Generator(device=dev).manual_seed(1)
    acc, trans, _ = rc.packed_blend_forward(*args, G, ntx, with_nt=False)
    dacc = torch.randn(acc.shape, generator=g, device=dev)
    dtrans = torch.randn(trans.shape, generator=g, device=dev)
    out_bytes = (acc.numel() + trans.numel()) * 4
    idx_bytes = (cg.numel() + tids.numel() + 1) * 4
    cases = {
        "B4 with_nt": (rc.packed_blend_forward, rc.packed_blend_forward_plain,
                       dict(with_nt=True), (), OPS_FWD, out_bytes + NB * rc.KC * tg * 4),
        "B4 no_nt": (rc.packed_blend_forward, rc.packed_blend_forward_plain,
                     dict(with_nt=False), (), OPS_FWD, out_bytes + NB * rc.KC * tg * 4),
        "B4 probe_wmax": (rc.packed_blend_forward, rc.packed_blend_forward_plain,
                          dict(probe_wmax=True), (), OPS_FWD, out_bytes + NB * rc.KC * tg * 4),
        "B5": (rc.packed_blend_backward, rc.packed_blend_backward_plain, {},
               (acc, trans, dacc, dtrans), OPS_BWD, 2 * out_bytes + NB * rc.KC * tg * rc.NF * 4),
    }
    report = {}
    for case, (wrapper, plain, kw, extra, ops, io_bytes) in cases.items():
        call_args = (*args, *extra, G, ntx)
        out = wrapper(*call_args, **kw)
        ref = plain(*call_args, **kw)
        torch.cuda.synchronize()
        if case == "B5":
            err = errors("blend_backward", out, ref)
            ok = err[1] <= 1e-5
            what = "of each field's largest gradient"
        else:
            err = errors("blend_forward", out[:2], ref[:2])
            nt_equal = bool(torch.equal(out[2], ref[2]))
            ok = err[1] <= 1e-5 and nt_equal
            what = f"absolute, per-slot {'weights' if 'probe' in case else 'counts'} equal: {nt_equal}"
        print(f"kernel {case} [{label}, NB {NB}]: max_abs_err {err[0]:.3e}, error {err[1]:.3e} against a "
              f"tolerance of 1e-05 ({what}) {'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            fail(f"{case} disagrees with its plain version on {label}")
        r = {"max_abs_err": err[0]}
        if timing:
            r["ms"] = time_ms(lambda: wrapper(*call_args, **kw), reps=10, inner=20)
            r["plain_ms"] = time_ms(lambda: plain(*call_args, **kw), reps=5, warmup=1)
            r["bound_ms"], r["bound_by"] = bound_ms(marched * rc.NF * 4 + idx_bytes + io_bytes,
                                                    marched * rc.P * ops)
            # the contracted build, on the same inputs, in turns with the shipped one
            fmad = rc._library(fmad=True)
            outs = [torch.empty_like(o) for o in (out if isinstance(out, tuple) else (out,))]
            ptrs = [x.data_ptr() for x in (tp, cg, tids, goff, *extra, *outs)]
            if case == "B5":
                def call():
                    rc._check_launch(fmad.lvdgs_packed_bwd(*ptrs, NB, G, tg, ntx, rc._stream()), case)
            else:
                mode = 2 if "probe" in case else (1 if kw.get("with_nt") else 0)

                def call():
                    rc._check_launch(fmad.lvdgs_packed_fwd(*ptrs, NB, G, tg, ntx, mode, rc._stream()),
                                     case)
            call()
            torch.cuda.synchronize()
            if case == "B5":
                fmad_err = errors("blend_backward", outs[0], ref)[1]
            else:
                fmad_err = errors("blend_forward", outs[:2], ref[:2])[1]
            fmad_ms = time_ms(call, reps=10, inner=20)
            again_ms = time_ms(lambda: wrapper(*call_args, **kw), reps=10, inner=20)
            print(f"kernel {case} [{label}, NB {NB}]: {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {marched} tile-slots marched); with "
                  f"multiply-add contraction {fmad_ms:.4f} ms against {r['ms']:.4f} / {again_ms:.4f} ms "
                  f"as shipped, error {fmad_err:.3e}", flush=True)
        report[case] = r
    return report


def check_packed_equals_dense(tp, counts, ntx: int) -> None:
    """With plain grouping and a budget that does not bind, the packed
    blend holds the dense lists' slots in the same order: its acc and trans
    must equal B1's bit for bit."""
    import torch
    from lvdgs_torch.ops import rasterizer_cuda as rc

    K = tp.shape[0]
    args, G = packed_from_dense(tp, counts, K, sort_by_depth=False, seed=0)
    acc_p, trans_p, _ = rc.packed_blend_forward(*args, G, ntx, with_nt=False)
    acc_d, trans_d, _ = rc.blend_forward(tp, counts, ntx)
    T = tp.shape[1]
    same = (torch.equal(rc._from_group_major(acc_p, G)[:T], acc_d)
            and torch.equal(rc._from_group_major(trans_p, G)[:T], trans_d))
    print(f"B4 (budget {K}, plain grouping, NB {args[0].shape[0]}) against B1 on the same slots: "
          f"{'equal bit for bit' if same else 'DIFFERENT'}", flush=True)
    if not same:
        fail("B4 with a budget that does not bind differs from B1")


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
    kernels) and the NumPy oracle, values and gradients, dense and packed
    with saturation feedback."""
    import dataclasses

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from reference_rasterizer import render_np

    from lvdgs_torch.core.camera import Intrinsics
    from lvdgs_torch.ops.rasterizer import RenderConfig, rasterize

    intr = Intrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
    dense = RenderConfig(max_per_tile=64, tile_chunk=16)
    rng = np.random.default_rng(0)
    n = 100
    scene = {
        "means": np.concatenate([rng.normal(size=(n, 2)) * 1.2, rng.uniform(2, 6, (n, 1))], 1),
        "features_dc": rng.normal(size=(n, 3)) * 0.5,
        "log_scales": rng.uniform(-2.5, -1.0, (n, 3)),
        "quats": rng.normal(size=(n, 4)),
        "logit_opacities": rng.uniform(-1.0, 2.5, n),
    }
    ref = render_np(scene, np.ones(n, bool), np.eye(3), np.zeros(3), intr)
    packed = dataclasses.replace(dense, tile_group=4, use_packed=True, slot_budget_per_tile=64,
                                 saturation_feedback=True)
    for name, cfg in (("dense", dense), ("packed, feedback", packed)):
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
            fail(f"card render ({name}) disagrees with the CPU render")
        grad_err = max(float(np.abs(gr_g[k] - gr_c[k]).max() / (np.abs(gr_c[k]).max() + 1e-8))
                       for k in gr_c)
        if not grad_err <= 1e-3:
            fail(f"card gradients ({name}) disagree with the CPU gradients: {grad_err:.3e} of the largest")
        if not np.abs(img_g - ref["render"]).max() < 4e-3:
            fail(f"card render ({name}) disagrees with the NumPy oracle")
        print(f"small-scene render ({name}): card == CPU (image {np.abs(img_g - img_c).max():.3e} of "
              f"1e-5, gradients {grad_err:.3e} of each field's largest, of 1e-3) and NumPy oracle "
              f"(4e-3) ok", flush=True)


def run_slam(device, frames: int, packed: bool):
    """Phase 3: the SLAM main path on the street scene, as configured
    (packed) or with both packed budgets at 0 (dense)."""
    import numpy as np
    import torch

    from lvdgs_torch.core.config import load_config
    from lvdgs_torch.eval.ate import eval_ate
    from lvdgs_torch.ops import rasterizer_cuda as rc
    from lvdgs_torch.slam.system import SLAM

    label = "packed" if packed else "dense"
    config = load_config(os.path.join(ROOT, "configs/mono/synthetic/street.yaml"))
    perf = config["Performance"]
    if not packed:
        perf["packed_tracking_budget"] = 0
        perf["packed_mapping_budget"] = 0
    perf["synced_timers"] = True
    config["Training"]["mono_scale_servo"] = False
    config["Results"]["eval_rendering"] = True
    n_frames_full = config["Dataset"]["n_frames"]
    config["Dataset"]["n_frames"] = frames
    cal = config["Dataset"]["Calibration"]
    slam = SLAM(config, save_dir=None, device=device)
    budgets = (f"tracking {slam.rcfg_track.slot_budget_per_tile} (feedback "
               f"{slam.rcfg_track.saturation_feedback}), mapping {slam.rcfg_map.slot_budget_per_tile} "
               f"(feedback {slam.rcfg_map.saturation_feedback})" if packed else "0")
    print(f"{label} path: street.yaml at {cal['width']}x{cal['height']}, max_per_tile "
          f"{perf['max_per_tile']}, map_capacity {perf['map_capacity']}, kf_capacity "
          f"{perf['kf_capacity']}, window_size {config['Training']['window_size']}, packed budgets "
          f"{budgets}, mono_scale_servo False", flush=True)
    if packed != slam.rcfg_track.use_packed or packed != slam.rcfg_map.use_packed:
        fail(f"the {label} run does not render as asked")
    if frames != n_frames_full:
        print(f"cut: Dataset.n_frames {n_frames_full} -> {frames}", flush=True)

    for w in rc.KERNEL_WRAPPERS:
        w.launches.reset()
    t0 = time.perf_counter()
    results = slam.run(progress=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches.count for w in rc.KERNEL_WRAPPERS}

    ate = eval_ate(slam.frames, slam.kf_indices, None, frames, final=True, monocular=True)
    psnr = results.get("mean_psnr", float("nan"))
    n_after_init = len(slam.kf_indices) - 1
    print(f"{label} path: {results['n_frames']} frames, {results['n_keyframes']} keyframes "
          f"({n_after_init} after init), {slam.gmap.num_active} active Gaussians, "
          f"{results['fps']:.4f} fps ({wall:.1f} s), ATE RMSE {ate:.4f} m, "
          f"PSNR {psnr:.3f} dB over {results.get('n_eval_frames', 0)} frames", flush=True)
    for name, t in results["timers"].items():
        print(f"{label} timer {name}: {t['total_s']:.3f} s total, {t['count']} calls, "
              f"{t['mean_ms']:.2f} ms mean", flush=True)
    print(f"launches on the {label} path: {json.dumps(launches)}", flush=True)

    if n_after_init < 2:
        fail(f"{label} path: only {n_after_init} keyframes after init; the path needs at least 2")
    must = (("blend_forward", "median_depth", "packed_blend_forward", "packed_blend_backward") if packed
            else ("blend_forward", "blend_backward", "median_depth"))
    for name in must:
        if launches[name] == 0:
            fail(f"kernel {name} was never launched on the {label} path")
    poses = np.stack([np.concatenate([np.ravel(f["R"]), np.ravel(f["T"])])
                      for f in slam.frames.values()])
    if not np.isfinite(poses).all():
        fail(f"{label} path: non-finite pose")
    act = slam.gmap.active
    for k, v in slam.gmap.params().items():
        if not bool(torch.isfinite(v[act]).all()):
            fail(f"{label} path: non-finite map field {k}")
    if not ate < ATE_LIMIT:
        fail(f"{label} path: ATE RMSE {ate:.4f} m is not below {ATE_LIMIT}")
    if not psnr > PSNR_LIMIT:
        fail(f"{label} path: PSNR {psnr:.3f} dB is not above {PSNR_LIMIT}")
    return launches, slam


def check_default_budgets(device) -> None:
    """A config with no budget keys renders packed on the card, as the
    reference does off the CPU: tracking at 96, mapping at 128, both with
    saturation feedback; the exact renders dense."""
    from lvdgs_torch.core.config import load_config
    from lvdgs_torch.slam.system import SLAM

    config = load_config(os.path.join(ROOT, "configs/mono/synthetic/base_config.yaml"))
    if any("budget" in k or "feedback" in k for k in config.get("Performance", {})):
        fail("base_config.yaml sets a packed budget; the default check needs a config without")
    slam = SLAM(config, save_dir=None, device=device)
    t, m = slam.rcfg_track, slam.rcfg_map
    ok = (t.use_packed and t.slot_budget_per_tile == 96 and t.saturation_feedback
          and m.use_packed and m.slot_budget_per_tile == 128 and m.saturation_feedback
          and not slam.rcfg.use_packed)
    def describe(cfg):
        return (f"packed at {cfg.slot_budget_per_tile}, feedback {cfg.saturation_feedback}"
                if cfg.use_packed else "dense")

    print(f"defaults on {device.type} (base_config.yaml, no budget keys): tracking {describe(t)}, "
          f"mapping {describe(m)}, exact renders {describe(slam.rcfg)} {'ok' if ok else 'WRONG'}",
          flush=True)
    if not ok:
        fail("SLAM's packed defaults on the card are not 96/128 with feedback")


def main_path_packed_blocks(slam):
    """The packed blocks the main path blends at its end: the final map seen
    from the newest keyframe, packed as tracking, as mapping and as the
    feedback probe packs it."""
    import torch
    from lvdgs_torch.ops import rasterizer as tr

    p, active = slam.gmap.params(), slam.gmap.active
    slot = slam.kf_slots[slam.kf_indices[-1]]
    R, T = slam.kfbuf.R[slot], slam.kfbuf.T[slot]
    ntx, nty = slam.rcfg.grid(slam.intr)
    proj = tr.project_gaussians(p["means"], p["quats"], p["log_scales"], active, R, T, slam.intr)
    colors, opac = tr._blend_inputs(p, active)
    fields = tr._fields(proj["mean2d"], proj["conic"], colors, opac, proj["depth"])
    goff = torch.zeros(1, dtype=torch.int32, device=fields.device)
    G = -(-ntx * nty // slam.rcfg_map.tile_group)
    blocks = []
    for name, cfg in (("tracking", slam.rcfg_track), ("mapping", slam.rcfg_map)):
        pb = tr.prepare_bins(p, active, R, T, slam.intr, cfg)
        blocks.append((name, [tr._gather_rows(fields, pb.gid).contiguous(), pb.cg, pb.k0, goff, pb.tids]))
    tile_idx, slot_valid = tr._bin_for(proj, slam.rcfg, ntx, nty)
    pb = tr.pack_bins(tile_idx, slot_valid, p["means"].shape[0], tile_group=slam.rcfg.tile_group,
                      slot_budget_per_tile=slam.rcfg.max_per_tile)
    blocks.append(("probe", [tr._gather_rows(fields, pb.gid).contiguous(), pb.cg, pb.k0, goff, pb.tids]))
    return blocks, G, ntx


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=20, help="street frames of the packed run")
    parser.add_argument("--dense-frames", type=int, default=20,
                        help="street frames of the dense run (11 give only 1 keyframe after init)")
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

    from concurrent.futures import ThreadPoolExecutor

    from lvdgs_torch.ops import rasterizer_cuda as rc

    # phase 1: every source, shipped and contracted, by one nvcc each, at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(rc.build_libraries, (False, True)))
    rc.load_kernels()
    rc._library(fmad=True)
    print(f"kernels built (shipped and with multiply-add contraction) and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # phase 2
    ntx, nty, K = 77, 24, 256  # the street frame: 1226x370 in 16x16 tiles
    tp, counts = street_block(K, ntx * nty, ntx, seed=0, device=device)
    report = check_kernels(tp, counts, ntx, "random street-shaped slots")
    packed_report = {}
    for budget, sort in ((96, True), (128, True), (256, False)):
        pargs, G = packed_from_dense(tp, counts, budget, sort, seed=budget)
        label = f"random street-shaped slots, budget {budget}, {'sorted with caps' if sort else 'plain'}"
        packed_report[budget] = check_packed(pargs, G, ntx, label)
    check_packed_equals_dense(tp, counts, ntx)
    small_render_check(device)

    # phase 3
    check_default_budgets(device)
    launches = {}
    for packed, frames in ((True, args.frames), (False, args.dense_frames)):
        run_launches, slam = run_slam(device, frames, packed)
        for name, n in run_launches.items():
            launches[name] = launches.get(name, 0) + n
        if packed:
            packed_slam = slam
    # the same checks on the slots the packed path blends (printed only)
    check_kernels(*main_path_block(packed_slam), "main-path slots")
    blocks, G, bntx = main_path_packed_blocks(packed_slam)
    for name, pargs in blocks:
        check_packed(pargs, G, bntx, f"main-path slots, {name}", timing=(name == "tracking"))
    del packed_slam

    # B4 and B5 in the JSON line: the tracking budget's shape (NB 348), B4
    # without touch counts, as tracking and mapping launch it
    track = packed_report[96]
    report["packed_blend_forward"] = track["B4 no_nt"]
    report["packed_blend_backward"] = track["B5"]
    kernels = []
    for name, r in report.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
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
