#!/usr/bin/env python3
"""Smoke test of the lvdgs_torch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which must pass:
1. build the CUDA kernels from lvdgs_torch/csrc with nvcc (one nvcc per
   source and build, all at once: blend.cu, blend_packed.cu, resident.cu),
   and print each kernel's registers, local (spill) bytes, static shared
   memory and blocks per SM, and nvcc's -Xptxas -v report of
   blend_packed.cu;
2. hold each kernel against its plain PyTorch version on the card at the
   street-scene shapes (1226x370 -> 77x24 = 1848 tiles, 256 slots per
   tile; packed: 116 groups of 16 tiles, NB = 348, 464 and 928 chunks for
   the tracking, mapping and probe budgets; the bf16 packed kernels at NB
   348 and 464, and against the float32 ones at the reference's bar), and
   the resident-table kernels at the probe tool's shapes (2^17 rows, 1848
   tiles in groups of 8, 256 slots) and R2 at its edge shapes (one row
   taking every slot, counts that end inside a thread's or a block's
   share, no group), and time each with CUDA events beside its plain
   version (and, for the resident kernels, the library call that computes
   the same function): each kernel through its wrapper (ms, as a caller
   launches it) and straight from its library on preallocated outputs
   (kernel_ms, without the wrapper's host time; the few-microsecond
   kernels R1, R2 and B3, and the resident library calls, also from a
   CUDA graph, graph_ms, without the host's launch, and R2's zero and
   scatter passes each alone that way); each blend
   forward's (dense and packed) march lengths and touch counts must equal
   its plain version's, and each blend backward and the median launched
   twice on the same inputs must give the same bits; show that the packed
   blend equals the dense one bit for bit where its budget does not bind;
   and check the card's render of a small scene against the CPU render and
   the NumPy oracle;
3. drive the SLAM loop (SLAM.run) on configs/mono/synthetic/street.yaml at
   full width four times: as configured (packed tracking at 96 and mapping
   at 128 slots per tile, with saturation feedback), which must launch B1,
   B3, B4 and B5; with Performance.blend_bf16 (--bf16-frames, 15), which
   must launch B4-bf16 and B5-bf16 and no float32 B5; dense (budgets 0;
   --dense-frames, 14), which must launch B1, B2 and B3; and as configured
   with Training.track_pyramid (--pyramid-frames, 15), which must launch
   B1 and B3, and B4 and B5 in both tracking stages (told apart by their
   launch shapes: the coarse stage blends 613x185 in 468 tiles, 30 groups,
   at 192 slots per tile, NB 180); each must end with finite poses and map,
   at least 2 keyframes after init, ATE RMSE < 0.08 m and PSNR > 17 dB;
   the first, as configured, also saves its results with the GUI feed
   (every tracked frame), the depth comparisons and the eval panels on,
   and must write the reference's files, one per frame (a); its state,
   saved, goes through python -m lvdgs_torch.tools.colmap_export with
   oracle keyframe matches, and the database must hold the run (b);
   right after the pyramid run, hold B4 (with touch counts, without, and
   as the probe) and B5 against their plain versions at the coarse stage's
   pack of its final map from the newest keyframe, and time them; the
   tracking and mapping renders of these runs bin the active prefix of
   the depth sort (the bucket, on by default on the card), whose value at
   each update is printed; then the dynamic street, stopped and resumed;
   then the detector phase: GroundingDINO (Swin-T, BERT-base, 6+6 layers,
   900 queries) and SAM (ViT-B) at full width with random weights, saved
   in the official layouts and loaded through build_masker onto the card
   (and onto the CPU), one detector forward and one segmenter call on
   street frame 0 held against the CPU and timed, then the dynamic street
   (--detector-frames, 10) on that masker, handed the detector's
   first-ranked box a frame, with no hook call raising, some frame's model
   mask kept by the failsafe, a keyframe after init, B1, B3, B4 and B5
   launched, and its ATE and PSNRs printed only;
   then the MASt3R prior path: street.yaml with make_fused_priors and
   make_scale_remedy over OracleMASt3R(depth_scale=0.9) and global BA,
   held to ATE < 0.5 m and PSNR > 17 dB after global BA, with PnP
   succeeding on at least half of the tracked frames, which must launch
   B1, B3, B4 and B5; B3 held at the network's 32x9 tiles on its final
   map; the full-width MASt3R network with random weights, saved in the
   official checkpoint's layout and loaded back onto the card and the
   CPU, its fused forward on two street frames at 512x144 held against
   the CPU and against the two unfused forwards, and its fused priors run
   once on the card (B3 at 32x9); between the two, MASt3R's cloud
   optimisation on the prior run's keyframes at 512x144 from the oracle's
   depths and matches (sparse global alignment, 500 + 500 Adam steps,
   held to tests/test_cloud_opt.py's bars; its first 20 steps against the
   CPU; one TSDF refinement pass) (c); after the network, coarse-to-fine
   matching with it on two full-resolution street frames (d), and DINOv2
   (ViT-B/14, random weights in the torch.hub layout) on street frame 0 at
   1218x364 against the CPU (e); one binning call of the packed run's
   final map with the bucket and without, equal bins, both timed; then
   hold the kernels against their plain versions again on the slots the
   packed and the
   dense run's final maps give from their newest keyframes (B1-B3 on both,
   timed beside the random block's), and the packed run's bf16 renders
   against the float32 ones from every keyframe by the reference's own
   measure (image and parameter gradients), and the gather's transpose on
   them against index_select's (its own sum must repeat bit for bit); then
   the multi-device paths (f): B4 and B5 (float32 and bf16, with and without
   touch counts) held against their plain versions and timed at the
   street's tile-sharded layout (2 ranks of 12 tile rows of an 80-tile-wide
   padded grid: the second block at tile offset goff 960), NCCL's
   all_reduce, all_gather_into_tensor and reduce_scatter_tensor at world
   size 1 (two NCCL ranks cannot share the card), then 2 gloo ranks on the
   card (lvdgs_torch.parallel.launch): (f1) track_camera_sharded from the
   packed run's final state against track_camera, (f2) a 4-iteration
   camera-DP mapping_run over its window against mapping_run, (f3) the
   sharded mapping step at meshes (2, 1) and (1, 2) against (1, 1), each
   at the reference's tolerances (tests/test_parallel.py; (f1)'s image at
   all but a 1e-5 share of its values, every value within 2/255) and
   equal across the ranks bit for bit, and (f4) SLAM.run with Performance.data_parallel
   on --parallel-frames (11) street frames: both ranks' maps and poses bit
   for bit equal, ATE < 0.08 m, PSNR > 17 dB, at least 2 keyframes after
   init, B4 and B5 launched at the sharded pack's shape (NB 180, 60
   groups), each rank's wall time and launches printed; then
   drive the float32 street run once more with the bucket off
   (Performance.bin_active_bucket: False) and without the feed and the
   panels, which must end with the first run's map and poses bit for bit; then drive the resident-table probe
   (python -m lvdgs_torch.tools.perf_resident), which must launch R1 and R2;
4. print the per-kernel JSON line (B4 and B5 also at the coarse pack, under
   their own names, with the coarse stage's launches; the launches count
   (f4)'s, both ranks'), then the result line.

Each phase's seconds are printed as it ends ("phase <name>: <s> s").

Exits non-zero, printing no result, when CUDA is unavailable, when run
outside a checkout, or when any phase fails.

    python3 chip_smoke.py --deterministic-street FILE [--dense] [--against OTHER]

runs only the float32 packed street run (with --dense, the dense one, which
goes through B1 and B2), under deterministic algorithms, writes its final
map and poses to FILE and compares them bit for bit with OTHER, written the
same way by another checkout: the test that a kernel change computes what
its parent computed.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# FP32 operations per (pixel, marched slot), counted from the kernel source
# (blend.cu): alpha = 16 (2 sub, 9 mul/add for the conic power, exp, the
# opacity product, 3 compares/min), then per kernel:
OPS_FWD = 16 + 1 + 8 + 2  # weight, 4 colour/depth multiply-adds, transmittance
OPS_BWD = 16 + 1 + 8 + 2 + 30 + 4 + 25 + 10  # + dL/dalpha, gates, 10 grads, reductions
OPS_MED = 16 + 2 + 2  # transmittance, crossing test
# the bf16 variants do the alpha's 16 operations and 2 more subtractions
# (tile-local coordinates) in bfloat16, counted at the card's bf16 rate
# outside the tensor cores, and the rest of each kernel in FP32. The 19
# roundings per pixel and slot with which this design emulates bf16
# arithmetic (blend_common.cuh, eval_slot_bf16) belong to the design, not
# to the function, and are not counted.
OPS_ALPHA = 16
OPS_BF16_WEIGHT = OPS_ALPHA + 2

# each kernel's pallas_call site
_PALLAS = "lvdgs_tpu/ops/rasterizer_pallas.py"
REPLACES = {
    "blend_forward": f"{_PALLAS}:247",
    "blend_backward": f"{_PALLAS}:292",
    "median_depth": f"{_PALLAS}:375",
    "packed_blend_forward": f"{_PALLAS}:730",
    "packed_blend_backward": f"{_PALLAS}:780",
    "packed_blend_forward_bf16": f"{_PALLAS}:730",
    "packed_blend_backward_bf16": f"{_PALLAS}:780",
    "resident_gather": "tools/perf_resident.py:71",
    "resident_scatter": "tools/perf_resident.py:100",
}
# the TPU kernels' names in ROADMAP.md and PERF.md
KERNEL_IDS = {"blend_forward": "B1", "blend_backward": "B2", "median_depth": "B3",
              "packed_blend_forward": "B4", "packed_blend_backward": "B5",
              "packed_blend_forward_bf16": "B4-bf16", "packed_blend_backward_bf16": "B5-bf16",
              "resident_gather": "R1", "resident_scatter": "R2"}
_CSRC = "lvdgs_torch/csrc"
SOURCES = {"blend_forward": f"{_CSRC}/blend.cu", "blend_backward": f"{_CSRC}/blend.cu",
           "median_depth": f"{_CSRC}/blend.cu",
           "packed_blend_forward": f"{_CSRC}/blend_packed.cu",
           "packed_blend_backward": f"{_CSRC}/blend_packed.cu",
           "packed_blend_forward_bf16": f"{_CSRC}/blend_packed.cu",
           "packed_blend_backward_bf16": f"{_CSRC}/blend_packed.cu",
           "resident_gather": f"{_CSRC}/resident.cu", "resident_scatter": f"{_CSRC}/resident.cu"}
# the reference's bar for bf16 weight math against float32
# (tests/test_rasterizer_pallas.py::test_blend_bf16_close_to_f32)
BF16_PIXEL_ERR, BF16_PSNR, BF16_GRAD_COS = 0.02, 45.0, 0.999
# limits of the SLAM runs (tests/test_e2e_synthetic.py)
ATE_LIMIT, PSNR_LIMIT = 0.08, 17.0
# the prior path's ATE bar (tests/test_oracle_prior.py), held with PSNR_LIMIT
PRIOR_ATE_LIMIT = 0.5
# the full-width MASt3R on the card against its CPU self and its unfused
# forwards: float32 with TF32 off, in other summation orders through 36
# transformer blocks; the raw head map relative to its largest magnitude,
# the unit descriptors absolute
NET_RAW_TOL, NET_DESC_TOL = 1e-4, 1e-3
# GroundingDINO and SAM on the card against their CPU selves: float32 with
# TF32 off, in other summation orders through Swin-T, BERT and 12
# transformer layers, or ViT-B and the two-way decoder; each raw output
# relative to its largest magnitude (NET_RAW_TOL's measure)
DETECTOR_TOL = 1e-4
# the GT-mask render's pixels this close to the 0.5 coverage or opacity
# threshold may flip between B1 and its plain version
MASK_EDGE = 1e-5
# the gather transpose against index_add_: both sum each Gaussian's slot
# gradients in float32, in other orders
GATHER_TOL = 1e-5
# each kernel's function in the libraries (rasterizer_cuda.kernel_attrs)
ATTRS = {"blend_forward": "blend_fwd_kernel", "blend_backward": "blend_bwd_kernel",
         "median_depth": "median_depth_kernel",
         # B4 and B4-bf16 as the main path launches them: without touch counts
         "packed_blend_forward": "packed_fwd_kernel<false, NT_NONE>",
         "packed_blend_backward": "packed_bwd_kernel<false>",
         "packed_blend_forward_bf16": "packed_fwd_kernel<true, NT_NONE>",
         "packed_blend_backward_bf16": "packed_bwd_kernel<true>",
         "resident_gather": "resident_gather_kernel", "resident_scatter": "resident_scatter_kernel"}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


class Phases:
    """Prints each phase's seconds as it ends."""

    def __init__(self) -> None:
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.1f} s", flush=True)
        self.t = now


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
    with a random cotangent for the backward (B1's touch counts and march
    lengths equal, B2 and B3 launched twice equal bits); then both timed,
    and the kernels timed again as built with multiply-add contraction."""
    import torch
    from lvdgs_torch.ops import rasterizer_cuda as rc
    from lvdgs_torch.tools.timing import bound_ms, graph_ms, time_ms

    K, T, _ = tp.shape
    g = torch.Generator(device=tp.device).manual_seed(1)
    dacc = torch.randn((T, 4, rc.P), generator=g, device=tp.device)
    dtrans = torch.randn((T, rc.P), generator=g, device=tp.device)
    # the kernels read only the slots they march, so the bound counts those
    # slots' 40 bytes, not the whole (K, T, 10) block, plus the counts and
    # io_bytes: the other inputs read once and the outputs written once
    marched = {thr: marched_slots(tp, counts, ntx, thr) for thr in (rc.T_EPS, 0.5)}
    acc, trans, nt, march = rc.blend_forward(tp, counts, ntx)
    report = {
        "blend_forward": dict(args=(tp, counts, ntx), plain=rc.blend_forward_plain,
                              wrapper=rc.blend_forward, threshold=rc.T_EPS, ops=OPS_FWD, tol=1e-5,
                              io_bytes=(acc.numel() + trans.numel() + nt.numel() + T) * 4),
        # the tolerance is 1e-5 of each field's largest gradient; B2 takes
        # B1's march lengths, its plain version applies the stop rule
        "blend_backward": dict(args=(tp, counts, march, acc, trans, dacc, dtrans, ntx),
                               plain=lambda tp, counts, march, *rest: rc.blend_backward_plain(
                                   tp, counts, *rest, march=march),
                               wrapper=rc.blend_backward, threshold=rc.T_EPS, ops=OPS_BWD, tol=1e-5,
                               io_bytes=(T + acc.numel() + trans.numel() + dacc.numel()
                                         + dtrans.numel() + K * T * rc.NF) * 4),
        "median_depth": dict(args=(tp, counts, ntx), plain=rc.median_depth_plain,
                             wrapper=rc.median_depth, threshold=0.5, ops=OPS_MED, tol=1e-5,
                             io_bytes=2 * T * rc.P * 4),
    }
    entry = {"blend_forward": "lvdgs_blend_fwd", "blend_backward": "lvdgs_blend_bwd",
             "median_depth": "lvdgs_median_depth"}
    for name, r in report.items():
        args = r["args"]
        out = r["wrapper"](*args)
        ref = r["plain"](*args)
        torch.cuda.synchronize()
        r["max_abs_err"], err = errors(name, out, ref)
        ok = err <= r["tol"]
        what = "of each field's largest gradient" if name == "blend_backward" else "absolute"
        if name == "blend_forward":
            # touch counts and march lengths are integers: equal or wrong
            same = {k: bool(torch.equal(out[i], ref[i])) for i, k in ((2, "counts"), (3, "march"))}
            ok = ok and all(same.values())
            what += f"; touch counts equal: {same['counts']}, march lengths equal: {same['march']}"
        elif name in ("blend_backward", "median_depth"):
            # the backward's per-slot sums run in a fixed order, and the
            # median's warps meet at a barrier per chunk: launched again, the
            # same bits
            again = r["wrapper"](*args)
            repeats = (all(torch.equal(a, b) for a, b in zip(again, out)) if isinstance(out, tuple)
                       else bool(torch.equal(again, out)))
            ok = ok and repeats
            what += f"; launched twice, equal bits: {repeats}"
        print(f"kernel {name} [{label}]: max_abs_err {r['max_abs_err']:.3e}, error {err:.3e} against a "
              f"tolerance of {r['tol']:.0e} ({what}) {'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version")
        # the shipped build and the one built with contraction, launched
        # straight from their libraries on the same inputs and on outputs of
        # the same shapes (no wrapper on the host between launches), in turns
        outs = [torch.empty_like(o) for o in (out if isinstance(out, tuple) else (out,))]
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        ptrs = [x.data_ptr() for x in (*ins, *outs)]
        shipped, fmad = (getattr(rc._library(fmad=f), entry[name]) for f in (False, True))

        def call(fn, ptrs=ptrs, name=name):
            rc._check_launch(fn(*ptrs, K, T, ntx, rc._stream()), name)

        call(fmad)
        torch.cuda.synchronize()
        fmad_err = errors(name, outs if len(outs) > 1 else outs[0], ref)[1]
        # ms through the wrapper, as a caller launches the kernel; kernel_ms
        # straight from the library, without the wrapper's host time
        r["ms"] = time_ms(lambda: r["wrapper"](*args), reps=10, inner=20)
        r["kernel_ms"] = time_ms(lambda: call(shipped), reps=10, inner=20)
        graph = ""
        if name == "median_depth":
            # a launch of a few microseconds also waits on the host's launch
            # from Python; from a CUDA graph, it does not
            r["graph_ms"] = graph_ms(lambda: call(shipped))
            graph = f", {r['graph_ms']:.4f} from a CUDA graph"
        fmad_ms = time_ms(lambda: call(fmad), reps=10, inner=20)
        again_ms = time_ms(lambda: call(shipped), reps=10, inner=20)
        r["plain_ms"] = time_ms(lambda: r["plain"](*args), reps=10, warmup=1)
        m = marched[r["threshold"]]
        r["bound_ms"], r["bound_by"] = bound_ms(m * rc.NF * 4 + T * 4 + r["io_bytes"], m * rc.P * r["ops"])
        print(f"kernel {name} [{label}]: {r['ms']:.4f} ms through the wrapper ({r['kernel_ms']:.4f} "
              f"straight from the library{graph}), plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {m} tile-slots marched)", flush=True)
        print(f"kernel {name} [{label}]: with multiply-add contraction {fmad_ms:.4f} ms against "
              f"{r['kernel_ms']:.4f} / {again_ms:.4f} ms as shipped (-fmad=false), straight from the "
              f"libraries, error {fmad_err:.3e} ({what})", flush=True)
    return report


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


def check_packed(args, G: int, ntx: int, label: str, timing: bool = True, bf16: bool = True,
                 bf16_gate: bool = True) -> dict:
    """B4 (with touch counts, without, and as the probe) and B5 against their
    plain versions on one packed block, with a random cotangent for B5, and
    (`bf16`) B4-bf16 (with and without counts) and B5-bf16 against theirs,
    bit for bit and within 1e-5 of each field's largest gradient; then each
    timed against its plain version, and against the build with
    multiply-add contraction; then the bf16 kernels against the float32
    ones on the block's slots (held to the reference's bar with
    `bf16_gate`, else printed only)."""
    import torch
    from lvdgs_torch.ops import rasterizer_cuda as rc
    from lvdgs_torch.tools.timing import bound_ms, time_ms

    tp, cg, k0, goff, tids = args
    NB, _, tg, _ = tp.shape
    dev = tp.device
    marched = packed_marched_slots(args, G, ntx)
    g = torch.Generator(device=dev).manual_seed(1)
    acc, trans, _, march = rc.packed_blend_forward(*args, G, ntx, with_nt=False)
    dacc = torch.randn(acc.shape, generator=g, device=dev)
    dtrans = torch.randn(trans.shape, generator=g, device=dev)
    # B4 writes the march lengths, B5 reads them
    out_bytes = (acc.numel() + trans.numel() + march.numel()) * 4
    idx_bytes = (cg.numel() + tids.numel() + 1) * 4
    nt_bytes = NB * rc.KC * tg * 4
    fwd, fwd_plain = rc.packed_blend_forward, rc.packed_blend_forward_plain
    bwd, bwd_plain = rc.packed_blend_backward, rc.packed_blend_backward_plain
    cases = {
        "B4 with_nt": (fwd, fwd_plain, dict(with_nt=True), {}, (), (OPS_FWD, 0), out_bytes + nt_bytes),
        "B4 no_nt": (fwd, fwd_plain, dict(with_nt=False), {}, (), (OPS_FWD, 0), out_bytes + nt_bytes),
        "B4 probe_wmax": (fwd, fwd_plain, dict(probe_wmax=True), {}, (), (OPS_FWD, 0),
                          out_bytes + nt_bytes),
        "B5": (bwd, bwd_plain, {}, {}, (march, acc, trans, dacc, dtrans), (OPS_BWD, 0),
               2 * out_bytes + nt_bytes * rc.NF),
    }
    if bf16:
        # B5-bf16 takes B4-bf16's outputs, as the autograd Function gives them
        acc_b, trans_b, _, march_b = rc.packed_blend_forward_bf16(*args, G, ntx, with_nt=False)
        bf16_fwd_ops = (OPS_FWD - OPS_ALPHA, OPS_BF16_WEIGHT)
        cases.update({
            "B4-bf16 with_nt": (rc.packed_blend_forward_bf16, fwd_plain, dict(with_nt=True),
                                dict(bf16=True), (), bf16_fwd_ops, out_bytes + nt_bytes),
            "B4-bf16 no_nt": (rc.packed_blend_forward_bf16, fwd_plain, dict(with_nt=False),
                              dict(bf16=True), (), bf16_fwd_ops, out_bytes + nt_bytes),
            "B5-bf16": (rc.packed_blend_backward_bf16, bwd_plain, {}, dict(bf16=True),
                        (march_b, acc_b, trans_b, dacc, dtrans), (OPS_BWD - OPS_ALPHA, OPS_BF16_WEIGHT),
                        2 * out_bytes + nt_bytes * rc.NF),
        })
    report = {}
    for case, (wrapper, plain, kw, plain_kw, extra, ops, io_bytes) in cases.items():
        call_args = (*args, *extra, G, ntx)
        out = wrapper(*call_args, **kw)
        # the plain backward takes no march lengths: it applies the stop rule
        plain_args = (*args, *extra[1:], G, ntx) if case.startswith("B5") else call_args
        ref = plain(*plain_args, **kw, **plain_kw)
        torch.cuda.synchronize()
        if case.startswith("B5"):
            err = errors("blend_backward", out, ref)
            # its per-slot sums run in a fixed order: launched again, the same bits
            repeats = bool(torch.equal(wrapper(*call_args, **kw), out))
            ok = err[1] <= 1e-5 and repeats
            what = f"of each field's largest gradient; launched twice, equal bits: {repeats}"
        else:
            err = errors("blend_forward", out[:2], ref[:2])
            nt_equal = bool(torch.equal(out[2], ref[2]))
            march_equal = bool(torch.equal(out[3], ref[3]))
            # the bf16 forward rounds where its plain version does: bit for bit
            ok = (err[1] == 0.0 if "bf16" in case else err[1] <= 1e-5) and nt_equal and march_equal
            what = (f"{'bit for bit' if 'bf16' in case else 'absolute'}, per-slot "
                    f"{'weights' if 'probe' in case else 'counts'} equal: {nt_equal}, march lengths "
                    f"equal: {march_equal}")
        tol = "0" if "B4-bf16" in case else "1e-05"
        print(f"kernel {case} [{label}, NB {NB}]: max_abs_err {err[0]:.3e}, error {err[1]:.3e} against a "
              f"tolerance of {tol} ({what}) {'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            fail(f"{case} disagrees with its plain version on {label}")
        r = {"max_abs_err": err[0]}
        if timing:
            # the shipped build and the one built with contraction, launched
            # straight from their libraries on the same inputs and on outputs
            # of the same shapes (no wrapper on the host between launches), in
            # turns
            outs = [torch.empty_like(o) for o in (out if isinstance(out, tuple) else (out,))]
            ptrs = [x.data_ptr() for x in (tp, cg, tids, goff, *extra, *outs)]
            entry = (f"lvdgs_packed_{'bwd' if case.startswith('B5') else 'fwd'}"
                     f"{'_bf16' if 'bf16' in case else ''}")
            shipped, fmad = (getattr(rc._library(fmad=f), entry) for f in (False, True))
            mode = 2 if "probe" in case else int(bool(kw.get("with_nt")))
            mode_arg = () if case.startswith("B5") else (mode,)

            def call(fn, ptrs=ptrs, case=case, mode_arg=mode_arg):
                rc._check_launch(fn(*ptrs, NB, G, tg, ntx, *mode_arg, rc._stream()), case)

            call(fmad)
            torch.cuda.synchronize()
            if case.startswith("B5"):
                fmad_err = errors("blend_backward", outs[0], ref)[1]
            else:
                fmad_err = errors("blend_forward", outs[:2], ref[:2])[1]
            # ms through the wrapper, kernel_ms straight from the library
            r["ms"] = time_ms(lambda: wrapper(*call_args, **kw), reps=10, inner=20)
            r["kernel_ms"] = time_ms(lambda: call(shipped), reps=10, inner=20)
            fmad_ms = time_ms(lambda: call(fmad), reps=10, inner=20)
            again_ms = time_ms(lambda: call(shipped), reps=10, inner=20)
            r["plain_ms"] = time_ms(lambda: plain(*plain_args, **kw, **plain_kw), reps=5, warmup=1)
            r["bound_ms"], r["bound_by"] = bound_ms(marched * rc.NF * 4 + idx_bytes + io_bytes,
                                                    marched * rc.P * ops[0], marched * rc.P * ops[1])
            print(f"kernel {case} [{label}, NB {NB}]: {r['ms']:.4f} ms through the wrapper "
                  f"({r['kernel_ms']:.4f} straight from the library), plain {r['plain_ms']:.3f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {marched} tile-slots marched); with "
                  f"multiply-add contraction {fmad_ms:.4f} ms against {r['kernel_ms']:.4f} / "
                  f"{again_ms:.4f} ms as shipped, straight from the libraries, error {fmad_err:.3e}",
                  flush=True)
        report[case] = r
    if bf16:
        check_bf16_against_f32(args, G, ntx, (march, acc, trans), (march_b, acc_b, trans_b), dacc,
                               dtrans, f"{label}, NB {NB}", gate=bf16_gate)
    return report


def check_bf16_against_f32(args, G: int, ntx: int, f32_out, bf16_out, dacc, dtrans, label: str,
                           gate: bool = True) -> None:
    """B4-bf16 against B4 and B5-bf16 against B5 on one block of slots: the
    colour channels (the image on a black background) within BF16_PIXEL_ERR
    and above BF16_PSNR, and each slot field's gradient, under the same
    random cotangent, at a cosine above BF16_GRAD_COS with the float32 one.
    With `gate` a miss fails. The opacity field's cosine is also printed
    apart for the slots whose opacity can reach the ALPHA_MAX clamp after
    bf16 rounding (>= 0.98) and for the rest."""
    import torch
    from lvdgs_torch.ops import rasterizer_cuda as rc

    (march, acc, trans), (march_b, acc_b, trans_b) = f32_out, bf16_out
    diff = acc_b[:G, :3] - acc[:G, :3]
    pixel_err = float(diff.abs().max())
    psnr = 10.0 * math.log10(1.0 / max(float((diff ** 2).mean()), 1e-12))
    d32 = rc.packed_blend_backward(*args, march, acc, trans, dacc, dtrans, G, ntx)
    db = rc.packed_blend_backward_bf16(*args, march_b, acc_b, trans_b, dacc, dtrans, G, ntx)
    cos = [float(torch.nn.functional.cosine_similarity(d32[..., f].reshape(-1), db[..., f].reshape(-1),
                                                       dim=0)) for f in range(rc.NF)]
    near = args[0][..., 9] >= 0.98
    op_cos = [float(torch.nn.functional.cosine_similarity(d32[..., 9][m], db[..., 9][m], dim=0))
              if bool(m.any()) else float("nan") for m in (~near, near)]
    ok = pixel_err < BF16_PIXEL_ERR and psnr > BF16_PSNR and min(cos) > BF16_GRAD_COS
    verdict = ("ok" if ok else "FAILS") if gate else "printed only"
    print(f"bf16 against float32 [{label}]: pixel error {pixel_err:.4e} (< {BF16_PIXEL_ERR}), PSNR "
          f"{psnr:.3f} dB (> {BF16_PSNR}), smallest slot-field gradient cosine {min(cos):.6f} "
          f"(> {BF16_GRAD_COS}; field {cos.index(min(cos))}) {verdict}; opacity-field cosine "
          f"{op_cos[0]:.6f} over slots of opacity < 0.98, {op_cos[1]:.6f} over the {int(near.sum())} "
          f"at or above", flush=True)
    if gate and not ok:
        fail(f"the bf16 packed kernels miss the reference's bar against float32 on {label}")


def check_bf16_main_path(slam) -> None:
    """The reference's bar for bf16 weight math
    (tests/test_rasterizer_pallas.py::test_blend_bf16_close_to_f32), on the
    main path's scene: the packed run's final map rendered from each of its
    keyframes with the tracking and the mapping config, in float32 and in
    bf16 on the same bins. The images within BF16_PIXEL_ERR and above
    BF16_PSNR; the gradients of the reference's loss, opacity * |image -
    0.4|, with respect to the map's means, log-scales, logit-opacities and
    colours at a cosine above BF16_GRAD_COS."""
    import dataclasses

    import torch
    from lvdgs_torch.ops import rasterizer as tr

    p, active = slam.gmap.params(), slam.gmap.active
    for kf in slam.kf_indices:
        slot = slam.kf_slots[kf]
        R, T = slam.kfbuf.R[slot], slam.kfbuf.T[slot]
        for name, cfg in (("tracking", slam.rcfg_track), ("mapping", slam.rcfg_map)):
            bins = tr.prepare_bins(p, active, R, T, slam.intr, cfg)
            outs = []
            for bf16 in (False, True):
                q = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
                out = tr.rasterize(q, active, R, T, slam.intr, dataclasses.replace(cfg, blend_bf16=bf16),
                                   bins=bins, need_n_touched=False)
                (out.opacity * (out.image - 0.4).abs()).mean().backward()
                outs.append((out.image.detach(), {k: v.grad for k, v in q.items()}))
            (img_a, grad_a), (img_b, grad_b) = outs
            diff = img_b - img_a
            pixel_err = float(diff.abs().max())
            psnr = 10.0 * math.log10(1.0 / max(float((diff ** 2).mean()), 1e-12))
            cos = {k: float(torch.nn.functional.cosine_similarity(grad_a[k].reshape(-1),
                                                                  grad_b[k].reshape(-1), dim=0))
                   for k in ("means", "log_scales", "logit_opacities", "features_dc")}
            ok = pixel_err < BF16_PIXEL_ERR and psnr > BF16_PSNR and min(cos.values()) > BF16_GRAD_COS
            print(f"bf16 against float32 [main path, keyframe {kf}, {name} config]: pixel error "
                  f"{pixel_err:.4e} (< {BF16_PIXEL_ERR}), PSNR {psnr:.3f} dB (> {BF16_PSNR}), gradient "
                  f"cosines {', '.join(f'{k} {v:.6f}' for k, v in cos.items())} (> {BF16_GRAD_COS}) "
                  f"{'ok' if ok else 'FAILS'}", flush=True)
            if not ok:
                fail(f"the bf16 renders miss the reference's bar against float32 on the main path, "
                     f"keyframe {kf}, {name} config")


def check_packed_equals_dense(tp, counts, ntx: int) -> None:
    """With plain grouping and a budget that does not bind, the packed
    blend holds the dense lists' slots in the same order: its acc and trans
    must equal B1's bit for bit."""
    import torch
    from lvdgs_torch.ops import rasterizer_cuda as rc
    from lvdgs_torch.tools.blocks import packed_from_dense

    K = tp.shape[0]
    args, G = packed_from_dense(tp, counts, K, sort_by_depth=False, seed=0)
    acc_p, trans_p, _, _ = rc.packed_blend_forward(*args, G, ntx, with_nt=False)
    acc_d, trans_d, _, _ = rc.blend_forward(tp, counts, ntx)
    T = tp.shape[1]
    same = (torch.equal(rc._from_group_major(acc_p, G)[:T], acc_d)
            and torch.equal(rc._from_group_major(trans_p, G)[:T], trans_d))
    print(f"B4 (budget {K}, plain grouping, NB {args[0].shape[0]}) against B1 on the same slots: "
          f"{'equal bit for bit' if same else 'DIFFERENT'}", flush=True)
    if not same:
        fail("B4 with a budget that does not bind differs from B1")


def check_gather_transpose(slam) -> None:
    """The main path's gather transpose (rasterizer._gather_rows' backward,
    the per-Gaussian sum of each slot's field gradients) on the slots the
    packed run's final map gives from its newest keyframe, packed as
    tracking and as mapping and dense: two calls must give the same bits,
    and it must agree with index_select's own backward (index_add_, whose
    atomics add in another order each call) within GATHER_TOL of each
    field's largest gradient. Both are timed, gather and transpose."""
    import torch
    from lvdgs_torch.ops import rasterizer as tr
    from lvdgs_torch.tools.timing import time_ms

    p, active = slam.gmap.params(), slam.gmap.active
    slot = slam.kf_slots[slam.kf_indices[-1]]
    R, T = slam.kfbuf.R[slot], slam.kfbuf.T[slot]
    ntx, nty = slam.rcfg.grid(slam.intr)
    proj = tr.project_gaussians(p["means"], p["quats"], p["log_scales"], active, R, T, slam.intr)
    colors, opac = tr._blend_inputs(p, active)
    fields = tr._fields(proj["mean2d"], proj["conic"], colors, opac, proj["depth"]).detach()
    C = fields.shape[0] - 1
    tile_idx, _slot_valid = tr._bin_for(proj, slam.rcfg, ntx, nty)
    indices = [(name, tr.prepare_bins(p, active, R, T, slam.intr, cfg).gid)
               for name, cfg in (("tracking", slam.rcfg_track), ("mapping", slam.rcfg_map))]
    indices.append(("dense", tile_idx.clamp(max=C).T))
    gen = torch.Generator(device=fields.device).manual_seed(0)
    for name, idx in indices:
        cot = torch.randn((*idx.shape, fields.shape[1]), device=fields.device, generator=gen)
        def ours():
            t = fields.clone().requires_grad_(True)
            return torch.autograd.grad(tr._gather_rows(t, idx), t, cot)[0]

        def atomics():
            t = fields.clone().requires_grad_(True)
            out = torch.index_select(t, 0, idx.reshape(-1)).view(cot.shape)
            return torch.autograd.grad(out, t, cot)[0]

        first, second, ref = ours(), ours(), atomics()
        scale = ref[:C].abs().amax(dim=0, keepdim=True) + 1e-12
        err = float(((first[:C] - ref[:C]).abs() / scale).max())
        same = torch.equal(first, second)
        ms, lib_ms = time_ms(ours), time_ms(atomics)
        ok = same and err <= GATHER_TOL
        print(f"gather transpose [main-path slots, {name}, {idx.numel()} slots]: two calls "
              f"{'equal bit for bit' if same else 'DIFFER'}, against index_add_ {err:.3e} of each "
              f"field's largest gradient (<= {GATHER_TOL}); gather and transpose {ms:.4f} ms, "
              f"through index_select {lib_ms:.4f} ms {'ok' if ok else 'FAILS'}", flush=True)
        if not ok:
            fail(f"the gather transpose on the {name} slots does not repeat or disagrees with index_add_")


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


def check_resident(device) -> dict:
    """R1 and R2 against their plain versions at the probe tool's shapes
    (lvdgs_torch.tools.perf_resident, seed 0): R1 bit for bit, R2 within
    SCATTER_TOL of the table's largest magnitude (atomics add in any
    order), also at its edge shapes (SCATTER_EDGES); each timed through its
    wrapper, straight from its library on preallocated outputs and from a
    CUDA graph of those launches (R2's zero and scatter passes also each
    alone), beside its plain version and the one library call that
    computes the same function (embedding_bag sum over the per-(group,
    lane) bags, index_add_)."""
    from lvdgs_torch.ops import resident_cuda as rs
    from lvdgs_torch.tools import perf_resident as pr
    from lvdgs_torch.tools.timing import graph_ms, time_ms

    idx, fields, upd = pr.make_inputs(pr.C, pr.T, pr.K, pr.TG, device)
    rows = fields.shape[0]
    ops = pr.calls(idx, fields, upd)
    err = pr.check(idx, fields, upd, ops)  # raises where a kernel disagrees
    bnd = pr.bounds(idx, fields)
    G, K, TG = idx.shape
    print(f"resident kernels at C={pr.C}, G={G}, K={K}, TG={TG} ({idx.numel()} slots, "
          f"{bnd['distinct_rows']} distinct rows): R1 error {err['gather']:.3e} (bit for bit), R2 error "
          f"{err['scatter_rel']:.3e} of the table's largest magnitude (tolerance {pr.SCATTER_TOL:.0e}) ok; "
          f"library calls against the kernels: embedding_bag {err['embedding_bag sum']:.3e}, index_add_ "
          f"{err['index_add_ scatter']:.3e}", flush=True)
    for shape in pr.SCATTER_EDGES:
        e = pr.scatter_edge_error(*shape, device)
        ok = e <= pr.SCATTER_TOL
        print(f"kernel resident_scatter at the edge shape (rows, G, K, TG) = {shape}: error {e:.3e} of the "
              f"table's largest magnitude (tolerance {pr.SCATTER_TOL:.0e}) {'ok' if ok else 'DISAGREES'}",
              flush=True)
        if not ok:
            fail(f"resident_scatter disagrees with its plain version at the edge shape {shape}")
    lib = pr.library_calls(idx, fields, upd)
    report = {}
    for name, key, plain, library in (
            ("resident_gather", "gather", lambda: rs.resident_gather_plain(idx, fields), "embedding_bag sum"),
            ("resident_scatter", "scatter", lambda: rs.resident_scatter_plain(idx, upd, rows),
             "index_add_ scatter")):
        r = {"max_abs_err": err[key]}
        # ms through the wrapper, kernel_ms straight from the library
        r["ms"] = time_ms(ops[key], reps=10, inner=20)
        r["kernel_ms"] = time_ms(lib[key], reps=10, inner=20)
        r["plain_ms"] = time_ms(plain, reps=10, warmup=1)
        r["library_ms"] = time_ms(ops[library], reps=10, inner=20)
        r["bound_ms"], r["bound_by"] = bnd[key]
        # straight from the library a launch of a few microseconds waits on
        # the host's launch from Python; from a CUDA graph, it does not
        r["graph_ms"], r["library_graph_ms"] = graph_ms(lib[key]), graph_ms(ops[library])
        if key == "scatter":
            # its two passes apart, each alone, from CUDA graphs
            r["zero_ms"], r["scatter_ms"] = graph_ms(lib["scatter zero"]), graph_ms(lib["scatter add"])
            print(f"kernel {name}: zero pass {r['zero_ms']:.4f} ms, scatter pass {r['scatter_ms']:.4f} ms "
                  f"(each alone, from a CUDA graph)", flush=True)
        ns = r["graph_ms"] * 1e6 / idx.numel()
        print(f"kernel {name}: {r['ms']:.4f} ms through the wrapper ({r['kernel_ms']:.4f} straight from the "
              f"library, {r['graph_ms']:.4f} from a CUDA graph; {ns:.3f} ns per slot), plain "
              f"{r['plain_ms']:.3f} ms, "
              f"{library} {r['library_ms']:.4f} ms ({r['library_graph_ms']:.4f} from a CUDA graph), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
        report[name] = r
    return report


def run_resident_probe() -> dict:
    """Phase 3: the resident-table probe's entry point, as a user runs it
    (python -m lvdgs_torch.tools.perf_resident), with the launch counts
    set to 0 just before it and read just after."""
    from lvdgs_torch.ops import resident_cuda as rs
    from lvdgs_torch.tools import perf_resident as pr

    for w in rs.KERNEL_WRAPPERS:
        w.launches.reset()
    pr.main([])
    launches = {w.__name__: w.launches.count for w in rs.KERNEL_WRAPPERS}
    print(f"launches on the resident-probe path: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was never launched on the resident-probe path")
    return launches


def log_buckets(slam) -> list:
    """Wrap the SLAM's _update_bin_bucket so that each call appends (frame,
    keyframes so far, bucket it left, active count it read, capacity) to
    the returned list."""
    log = []
    update = slam._update_bin_bucket

    def logged(lower_bound=0):
        update(lower_bound)
        log.append((slam.frames_processed, len(slam.kf_indices), slam.rcfg_map.bin_bucket,
                    slam._num_active_cached(), slam.gmap.capacity))
    slam._update_bin_bucket = logged
    return log


def run_slam(device, frames: int, packed: bool, bf16: bool = False, hold_limits: bool = True,
             pyramid: bool = False, bucket: bool = True, feed: str | None = None):
    """Phase 3: the SLAM main path on the street scene, as configured
    (packed), as configured with blend_bf16 (bf16) or with
    Training.track_pyramid (pyramid), or with both packed budgets at 0
    (dense). The tracking and mapping renders bin the active prefix (the
    bucket, on by default on the card) unless `bucket` is False
    (Performance.bin_active_bucket). Without `hold_limits` an ATE or PSNR
    miss is printed and does not fail. With `feed` (a directory), the run
    saves its results there with the GUI feed (every tracked frame), the
    depth comparisons and the eval panels on (check_feed)."""
    import numpy as np
    import torch

    from lvdgs_torch.core.config import load_config
    from lvdgs_torch.eval.ate import eval_ate
    from lvdgs_torch.ops import rasterizer_cuda as rc
    from lvdgs_torch.slam.system import SLAM

    label = ("packed bf16" if bf16 else "packed pyramid" if pyramid else "packed") if packed else "dense"
    config = load_config(os.path.join(ROOT, "configs/mono/synthetic/street.yaml"))
    perf = config["Performance"]
    if not packed:
        perf["packed_tracking_budget"] = 0
        perf["packed_mapping_budget"] = 0
    perf["blend_bf16"] = bf16
    perf["synced_timers"] = True
    if not bucket:
        perf["bin_active_bucket"] = False
    config["Training"]["mono_scale_servo"] = False
    config["Training"]["track_pyramid"] = pyramid
    config["Results"]["eval_rendering"] = True
    if feed:
        config["Results"].update(FEED_KEYS)
    n_frames_full = config["Dataset"]["n_frames"]
    config["Dataset"]["n_frames"] = frames
    cal = config["Dataset"]["Calibration"]
    slam = SLAM(config, save_dir=feed, device=device)
    feed_cost = time_feed(slam) if feed else None
    budgets = (f"tracking {slam.rcfg_track.slot_budget_per_tile} (feedback "
               f"{slam.rcfg_track.saturation_feedback}), mapping {slam.rcfg_map.slot_budget_per_tile} "
               f"(feedback {slam.rcfg_map.saturation_feedback})" if packed else "0")
    print(f"{label} path: street.yaml at {cal['width']}x{cal['height']}, max_per_tile "
          f"{perf['max_per_tile']}, map_capacity {perf['map_capacity']}, kf_capacity "
          f"{perf['kf_capacity']}, window_size {config['Training']['window_size']}, packed budgets "
          f"{budgets}, blend_bf16 {bf16}, track_pyramid {pyramid}, mono_scale_servo False, binning "
          f"bucket {'on' if slam._bin_bucket_enable else 'off'}", flush=True)
    if (packed != slam.rcfg_track.use_packed or packed != slam.rcfg_map.use_packed
            or bf16 != slam.rcfg_track.blend_bf16 or bf16 != slam.rcfg_map.blend_bf16
            or slam.rcfg.blend_bf16 or pyramid != slam.tcfg.pyramid or bucket != slam._bin_bucket_enable):
        fail(f"the {label} run does not render as asked")
    buckets = log_buckets(slam)
    if frames != n_frames_full:
        print(f"cut: Dataset.n_frames {n_frames_full} -> {frames}", flush=True)

    for w in rc.KERNEL_WRAPPERS:
        w.launches.reset()
    t0 = time.perf_counter()
    try:
        results = slam.run(progress=True)
    finally:
        if feed:
            feed_cost.restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches.count for w in rc.KERNEL_WRAPPERS}
    shapes = {w.__name__: w.launches.by_shape for w in (rc.packed_blend_forward, rc.packed_blend_backward)}

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
    print(f"{label} path: keyframes {slam.kf_indices}, map scale observations "
          f"{[(k, round(v, 4)) for k, v in slam._scale_history]}", flush=True)
    print(f"{label} path: binning bucket after each update (frames done, keyframes, bucket, actives, "
          f"capacity): {buckets}", flush=True)
    if not bucket and any(b[2] for b in buckets):
        fail(f"the {label} run bucketed its binning with the bucket off")
    slam.bucket_log = buckets
    print(f"launches on the {label} path: {json.dumps(launches)}", flush=True)
    print(f"packed launches on the {label} path by (NB, G): "
          f"{ {name: {str(k): n for k, n in by.items()} for name, by in shapes.items()} }", flush=True)

    if n_after_init < 2:
        fail(f"{label} path: only {n_after_init} keyframes after init; the path needs at least 2")
    if bf16:
        # B4 in float32 still runs, as the saturation probe
        must = ("blend_forward", "median_depth", "packed_blend_forward", "packed_blend_forward_bf16",
                "packed_blend_backward_bf16")
        if launches["packed_blend_backward"] != 0:
            fail(f"the float32 B5 was launched on the {label} path")
    elif packed:
        must = ("blend_forward", "median_depth", "packed_blend_forward", "packed_blend_backward")
    else:
        must = ("blend_forward", "blend_backward", "median_depth")
    for name in must:
        if launches[name] == 0:
            fail(f"kernel {name} was never launched on the {label} path")
    if pyramid:
        # B4 and B5 in both stages, told apart by their launch shapes: each
        # stage blends its frame's tile groups at its budget's chunk count
        # NB (mapping, and the saturation probe at max_per_tile, blend at
        # other counts); each stage's (NB, G) is the one its pack code gives
        # the final map from the newest keyframe
        from lvdgs_torch.tools.blocks import main_path_track_block

        stages = {}
        for stage, coarse in (("fine", False), ("coarse", True)):
            args, G, ntx, budget = main_path_track_block(slam, coarse)
            NB = args[0].shape[0]
            del args
            stages[stage] = {name: by.get((NB, G), 0) for name, by in shapes.items()}
            print(f"{label} path, {stage} stage ({ntx} tile columns, {G} groups, budget {budget}, NB {NB}): "
                  f"launches {json.dumps(stages[stage])}", flush=True)
            for name, n in stages[stage].items():
                if n == 0:
                    fail(f"kernel {name} was never launched in the {stage} stage of the {label} path at "
                         f"the stage's pack (NB, G) = ({NB}, {G}); it launched at "
                         f"{sorted(shapes[name])}")
        # each tracking step launches B5 once, at its stage's pack
        calls = results["timers"]["tracking"]["count"]
        print(f"{label} path: {calls} tracking calls, coarse stage "
              f"{stages['coarse']['packed_blend_backward'] / calls:.2f} and fine stage "
              f"{stages['fine']['packed_blend_backward'] / calls:.2f} iterations a call", flush=True)
        launches["stages"] = stages
    poses = np.stack([np.concatenate([np.ravel(f["R"]), np.ravel(f["T"])])
                      for f in slam.frames.values()])
    if not np.isfinite(poses).all():
        fail(f"{label} path: non-finite pose")
    act = slam.gmap.active
    for k, v in slam.gmap.params().items():
        if not bool(torch.isfinite(v[act]).all()):
            fail(f"{label} path: non-finite map field {k}")
    for ok, miss in ((ate < ATE_LIMIT, f"ATE RMSE {ate:.4f} m is not below {ATE_LIMIT}"),
                     (psnr > PSNR_LIMIT, f"PSNR {psnr:.3f} dB is not above {PSNR_LIMIT}")):
        if not ok and hold_limits:
            fail(f"{label} path: {miss}")
        if not ok:
            print(f"{label} path: {miss} (printed only in this mode)", flush=True)
    if feed:
        check_feed(slam, results, frames, feed_cost)
    return launches, slam


class plain_b1:
    """Within this block the dense blend forward (B1) runs its plain
    version: rasterizer_cuda.BlendFunction looks blend_forward up at each
    call, so the swap reaches every dense render, and no launch is
    counted."""

    def __enter__(self):
        from lvdgs_torch.ops import rasterizer_cuda as rc

        self.kernel = rc.blend_forward
        rc.blend_forward = rc.blend_forward_plain

    def __exit__(self, *exc):
        from lvdgs_torch.ops import rasterizer_cuda as rc

        rc.blend_forward = self.kernel


def check_dynamic_mask(dataset, idx: int) -> None:
    """Frame `idx`'s GT static mask rendered through B1 against the one
    rendered through B1's plain version: equal except at pixels whose
    dynamic coverage or opacity lies within MASK_EDGE of the 0.5 threshold
    in either render (a rounding there may flip the pixel)."""
    import torch

    cov_k, op_k = dataset.static_mask_coverage(idx)
    with plain_b1():
        cov_p, op_p = dataset.static_mask_coverage(idx)
    torch.cuda.synchronize()
    near = torch.zeros_like(op_k, dtype=torch.bool)
    for x in (cov_k, op_k, cov_p, op_p):
        near |= (x - 0.5).abs() <= MASK_EDGE
    mask_k = (cov_k < 0.5) | (op_k < 0.5)
    mask_p = (cov_p < 0.5) | (op_p < 0.5)
    differ = int(((mask_k != mask_p) & ~near).sum())
    print(f"dynamic street, frame {idx}: GT static mask through B1 against its plain version: "
          f"{int((~mask_k).sum())} dynamic pixels of {mask_k.numel()}, {int(near.sum())} within "
          f"{MASK_EDGE:.0e} of a 0.5 threshold, {int((mask_k != mask_p).sum())} differ there and "
          f"{differ} elsewhere {'ok' if differ == 0 else 'DISAGREES'}", flush=True)
    if differ:
        fail("the GT static mask rendered through B1 disagrees with its plain version away from the "
             "thresholds")


def run_dynamic(device, frames: int, stop: int) -> dict:
    """Phase 3: the dynamic street, stopped and resumed. street.yaml with
    Dataset.dynamic_objects 3, packed as configured, with an
    OracleLadderMasker (the masking ladder on GT boxes and masks) given to
    SLAM's constructor, so the masked mapping loss runs. Frames 0 to
    stop - 1 run in one SLAM, whose state is saved; a fresh SLAM with a
    fresh masker loads it (its map and Adam state must equal the saved ones
    bit for bit) and runs to `frames`. Held to ATE < ATE_LIMIT and static
    PSNR > PSNR_LIMIT; must launch B1, B3, B4 and B5 (counts set to 0 just
    before the first SLAM runs and read after the second)."""
    import tempfile

    import numpy as np
    import torch

    from lvdgs_torch.core.config import load_config
    from lvdgs_torch.data.datasets import load_dataset
    from lvdgs_torch.eval.ate import eval_ate
    from lvdgs_torch.ops import rasterizer_cuda as rc
    from lvdgs_torch.perception import masking
    from lvdgs_torch.perception.oracle import OracleLadderMasker
    from lvdgs_torch.slam.system import SLAM

    label = "dynamic"
    config = load_config(os.path.join(ROOT, "configs/mono/synthetic/street.yaml"))
    config["Dataset"]["dynamic_objects"] = 3
    n_frames_full = config["Dataset"]["n_frames"]
    config["Dataset"]["n_frames"] = frames
    config["Training"]["mono_scale_servo"] = False
    config["Results"]["eval_rendering"] = True
    config["Performance"]["synced_timers"] = True
    cal = config["Dataset"]["Calibration"]

    def build():
        # the masker's oracle hooks read GT masks from a dataset of their own
        masker = OracleLadderMasker(load_dataset(None, "", config, device))
        return SLAM(config, save_dir=None, device=device, masker=masker), masker

    first, masker = build()
    cv2 = getattr(masking.cv2, "__version__", None)
    print(f"{label} path: street.yaml at {cal['width']}x{cal['height']} with dynamic_objects 3, "
          f"{len(first.dataset._dynamic)} moving cars, packed budgets tracking "
          f"{first.rcfg_track.slot_budget_per_tile}, mapping {first.rcfg_map.slot_budget_per_tile}, "
          f"OracleLadderMasker; masked mapping loss {first.mcfg.use_masked_loss}; optical flow "
          f"{'runs (cv2 ' + cv2 + ')' if masker.use_flow else 'off (no cv2)'}; stop after frame "
          f"{stop - 1}, resume to frame {frames - 1}", flush=True)
    if frames != n_frames_full:
        print(f"cut: Dataset.n_frames {n_frames_full} -> {frames}", flush=True)
    if not (first.mcfg.use_masked_loss and first.rcfg_track.use_packed and first.rcfg_map.use_packed):
        fail(f"the {label} run does not render or mask as asked")
    check_dynamic_mask(first.dataset, 0)

    for w in rc.KERNEL_WRAPPERS:
        w.launches.reset()
    t0 = time.perf_counter()
    first.do_eval_rendering = False
    first.run(n_frames=stop, progress=True)
    ckpt_dir = tempfile.mkdtemp(prefix="lvdgs_ckpt_")
    path = os.path.join(ckpt_dir, "checkpoint")
    torch.cuda.synchronize()
    t_save = time.perf_counter()
    first.save_state(path)
    save_s = time.perf_counter() - t_save
    size = os.path.getsize(path)
    second, _ = build()
    t_load = time.perf_counter()
    second.load_state(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t_load
    saved = [("map " + f, getattr(first.gmap, f), getattr(second.gmap, f))
             for f in first.gmap.__dataclass_fields__]
    saved += [(f"adam {part} {k}", getattr(first.opt_state, part)[k], getattr(second.opt_state, part)[k])
              for part in ("m", "v") for k in first.opt_state.m]
    differ = [name for name, a, b in saved if not torch.equal(a, b)]
    same_count = first.opt_state.count == second.opt_state.count
    print(f"{label} path: checkpoint after frame {stop - 1}: {size} bytes, saved in {save_s:.3f} s, "
          f"loaded in {load_s:.3f} s; map and Adam state, {len(saved)} tensors: {len(differ)} differ "
          f"{differ[:6]}, Adam step {'equal' if same_count else 'DIFFERS'}", flush=True)
    if differ or not same_count:
        fail(f"the {label} run's loaded map or Adam state differs from the saved one")
    first_timers = first.timer.summary()
    del first
    results = second.run(progress=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches.count for w in rc.KERNEL_WRAPPERS}
    os.remove(path)
    os.rmdir(ckpt_dir)

    ate = eval_ate(second.frames, second.kf_indices, None, frames, final=True, monocular=True)
    psnr = results.get("mean_psnr", float("nan"))
    psnr_s = results.get("mean_psnr_static", float("nan"))
    n_after_init = len(second.kf_indices) - 1
    print(f"{label} path: {results['n_frames']} frames, {results['n_keyframes']} keyframes "
          f"({n_after_init} after init), {second.gmap.num_active} active Gaussians, {wall:.1f} s with "
          f"the save and the load ({results['fps']:.4f} fps over the resumed frames), ATE RMSE {ate:.4f} "
          f"m, PSNR {psnr:.3f} dB, static PSNR {psnr_s:.3f} dB, static SSIM "
          f"{results.get('mean_ssim_static', float('nan')):.4f} over {results.get('n_eval_frames', 0)} "
          f"frames", flush=True)
    for part, timers in (("first run", first_timers), ("resumed run", results["timers"])):
        for name, t in timers.items():
            print(f"{label} timer {name} ({part}): {t['total_s']:.3f} s total, {t['count']} calls, "
                  f"{t['mean_ms']:.2f} ms mean", flush=True)
    shares = {k: round(float(np.mean(second.frames[k]["static_mask"])), 4) for k in second.kf_indices}
    print(f"{label} path: keyframes {second.kf_indices}, static share per keyframe {shares}", flush=True)
    print(f"launches on the {label} path: {json.dumps(launches)}", flush=True)
    if n_after_init < 2:
        fail(f"{label} path: only {n_after_init} keyframes after init; the path needs at least 2")
    for name in ("blend_forward", "median_depth", "packed_blend_forward", "packed_blend_backward"):
        if launches[name] == 0:
            fail(f"kernel {name} was never launched on the {label} path")
    poses = np.stack([np.concatenate([np.ravel(f["R"]), np.ravel(f["T"])]) for f in second.frames.values()])
    if not np.isfinite(poses).all():
        fail(f"{label} path: non-finite pose")
    for k, v in second.gmap.params().items():
        if not bool(torch.isfinite(v[second.gmap.active]).all()):
            fail(f"{label} path: non-finite map field {k}")
    if not ate < ATE_LIMIT:
        fail(f"{label} path: ATE RMSE {ate:.4f} m is not below {ATE_LIMIT}")
    if not psnr_s > PSNR_LIMIT:
        fail(f"{label} path: static PSNR {psnr_s:.3f} dB is not above {PSNR_LIMIT}")
    return launches


def run_detector(device, frames: int) -> dict:
    """Phase 3: the detector and segmenter models on the dynamic street.
    GroundingDINOConfig() (Swin-T, BERT-base, 6 + 6 layers, 900 queries)
    and SAMConfig() (ViT-B) with random weights from seeded
    torch.Generators on the card, saved in the official layouts
    (GroundingDINO's state dict under "model", SAM's bare) and loaded back
    through build_masker's dynamic_filtering.grounding_dino_checkpoint and
    sam_checkpoint: the masker's hooks must be the port's detector and
    segmenter, their parameters on the card and equal to the saved ones.
    On street frame 0, one detector forward and one segmenter call on the
    card are held against the same files loaded onto the CPU (TF32 off):
    GroundingDINO's raw logits and boxes and SAM's image embedding, mask
    logits and IoU within DETECTOR_TOL of each output's largest magnitude
    (where the card's top-900 differs from the CPU's, the count is printed
    and the card's decoder is fed the CPU's indices); the detector's
    forward at 800x256, SAM's encoder at 1024x1024 and its decoder at 1
    and 32 boxes are timed (medians of 10 CUDA-event timings). Then
    street.yaml with Dataset.dynamic_objects 3, packed as configured, runs
    on that masker with its hooks counted (calls, boxes found and kept per
    frame, SAM's mask share, raised exceptions, frames the saturation
    failsafe rejected). Random weights score hundreds of boxes a frame at
    1.0 and give each a SAM mask over much of the frame, so 32 boxes always
    trip the failsafe (the mask is then dropped); the hook hands the masker
    the detector's first-ranked box instead, one model mask a frame. No
    call may raise, the failsafe must keep some frame's mask and some
    keyframe must hold a masked pixel, B1, B3, B4 and B5 must launch, the
    poses and map stay finite, at least 2 keyframes after init. ATE, PSNR
    and static PSNR are printed, not held: random weights say nothing of
    accuracy."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lvdgs_torch.core.config import load_config
    from lvdgs_torch.data.datasets import load_dataset
    from lvdgs_torch.eval.ate import eval_ate
    from lvdgs_torch.models.groundingdino import model as gm
    from lvdgs_torch.models.groundingdino.inference import GroundingDINODetector, load_detector
    from lvdgs_torch.models.sam import model as sm
    from lvdgs_torch.models.sam.inference import SAMSegmenter, load_segmenter
    from lvdgs_torch.ops import rasterizer_cuda as rc
    from lvdgs_torch.perception import build_masker
    from lvdgs_torch.slam.system import SLAM
    from lvdgs_torch.tools.timing import time_ms

    label = "detector"
    config = load_config(os.path.join(ROOT, "configs/mono/synthetic/street.yaml"))
    config["Dataset"]["dynamic_objects"] = 3
    n_frames_full = config["Dataset"]["n_frames"]
    config["Dataset"]["n_frames"] = frames
    config["Training"]["mono_scale_servo"] = False
    config["Results"]["eval_rendering"] = True
    config["Performance"]["synced_timers"] = True
    cal = config["Dataset"]["Calibration"]

    t0 = time.perf_counter()
    made = {"GroundingDINO": gm.init_params(gm.GroundingDINOConfig(), torch.Generator(device=device).manual_seed(0),
                                            device),
            "SAM": sm.init_params(sm.SAMConfig(), torch.Generator(device=device).manual_seed(1), device)}
    torch.cuda.synchronize()
    saved = {name: {k: v.clone() for k, v in m.state_dict().items()} for name, m in made.items()}
    tmp = tempfile.mkdtemp(prefix="lvdgs_detector_")
    try:
        paths = {"GroundingDINO": os.path.join(tmp, "groundingdino_swint_ogc.pth"),
                 "SAM": os.path.join(tmp, "sam_vit_b_01ec64.pth")}
        torch.save({"model": made["GroundingDINO"].state_dict()}, paths["GroundingDINO"])
        torch.save(made["SAM"].state_dict(), paths["SAM"])
        for name, m in made.items():
            n = sum(p.numel() for p in m.parameters())
            nbytes = sum(p.numel() * p.element_size() for p in m.parameters())
            print(f"{label} models: {name} ({'Swin-T, BERT-base, 6+6 layers, 900 queries' if name != 'SAM' else 'ViT-B'}), "
                  f"{n} parameters, {nbytes} parameter bytes, saved in the official layout "
                  f"({os.path.getsize(paths[name])} bytes)", flush=True)
        del made
        torch.cuda.empty_cache()
        config["dynamic_filtering"] = {"enabled": True, "scene_type": "outdoor_street", "use_sam": True,
                                       "use_flow": True, "grounding_dino_checkpoint": paths["GroundingDINO"],
                                       "sam_checkpoint": paths["SAM"]}
        masker = build_masker(config, device)
        det_cpu = load_detector(paths["GroundingDINO"], device="cpu")
        seg_cpu = load_segmenter(paths["SAM"], device="cpu")
    finally:
        shutil.rmtree(tmp)
    det, seg = masker.detector, masker.segmenter
    if not (isinstance(det, GroundingDINODetector) and isinstance(seg, SAMSegmenter)):
        fail(f"build_masker's hooks are {type(det).__name__} and {type(seg).__name__}, not the port's "
             f"GroundingDINODetector and SAMSegmenter")
    on_card = all(p.device.type == "cuda" for m in (det.model, seg.model) for p in m.parameters())
    same = all(torch.equal(v, saved[name][k]) for name, m in (("GroundingDINO", det.model), ("SAM", seg.model))
               for k, v in m.state_dict().items())
    del saved
    print(f"{label} models: loaded through build_masker in {time.perf_counter() - t0:.1f} s (init, save, "
          f"load onto the card and the CPU, the masker's warm-up): parameters on the card {on_card}, equal "
          f"to the saved ones {same}", flush=True)
    if not (on_card and same):
        fail("the masker's models are not on the card or differ from the saved weights")

    # street frame 0 on the card against the CPU
    ds = load_dataset(None, "", config, device)
    img = masker._to_u8_hwc(ds[0][0])
    prompt = masker.prompt_manager.get_dynamic_prompt()
    t_cpu = time.perf_counter()
    raw_cpu = det_cpu.forward_raw(img, prompt)
    t_cpu = time.perf_counter() - t_cpu
    raw = det.forward_raw(img, prompt)
    topk, topk_cpu = raw["topk"].cpu(), raw_cpu["topk"]
    differ = int((topk != topk_cpu).sum())
    not_chosen = int((~torch.isin(topk, topk_cpu)).sum())

    def rel(a, b):
        a, b = a.detach().cpu(), b.detach().cpu()
        fin = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), fin):
            return float("inf")
        return float((a[fin] - b[fin]).abs().max()) / float(b[fin].abs().max())

    score_err = rel(raw["scores"], raw_cpu["scores"])
    # sorted, the selection's scores on both devices: their gaps to the
    # next score, against the card's error, say whether the orders can
    # differ by rounding alone
    ranked = raw_cpu["scores"][0].sort(descending=True).values[:det.cfg.num_queries + 1]
    gap = float((ranked[:-1] - ranked[1:]).min())
    if differ:
        raw = det.forward_raw(img, prompt, topk=topk_cpu.to(device))
    x = det.preprocess(img)
    errs = {"logits": rel(raw["logits"], raw_cpu["logits"]), "boxes": rel(raw["boxes"], raw_cpu["boxes"]),
            "selection scores": score_err}
    ok = max(errs.values()) <= DETECTOR_TOL
    print(f"{label} [GroundingDINO, street frame 0 at {x.shape[3]}x{x.shape[2]}, {len(det.text_inputs(prompt)[0])} "
          f"prompt tokens]: the selection's {raw['scores'].shape[1]} token scores {score_err:.3e} of their largest "
          f"magnitude against the CPU (the smallest gap between the CPU's top {det.cfg.num_queries + 1} sorted "
          f"scores {gap:.3e}); top-{det.cfg.num_queries} positions differing from the CPU's: {differ}, indices the "
          f"CPU did not choose: {not_chosen}{' (the card decoded the CPU indices)' if differ else ''}; raw logits "
          f"{errs['logits']:.3e} and boxes "
          f"{errs['boxes']:.3e} of their largest magnitude against the CPU (tolerance {DETECTOR_TOL:.0e}) "
          f"{'ok' if ok else 'DISAGREES'}; the CPU's forward {t_cpu:.1f} s", flush=True)
    if not ok:
        fail("GroundingDINO on the card disagrees with the CPU")

    xyxy, scores = det_cpu(img, prompt)
    order = np.argsort(-scores)[:seg.MAX_BOXES]
    boxes = xyxy[order] if len(order) else np.array([[400.0, 150.0, 800.0, 300.0]], np.float32)
    xs, _ = seg.preprocess(img)
    t_cpu = time.perf_counter()
    emb_cpu = sm.sam_encode_image(seg_cpu.model, torch.as_tensor(xs))
    masks_cpu, iou_cpu = sm.sam_predict_masks(seg_cpu.model, emb_cpu, seg_cpu.box_inputs(img, boxes))
    t_cpu = time.perf_counter() - t_cpu
    emb = sm.sam_encode_image(seg.model, torch.as_tensor(xs, device=device))
    masks, iou = sm.sam_predict_masks(seg.model, emb, seg.box_inputs(img, boxes))
    errs = {"embedding": rel(emb, emb_cpu), "mask logits": rel(masks, masks_cpu), "IoU": rel(iou, iou_cpu)}
    ok = max(errs.values()) <= DETECTOR_TOL
    print(f"{label} [SAM, street frame 0 at {seg.cfg.img_size}x{seg.cfg.img_size}, {len(boxes)} boxes]: image "
          f"embedding {errs['embedding']:.3e}, mask logits {errs['mask logits']:.3e}, IoU {errs['IoU']:.3e} of "
          f"their largest magnitude against the CPU (tolerance {DETECTOR_TOL:.0e}) {'ok' if ok else 'DISAGREES'}; "
          f"the CPU's encoder and decoder {t_cpu:.1f} s", flush=True)
    if not ok:
        fail("SAM on the card disagrees with the CPU")
    del det_cpu, seg_cpu, raw_cpu, emb_cpu, masks_cpu

    # times on the card
    ids, _, self_mask, pad_mask, position_ids = det.text_inputs(prompt)
    targs = [torch.as_tensor(a, device=device)[None] for a in (ids, self_mask, pad_mask, position_ids)]
    xt = torch.as_tensor(x, device=device)
    det_ms = time_ms(lambda: gm.groundingdino_forward(det.model, xt, *targs[:3], targs[3]), reps=10, warmup=2)
    xst = torch.as_tensor(xs, device=device)
    enc_ms = time_ms(lambda: sm.sam_encode_image(seg.model, xst), reps=10, warmup=2)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(0, cal["width"] * 0.8, 32)
    y0 = rng.uniform(0, cal["height"] * 0.8, 32)
    b32 = seg.box_inputs(img, np.stack([x0, y0, x0 + rng.uniform(20, cal["width"] * 0.2, 32),
                                        y0 + rng.uniform(20, cal["height"] * 0.2, 32)], 1).astype(np.float32))
    dec_ms = {n: time_ms(lambda n=n: sm.sam_predict_masks(seg.model, emb, b32[:n]), reps=10, warmup=2)
              for n in (1, 32)}
    print(f"{label} times on the card (medians of 10 CUDA-event timings): GroundingDINO forward at "
          f"{x.shape[3]}x{x.shape[2]} {det_ms:.3f} ms, SAM encoder at {seg.cfg.img_size}x{seg.cfg.img_size} "
          f"{enc_ms:.3f} ms, SAM decoder at 1 box {dec_ms[1]:.3f} ms and at 32 boxes {dec_ms[32]:.3f} ms",
          flush=True)
    del emb, masks, xt, xst, b32
    torch.cuda.empty_cache()

    # the dynamic street on this masker, its hooks counted
    stats = {name: {"calls": 0, "raised": 0, "errors": []} for name in ("detector", "segmenter")}
    found, mask_share, host = [], [], []

    def counted(name, fn, after):
        def call(*args, **kw):
            s = stats[name]
            s["calls"] += 1
            try:
                out = fn(*args, **kw)
            except Exception as e:
                s["raised"] += 1
                s["errors"].append(f"{type(e).__name__}: {e}")
                raise
            return after(out)
        return call

    def first_box(out):
        xyxy, scores = out
        found.append(int((scores >= masker.box_threshold).sum()))
        first = np.argsort(-scores, kind="stable")[:1]
        return xyxy[first], scores[first]

    def share(masks):
        mask_share.append(round(float(np.any(masks, axis=0).mean()), 3) if len(masks) else 0.0)
        return masks

    masker.detector = counted("detector", det, first_box)
    masker.segmenter = counted("segmenter", seg, share)
    get_mask = masker.get_static_mask

    def timed_mask(*args, **kw):
        t = time.perf_counter()
        out = get_mask(*args, **kw)
        host.append(time.perf_counter() - t)
        return out

    masker.get_static_mask = timed_mask
    masker.saturated_frames = 0
    slam = SLAM(config, save_dir=None, device=device, masker=masker)
    print(f"{label} path: street.yaml at {cal['width']}x{cal['height']} with dynamic_objects 3, "
          f"{len(slam.dataset._dynamic)} moving cars, packed budgets tracking "
          f"{slam.rcfg_track.slot_budget_per_tile}, mapping {slam.rcfg_map.slot_budget_per_tile}, the masker "
          f"build_masker made (GroundingDINO + SAM + flow); masked mapping loss {slam.mcfg.use_masked_loss}",
          flush=True)
    if frames != n_frames_full:
        print(f"cut: Dataset.n_frames {n_frames_full} -> {frames}", flush=True)
    if not (slam.mcfg.use_masked_loss and slam.rcfg_track.use_packed and slam.rcfg_map.use_packed):
        fail(f"the {label} run does not render or mask as asked")
    for w in rc.KERNEL_WRAPPERS:
        w.launches.reset()
    t0 = time.perf_counter()
    results = slam.run(progress=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches.count for w in rc.KERNEL_WRAPPERS}

    ate = eval_ate(slam.frames, slam.kf_indices, None, frames, final=True, monocular=True)
    n_after_init = len(slam.kf_indices) - 1
    print(f"{label} path: {results['n_frames']} frames, {results['n_keyframes']} keyframes ({n_after_init} after "
          f"init), {slam.gmap.num_active} active Gaussians, {results['fps']:.4f} fps ({wall:.1f} s); random "
          f"weights, printed only: ATE RMSE {ate:.4f} m, PSNR {results.get('mean_psnr', float('nan')):.3f} dB, "
          f"static PSNR {results.get('mean_psnr_static', float('nan')):.3f} dB over "
          f"{results.get('n_eval_frames', 0)} frames", flush=True)
    for name, t in results["timers"].items():
        print(f"{label} timer {name}: {t['total_s']:.3f} s total, {t['count']} calls, {t['mean_ms']:.2f} ms mean",
              flush=True)
    ms = sorted(1e3 * h for h in host)
    print(f"{label} path: masker host time per frame (detector, segmenter, flow, on the host clock): mean "
          f"{np.mean(ms):.1f} ms, median {ms[len(ms) // 2]:.1f} ms, max {ms[-1]:.1f} ms over {len(ms)} frames",
          flush=True)
    print(f"{label} path: detector calls {stats['detector']['calls']}, raised {stats['detector']['raised']}; "
          f"segmenter calls {stats['segmenter']['calls']}, raised {stats['segmenter']['raised']}; boxes at or over "
          f"the box threshold per frame {found}, 1 handed on; SAM's mask share per frame {mask_share}; frames the "
          f"saturation failsafe rejected {masker.saturated_frames}", flush=True)
    shares = {k: round(float(np.mean(slam.frames[k]["static_mask"])), 4) for k in slam.kf_indices}
    print(f"{label} path: keyframes {slam.kf_indices}, static share per keyframe {shares}", flush=True)
    print(f"launches on the {label} path: {json.dumps(launches)}", flush=True)
    for name, s in stats.items():
        if s["raised"]:
            fail(f"{label} path: the {name} raised {s['raised']} times, e.g. {s['errors'][:2]}")
    if stats["detector"]["calls"] < frames:
        fail(f"{label} path: the detector ran {stats['detector']['calls']} times over {frames} frames")
    if masker.saturated_frames >= len(host):
        fail(f"{label} path: the failsafe rejected all {len(host)} frames' masks; no model mask reached the map")
    if all(bool(np.all(slam.frames[k]["static_mask"])) for k in slam.kf_indices):
        fail(f"{label} path: every keyframe is all static; no model mask reached the map")
    if det.device.type != "cuda" or seg.device.type != "cuda":
        fail(f"{label} path: the models ran off the card")
    # cut to --detector-frames (10), the run maps one keyframe window after
    # init; its ATE and PSNRs are printed, not held
    if n_after_init < 1:
        fail(f"{label} path: no keyframe after init; the path needs at least 1")
    for name in ("blend_forward", "median_depth", "packed_blend_forward", "packed_blend_backward"):
        if launches[name] == 0:
            fail(f"kernel {name} was never launched on the {label} path")
    poses = np.stack([np.concatenate([np.ravel(f["R"]), np.ravel(f["T"])]) for f in slam.frames.values()])
    if not np.isfinite(poses).all():
        fail(f"{label} path: non-finite pose")
    for k, v in slam.gmap.params().items():
        if not bool(torch.isfinite(v[slam.gmap.active]).all()):
            fail(f"{label} path: non-finite map field {k}")
    del slam, masker, det, seg
    gc.collect()  # the timing wrapper closes a cycle through the masker
    torch.cuda.empty_cache()
    return launches


def time_binning(slam) -> None:
    """One binning call (the tracking and mapping renders' dense slot
    selection) of the run's final map from its newest keyframe, with the
    bucket the run last used and at full capacity: the bins must be equal
    bit for bit, and each is timed (CUDA events)."""
    import dataclasses

    import torch
    from lvdgs_torch.ops import rasterizer as tr
    from lvdgs_torch.tools.timing import time_ms

    used = [b[2] for b in slam.bucket_log if b[2]]
    if not used:
        print(f"binning: the run never bucketed (capacity {slam.gmap.capacity}, "
              f"{slam.gmap.num_active} active)", flush=True)
        return
    bucket = used[-1]
    p, active = slam.gmap.params(), slam.gmap.active
    slot = slam.kf_slots[slam.kf_indices[-1]]
    proj = tr.project_gaussians(p["means"], p["quats"], p["log_scales"], active, slam.kfbuf.R[slot],
                                slam.kfbuf.T[slot], slam.intr)
    ntx, nty = slam.rcfg_map.grid(slam.intr)
    cfgs = {b: dataclasses.replace(slam.rcfg_map, bin_bucket=b) for b in (bucket, 0)}
    bins = {b: tr._bin_for(proj, cfg, ntx, nty) for b, cfg in cfgs.items()}
    same = all(torch.equal(x, y) for x, y in zip(bins[bucket], bins[0]))
    ms = {b: time_ms(lambda cfg=cfg: tr._bin_for(proj, cfg, ntx, nty), reps=10) for b, cfg in cfgs.items()}
    n_valid = int(proj["valid"].sum())
    print(f"binning of the packed run's final map ({n_valid} valid of {slam.gmap.capacity} slots, "
          f"{slam.gmap.num_active} active): {ms[bucket]:.4f} ms a call with the bucket at {bucket}, "
          f"{ms[0]:.4f} ms at full capacity; bins {'equal bit for bit' if same else 'DIFFERENT'}",
          flush=True)
    if not same and n_valid <= bucket:
        fail("the bucketed bins differ from full-capacity binning while the bucket holds the valid")


def run_prior(device, frames: int):
    """Phase 3: the MASt3R prior path on the street scene. street.yaml,
    packed as configured (the bucket on), Training.pose_seed
    constant_velocity, with make_fused_priors and make_scale_remedy over
    OracleMASt3R(depth_scale=0.9) (the network's forwards made from ground
    truth; matching on the card, the map's median depth, PnP-RANSAC and the
    seed's composition as in production) given to SLAM's constructor, and
    Results.global_BA at the config's global_BA_itr_num. Held to the
    reference's bars for this path: ATE < PRIOR_ATE_LIMIT and PSNR >
    PSNR_LIMIT after global BA; PnP must succeed on at least half of the
    tracked frames; B1, B3, B4 and B5 must launch. Returns (launches,
    slam)."""
    import numpy as np
    import torch

    from lvdgs_torch.core.config import load_config
    from lvdgs_torch.data.datasets import load_dataset
    from lvdgs_torch.eval.ate import eval_ate
    from lvdgs_torch.models.mast3r import inference
    from lvdgs_torch.models.mast3r.oracle import OracleMASt3R
    from lvdgs_torch.ops import rasterizer_cuda as rc
    from lvdgs_torch.slam.system import SLAM

    label = "prior"
    if inference.cv2 is None:
        fail("the prior path needs OpenCV (cv2): without it PnP cannot run")
    config = load_config(os.path.join(ROOT, "configs/mono/synthetic/street.yaml"))
    n_frames_full = config["Dataset"]["n_frames"]
    config["Dataset"]["n_frames"] = frames
    config["Training"]["pose_seed"] = "constant_velocity"
    config["Training"]["mono_scale_servo"] = False
    config["Results"]["global_BA"] = True
    config["Results"]["eval_rendering"] = True
    config["Performance"]["synced_timers"] = True
    cal = config["Dataset"]["Calibration"]
    # the oracle's frames come from a dataset of its own, as the priors are
    # built before SLAM; the card renders the same frames bit for bit
    ds = load_dataset(None, "", config, device)
    oracle = OracleMASt3R(ds, ds.intrinsics, depth_scale=0.9)
    depth_prior, pose_prior = inference.make_fused_priors(oracle, ds.intrinsics, ds.dist_coeffs)
    host = {"depth": [], "pose": []}

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            host[name].append(time.perf_counter() - t0)
            return out
        call.wants_kf = getattr(fn, "wants_kf", False)
        return call

    pnp = {"calls": 0, "ok": 0}
    pose_from_preds = inference._pose_from_preds

    def counted(*args, **kw):
        pose, depth = pose_from_preds(*args, **kw)
        pnp["calls"] += 1
        pnp["ok"] += int(not np.allclose(pose, np.eye(4), atol=1e-6))
        return pose, depth

    host["remedy"] = []
    slam = SLAM(config, save_dir=None, device=device, depth_prior=timed("depth", depth_prior),
                pose_prior=timed("pose", pose_prior),
                scale_remedy=timed("remedy", inference.make_scale_remedy(oracle)))
    print(f"{label} path: street.yaml at {cal['width']}x{cal['height']}, packed budgets tracking "
          f"{slam.rcfg_track.slot_budget_per_tile}, mapping {slam.rcfg_map.slot_budget_per_tile}, binning "
          f"bucket {'on' if slam._bin_bucket_enable else 'off'}, pose_seed constant_velocity, fused priors "
          f"and scale remedy over OracleMASt3R(depth_scale=0.9), global BA {slam.global_ba_iters} iterations, "
          f"mono_scale_servo False, cv2 {inference.cv2.__version__}", flush=True)
    if frames != n_frames_full:
        print(f"cut: Dataset.n_frames {n_frames_full} -> {frames}", flush=True)
    if not (slam.do_global_ba and slam.rcfg_track.use_packed and slam._bin_bucket_enable):
        fail(f"the {label} run does not render or adjust as asked")
    buckets = log_buckets(slam)
    ba = {}
    global_ba = slam.global_ba

    def timed_ba(*args):
        ba["ate_before"] = eval_ate(slam.frames, slam.kf_indices, None, frames, final=True, monocular=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        global_ba(*args)
        torch.cuda.synchronize()
        ba["s"] = time.perf_counter() - t0
    slam.global_ba = timed_ba

    for w in rc.KERNEL_WRAPPERS:
        w.launches.reset()
    inference._pose_from_preds = counted
    t0 = time.perf_counter()
    try:
        results = slam.run(progress=True)
    finally:
        inference._pose_from_preds = pose_from_preds
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches.count for w in rc.KERNEL_WRAPPERS}
    b3_shapes = rc.median_depth.launches.by_shape

    ate = eval_ate(slam.frames, slam.kf_indices, None, frames, final=True, monocular=True)
    psnr = results.get("mean_psnr", float("nan"))
    tracked = frames - 1
    print(f"{label} path: {results['n_frames']} frames, {results['n_keyframes']} keyframes, "
          f"{slam.gmap.num_active} active Gaussians, {results['fps']:.4f} fps over the frames, {wall:.1f} s "
          f"with global BA and the eval; ATE RMSE {ba.get('ate_before', float('nan')):.4f} m before global BA "
          f"and {ate:.4f} m after (limit {PRIOR_ATE_LIMIT}), PSNR {psnr:.3f} dB over "
          f"{results.get('n_eval_frames', 0)} frames (limit {PSNR_LIMIT})", flush=True)
    print(f"{label} path: global BA {slam.global_ba_iters} iterations in {ba.get('s', float('nan')):.3f} s; PnP "
          f"succeeded on {pnp['ok']} of {pnp['calls']} pose-prior calls ({tracked} tracked frames); prior host "
          f"time per frame: depth prior (the fused forward, its resize) {1e3 * np.mean(host['depth']):.2f} ms "
          f"mean over {len(host['depth'])}, pose prior (matching on the card, the median render, PnP) "
          f"{1e3 * np.mean(host['pose']):.2f} ms mean over {len(host['pose'])}; the scale remedy asked "
          f"{len(host['remedy'])} times, {1e3 * sum(host['remedy']):.2f} ms in all", flush=True)
    for name, t in results["timers"].items():
        print(f"{label} timer {name}: {t['total_s']:.3f} s total, {t['count']} calls, {t['mean_ms']:.2f} ms mean",
              flush=True)
    print(f"{label} path: keyframes {slam.kf_indices}; binning bucket after each update (frames done, "
          f"keyframes, bucket, actives, capacity): {buckets}", flush=True)
    print(f"launches on the {label} path: {json.dumps(launches)}; B3 by (T, ntx): "
          f"{ {str(k): n for k, n in b3_shapes.items()} }", flush=True)
    for name in ("blend_forward", "median_depth", "packed_blend_forward", "packed_blend_backward"):
        if launches[name] == 0:
            fail(f"kernel {name} was never launched on the {label} path")
    if pnp["calls"] != tracked or 2 * pnp["ok"] < tracked:
        fail(f"{label} path: PnP succeeded on {pnp['ok']} of {tracked} tracked frames; the prior is not "
             "engaging")
    poses = np.stack([np.concatenate([np.ravel(f["R"]), np.ravel(f["T"])]) for f in slam.frames.values()])
    if not np.isfinite(poses).all():
        fail(f"{label} path: non-finite pose")
    for k, v in slam.gmap.params().items():
        if not bool(torch.isfinite(v[slam.gmap.active]).all()):
            fail(f"{label} path: non-finite map field {k}")
    if not ate < PRIOR_ATE_LIMIT:
        fail(f"{label} path: ATE RMSE {ate:.4f} m is not below {PRIOR_ATE_LIMIT}")
    if not psnr > PSNR_LIMIT:
        fail(f"{label} path: PSNR {psnr:.3f} dB is not above {PSNR_LIMIT}")
    return launches, slam


def check_median_subres(slam, hw=(144, 512)) -> dict:
    """B3 against its plain version on the block the pose prior renders
    with the network: the run's final map from its newest keyframe at the
    network's resolution (the street's 1226x370 preprocessed to 512x144:
    32x9 tiles), within 1e-5 and launched twice, the same bits; timed."""
    import torch
    from lvdgs_torch.ops import rasterizer_cuda as rc
    from lvdgs_torch.tools.blocks import main_path_dense_block
    from lvdgs_torch.tools.timing import graph_ms, time_ms

    tp, counts, ntx = main_path_dense_block(slam, slam.intr.scaled(hw[1], hw[0]))
    out, again = rc.median_depth(tp, counts, ntx), rc.median_depth(tp, counts, ntx)
    ref = rc.median_depth_plain(tp, counts, ntx)
    torch.cuda.synchronize()
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    repeats = all(torch.equal(a, b) for a, b in zip(out, again))
    r = {"max_abs_err": err, "ms": time_ms(lambda: rc.median_depth(tp, counts, ntx), reps=10, inner=20),
         "plain_ms": time_ms(lambda: rc.median_depth_plain(tp, counts, ntx), reps=5, warmup=1)}
    lib = rc._library()
    dmed, opac = (torch.empty_like(x) for x in out)
    ptrs = [x.data_ptr() for x in (tp, counts, dmed, opac)]
    K, T, _ = tp.shape
    r["graph_ms"] = graph_ms(lambda: rc._check_launch(lib.lvdgs_median_depth(*ptrs, K, T, ntx, rc._stream()),
                                                      "median_depth"))
    ok = err <= 1e-5 and repeats
    print(f"kernel median_depth [prior run's final map at {hw[1]}x{hw[0]}, {ntx}x{T // ntx} tiles, K {K}]: "
          f"max_abs_err {err:.3e} against a tolerance of 1e-05, launched twice, equal bits: {repeats} "
          f"{'ok' if ok else 'DISAGREES'}; {r['ms']:.4f} ms through the wrapper, {r['graph_ms']:.4f} from a "
          f"CUDA graph, plain {r['plain_ms']:.3f} ms", flush=True)
    if not ok:
        fail("median_depth disagrees with its plain version at the network's resolution")
    return r


def run_network(device, slam):
    """The MASt3R network at its full published width (MASt3RConfig(),
    ViT-L encoder, ViT-B decoder), random weights from a seeded
    torch.Generator: saved as the official checkpoint is laid out (its
    state_dict under the official names, with the DPT scratch's layer_rn
    aliases, under "model", and an argparse.Namespace under "args") and
    loaded back through MASt3RInference.from_checkpoint, onto the card and
    onto the CPU. One fused forward on two street frames preprocessed to
    512x144 is held against the same module on the CPU (the raw head
    feature map within NET_RAW_TOL of its largest magnitude, the
    normalised descriptors within NET_DESC_TOL) and against the two
    unfused forwards on the card; the fused priors then run once on the
    card over the prior run's final map, whose pose prior renders B3 at
    the network's 32x9 tiles. Returns the card's MASt3RInference (for the
    coarse-to-fine phase)."""
    import argparse
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lvdgs_torch.models.mast3r import inference
    from lvdgs_torch.models.mast3r import model as mm
    from lvdgs_torch.ops import rasterizer_cuda as rc
    from lvdgs_torch.tools.timing import time_ms

    cfg = mm.MASt3RConfig()
    t0 = time.perf_counter()
    model = mm.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    sd = model.state_dict()
    official = dict(sd)
    for h in (1, 2):
        for i in range(4):
            official[f"downstream_head{h}.dpt.scratch.layer_rn.{i}.weight"] = \
                sd[f"downstream_head{h}.dpt.scratch.layer{i + 1}_rn.weight"]
    tmp = tempfile.mkdtemp(prefix="lvdgs_mast3r_")
    try:
        path = os.path.join(tmp, "mast3r.pth")
        torch.save({"model": official, "args": argparse.Namespace(model="AsymmetricMASt3R", seed=0)}, path)
        size = os.path.getsize(path)
        card = inference.MASt3RInference.from_checkpoint(path, device=device)
        host = inference.MASt3RInference.from_checkpoint(path, device="cpu")
    finally:
        shutil.rmtree(tmp)
    same = all(torch.equal(v, sd[k]) for k, v in card.model.state_dict().items())
    del model, sd, official
    torch.cuda.empty_cache()
    print(f"network: MASt3RConfig() (encoder {cfg.enc_dim}x{cfg.enc_depth}, decoder {cfg.dec_dim}x{cfg.dec_depth}), "
          f"{sum(p.numel() for p in card.model.parameters())} parameters, {nbytes} parameter bytes; random init, "
          f"the official layout saved ({size} bytes) and loaded onto the card and the CPU in "
          f"{time.perf_counter() - t0:.1f} s; loaded weights equal the saved ones: {same}", flush=True)
    if not same:
        fail("the MASt3R checkpoint loaded back differs from the saved weights")

    ds = slam.dataset
    kf_idx, cur_idx = 0, 5
    x1, shape = card._batch(ds[kf_idx][0])
    x2, _ = card._batch(ds[cur_idx][0])
    fused = mm.mast3r_forward_fused(card.model, x1, x2, raw=True)
    t_cpu = time.perf_counter()
    fused_cpu = mm.mast3r_forward_fused(host.model, x1.cpu(), x2.cpu(), raw=True)
    t_cpu = time.perf_counter() - t_cpu
    pair = mm.mast3r_forward(card.model, x1, x2, raw=True)
    depth = mm.mast3r_forward(card.model, x2, x2, raw=True)[0]
    torch.cuda.synchronize()

    def errs(a, b):
        raw = float((a["raw"].cpu() - b["raw"].cpu()).abs().max()) / float(b["raw"].abs().max())
        return raw, float((a["desc"].cpu() - b["desc"].cpu()).abs().max())

    names = ("pose pair view 1", "pose pair view 2", "depth pair view 1")
    ok = True
    for name, got, cpu, unfused in zip(names, fused, fused_cpu, (*pair, depth)):
        # random weights at full width: expm1 of the pointmap's norm may
        # overflow, so the raw map and the descriptors are what is held
        finite = bool(torch.isfinite(got["raw"]).all() and torch.isfinite(got["desc"]).all())
        overflow = {k: int((~torch.isfinite(got[k])).sum()) for k in ("pts3d", "conf", "desc_conf")}
        e_cpu, e_unf = errs(got, cpu), errs(got, unfused)
        good = finite and max(e_cpu[0], e_unf[0]) <= NET_RAW_TOL and max(e_cpu[1], e_unf[1]) <= NET_DESC_TOL
        ok = ok and good
        print(f"network [{name}, {shape[1]}x{shape[0]}]: raw head map against the CPU {e_cpu[0]:.3e} and "
              f"against the unfused forward {e_unf[0]:.3e} of its largest magnitude "
              f"({float(cpu['raw'].abs().max()):.4e}; tolerance {NET_RAW_TOL:.0e}), descriptors "
              f"{e_cpu[1]:.3e} and {e_unf[1]:.3e} (tolerance {NET_DESC_TOL:.0e}), finite {finite}; "
              f"non-finite values after post-processing {overflow} {'ok' if good else 'DISAGREES'}", flush=True)
    if not ok:
        fail("the full-width MASt3R on the card disagrees with its CPU self or its unfused forwards")
    fused_ms = time_ms(lambda: mm.mast3r_forward_fused(card.model, x1, x2), reps=5, warmup=1)
    pair_ms = time_ms(lambda: (mm.mast3r_forward(card.model, x1, x2), mm.mast3r_forward(card.model, x2, x2)),
                      reps=5, warmup=1)
    print(f"network: fused forward {fused_ms:.3f} ms median (the two unfused forwards it replaces "
          f"{pair_ms:.3f} ms; the CPU's fused forward {t_cpu:.1f} s)", flush=True)

    # the production priors on the card, once, over the prior run's final map
    depth_prior, pose_prior = inference.make_fused_priors(card, slam.intr, ds.dist_coeffs)
    kf = slam._cams[slam.current_window[0]]

    class Cam:
        uid = max(kf.uid - 1, 0)
        image = ds[uid][0]

    rc.median_depth.launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mono = depth_prior(Cam.image, last_kf_cam=kf)
    seed = pose_prior(Cam, kf, slam)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    b3 = rc.median_depth.launches.by_shape
    sub = (shape[0] // 16 * (shape[1] // 16), shape[1] // 16)
    print(f"network priors on the card (random weights, frame {Cam.uid} against keyframe {kf.uid}): mono "
          f"depth {tuple(mono.shape)}, {int(np.isfinite(mono).sum())} finite values; pose seed "
          f"{'given' if seed is not None else 'none'}; {1e3 * host_s:.1f} ms for both; B3 launches by "
          f"(T, ntx) {({str(k): n for k, n in b3.items()})}", flush=True)
    if b3.get(sub, 0) == 0:
        fail(f"the pose prior did not launch B3 at the network's {sub[1]}x{sub[0] // sub[1]} tiles")
    del host
    torch.cuda.empty_cache()
    return card


# the outputs that only read the state, on for the first float32 street run
FEED_KEYS = {"save_results": True, "use_gui": True, "gui_every": 1, "save_depth_comparison": True}
# the sparse global alignment's first Adam steps on the card against the
# CPU: float32 in other summation orders through 20 Adam steps, relative to
# the scene's scale (Adam's normalised first step turns rounding-level
# gradient differences into at most rounding-level parameter differences)
GA_STEPS, GA_TOL = 20, 1e-4
# the bars of tests/test_cloud_opt.py::test_sparse_ga_recovers_geometry
GA_CENTRE_BAR, GA_DIST_BAR = 0.25, 0.2
# DINOv2 (ViT-B/14, 12 blocks) on the card against its CPU self: float32
# with TF32 off in other summation orders; the final tokens relative to
# their largest magnitude (NET_RAW_TOL's measure), each block's tokens
# relative to that block's own update (block 0: to its tokens), each
# block's attention probabilities absolute
DINO_TOL, DINO_ATTN_TOL = 1e-4, 1e-5


class time_feed:
    """Host seconds that a SLAM's outputs which only read the state take:
    the GUI packets (each tracked frame's render brought to the host, a
    keyframe's map snapshot), the viewer's closing (its writer thread
    draining), the depth comparisons, and the eval's render dumps and
    six-panel figures; `restore` puts the wrapped functions back."""

    def __init__(self, slam):
        from lvdgs_torch.eval import rendering, viz

        self.s = {"packets": 0.0, "viewer close": 0.0, "depth comparisons": 0.0, "render dumps": 0.0,
                  "six panels": 0.0}
        self.n = dict.fromkeys(self.s, 0)
        self._undo = []
        for owner, name, key in ((slam, "_feed_viewer", "packets"), (slam.viewer, "close", "viewer close"),
                                 (viz, "save_depth_comparison", "depth comparisons"),
                                 (rendering, "_dump_frame", "render dumps"), (viz, "six_panel", "six panels")):
            self._wrap(owner, name, key)

    def _wrap(self, owner, name, key):
        fn = getattr(owner, name)
        own = name in vars(owner)  # a module's function, not an instance's method

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.s[key] += time.perf_counter() - t0
                self.n[key] += 1
        setattr(owner, name, timed)
        self._undo.append((owner, name, fn, own))

    def restore(self):
        for owner, name, fn, own in self._undo:
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)


def check_feed(slam, results, frames: int, cost) -> None:
    """Phase 3 (a): the first float32 street run with Results.save_results,
    use_gui (every tracked frame), save_depth_comparison and the default
    viz_every: one render dump (PNG and depth) and one six-panel figure per
    evaluated frame, one depth comparison per fused keyframe, one
    trajectory.jsonl record per tracked frame and the map's PLY, read back
    by the unchanged tools/replay_viewer.py (and composed where matplotlib
    is installed); prints the seconds they cost. The run at the end of the script, without these keys, must
    end on this run's map and poses bit for bit (the feed changes
    nothing)."""
    import importlib.util

    root = slam.save_dir
    n_eval, fused = results.get("n_eval_frames", 0), len(slam.kf_indices) - 1

    def count(sub, pred=lambda f: True):
        d = os.path.join(root, sub)
        return sum(pred(f) for f in os.listdir(d)) if os.path.isdir(d) else 0

    # the feed through the unchanged tools/replay_viewer.py: its readers,
    # and its composite where matplotlib is installed
    spec = importlib.util.spec_from_file_location("replay_viewer", os.path.join(ROOT, "tools", "replay_viewer.py"))
    replay = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(replay)
    gui = os.path.join(root, "gui")
    records = replay.read_trajectory(os.path.join(gui, "trajectory.jsonl"))
    xyz, _rgb = replay.read_ply(os.path.join(gui, "live_map.ply"))
    try:
        import matplotlib  # noqa: F401
        composed = replay.compose(gui, os.path.join(root, "replay.png"))
    except ImportError:
        composed = "not composed: the viewer's composite needs matplotlib, which is not installed here"
    got = {"six panels": count("panels_final"), "render PNGs": count("renders_final", lambda f: f.endswith(".png")),
           "depth dumps": count("renders_final", lambda f: f.endswith(".npy")),
           "depth comparisons": count("depth_comparison"), "trajectory records": len(records),
           "tracked frames recorded": sorted(r["frame"]["uid"] for r in records),
           "live renders": count("gui", lambda f: f.startswith("live_0")), "map PLY points > 0": len(xyz) > 0}
    want = {"six panels": n_eval, "render PNGs": n_eval, "depth dumps": n_eval, "depth comparisons": fused,
            "trajectory records": frames - 1, "tracked frames recorded": list(range(1, frames)),
            "live renders": frames - 1, "map PLY points > 0": True}
    total = sum(cost.s.values())
    print(f"feed and panels [packed run, {frames} frames, {n_eval} evaluated, {fused} fused keyframes]: "
          f"{json.dumps(got)} (expected {json.dumps(want)}); map PLY {len(xyz)} points; replay_viewer composite: "
          f"{composed} records; host seconds { {k: round(v, 4) for k, v in cost.s.items()} } over calls {cost.n}, "
          f"{total:.3f} s in all", flush=True)
    if got != want:
        fail("the feed and the panels did not write one file per frame as the reference does")


def run_colmap_export(slam) -> None:
    """Phase 3 (b): the first street run's state saved and exported through
    python -m lvdgs_torch.tools.colmap_export (its main, in this process)
    with --match-keyframes through the oracle; database.db read back with
    sqlite3: one camera, one image per frame, a non-empty match list for
    each consecutive keyframe pair; points3D.txt one line per active
    Gaussian."""
    import copy
    import sqlite3

    import yaml

    from lvdgs_torch.tools import colmap_export

    root = slam.save_dir
    state, cfg_path, out = (os.path.join(root, n) for n in ("state.pt", "config.yaml", "colmap"))
    t0 = time.perf_counter()
    slam.save_state(state)
    config = copy.deepcopy(slam.config)
    config["Results"].update({k: False for k in FEED_KEYS})
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(config, fh)
    os.environ.pop("LVDGS_MAST3R_CKPT", None)  # the oracle, not a checkpoint
    colmap_export.main(["--config", cfg_path, "--checkpoint", state, "--out", out, "--match-keyframes",
                        "--device", str(slam.device)])
    seconds = time.perf_counter() - t0
    conn = sqlite3.connect(os.path.join(out, "database.db"))
    cams = conn.execute("SELECT COUNT(*) FROM cameras").fetchone()[0]
    images = conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]
    matches = [r for (r,) in conn.execute("SELECT rows FROM matches ORDER BY pair_id")]
    kps = conn.execute("SELECT COUNT(*) FROM keypoints").fetchone()[0]
    conn.close()
    with open(os.path.join(out, "sparse", "points3D.txt")) as fh:
        points = sum(1 for ln in fh if not ln.startswith("#"))
    pairs = len(slam.kf_indices) - 1
    ok = (cams == 1 and images == len(slam.frames) and len(matches) == pairs and min(matches, default=0) > 0
          and points == slam.gmap.num_active)
    print(f"colmap export [keyframes {sorted(slam.kf_indices)}]: {cams} camera, {images} images "
          f"({len(slam.frames)} frames), matches per keyframe pair {matches}, {kps} images with keypoints, "
          f"{points} points ({slam.gmap.num_active} active Gaussians); {seconds:.2f} s with the save "
          f"{'ok' if ok else 'WRONG'}", flush=True)
    if not ok:
        fail("the COLMAP export of the street run is not the run")


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cloud_opt_problem(slam, hw=(144, 512), subsample: int = 8):
    """Phase 3 (c)'s inputs: the prior run's keyframes (at least 4) at the
    prior path's 512x144, their OracleMASt3R depths (ground truth, nearest
    samples) and descriptors, matched pairwise on the SLAM's device by
    fast_reciprocal_nns; the ground-truth camera centres."""
    import numpy as np

    from lvdgs_torch.models.mast3r.matching import fast_reciprocal_nns
    from lvdgs_torch.models.mast3r.oracle import OracleMASt3R

    ds, intr = slam.dataset, slam.intr
    kfs = sorted(slam.kf_indices)
    if len(kfs) < 4:
        fail(f"the prior run has {len(kfs)} keyframes; cloud optimisation needs at least 4")
    H, W = hw
    ys = ((np.arange(H) + 0.5) * intr.height / H).astype(np.int64)
    xs = ((np.arange(W) + 0.5) * intr.width / W).astype(np.int64)
    oracle = OracleMASt3R(ds, intr)
    depths, descs, centres = [], [], []
    for k in kfs:
        pts_cam, pts_world = oracle._frame_geometry(k)
        depths.append(np.ascontiguousarray(pts_cam[ys][:, xs, 2]))
        descs.append(oracle._desc(pts_world[ys][:, xs]))
        pose = np.asarray(ds.poses[k], np.float64)
        centres.append(-pose[:3, :3].T @ pose[:3, 3])
    pairs = []
    for i in range(len(kfs)):
        for j in range(i + 1, len(kfs)):
            m1, m2 = fast_reciprocal_nns(descs[i], descs[j], subsample=subsample, device=slam.device)
            if len(m1):
                pairs.append((i, j, m1.astype(np.float32), m2.astype(np.float32), np.ones(len(m1), np.float32)))
    sub = intr.scaled(W, H)
    N = len(kfs)
    kw = dict(imsizes=np.tile([[W, H]], (N, 1)), base_focals=np.full(N, sub.fx), pps=np.tile([[sub.cx, sub.cy]], (N, 1)),
              canonical_depths=[d[subsample // 2::subsample, subsample // 2::subsample] for d in depths],
              pair_matches=pairs, subsample=subsample)
    return kfs, kw, np.stack(depths), np.stack(centres), sub


def _centre_errors(c_gt, c_est):
    """(largest Umeyama residual over the scene's scale, largest normalised
    pairwise-distance error) of estimated camera centres against the truth:
    the measures of tests/test_cloud_opt.py."""
    import numpy as np

    mu_g, mu_e = c_gt.mean(0), c_est.mean(0)
    g0, e0 = c_gt - mu_g, c_est - mu_e
    U, D, Vt = np.linalg.svd(e0.T @ g0)
    Smat = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    R = U @ Smat @ Vt
    s = (D * np.diag(Smat)).sum() / max((e0**2).sum(), 1e-12)
    resid = np.linalg.norm(s * e0 @ R - g0, axis=-1).max() / np.linalg.norm(g0, axis=-1).mean()
    d_gt = np.linalg.norm(c_gt[:, None] - c_gt[None], axis=-1)
    d_est = np.linalg.norm(c_est[:, None] - c_est[None], axis=-1)
    return float(resid), float(np.abs(d_gt / d_gt.max() - d_est / max(d_est.max(), 1e-9)).max())


def run_cloud_opt(device, slam) -> dict:
    """Phase 3 (c): MASt3R cloud optimisation on the prior run's keyframes
    (cloud_opt_problem): sparse_global_alignment at SparseGAConfig()'s 500 +
    500 Adam steps on the card, its camera centres held to
    tests/test_cloud_opt.py's bars against the ground truth; a run of
    GA_STEPS phase-1 steps on the card and on the CPU held to each other within
    GA_TOL of the scene's scale; tsdf_refine_depths (one pass of 128
    samples a pixel) on the card over the same views; ms per Adam step and
    per TSDF pass, both phases' losses."""
    import dataclasses

    import numpy as np
    import torch

    from lvdgs_torch.models.mast3r import cloud_opt as co

    kfs, kw, depths, centres, sub = cloud_opt_problem(slam)
    cfg = co.SparseGAConfig()
    _sync(device)
    t0 = time.perf_counter()
    res = co.sparse_global_alignment(**kw, cfg=cfg, device=device)
    _sync(device)
    ga_s = time.perf_counter() - t0
    c_est = res.cam2w[:, :3, 3].double().cpu().numpy()
    resid, dist = _centre_errors(centres, c_est)
    losses = (float(res.loss1), float(res.loss2))
    ok = resid < GA_CENTRE_BAR and dist < GA_DIST_BAR and all(np.isfinite(losses))

    anchor_xy, core0, corres, scores = co.build_correspondences(kw["canonical_depths"], kw["pair_matches"],
                                                                kw["subsample"])
    root, edges = co.compute_min_spanning_tree(scores)
    short = {}
    for dev in (device, "cpu"):
        f32 = dict(dtype=torch.float32, device=dev)
        short[str(dev)] = co.sparse_scene_optimizer(
            torch.as_tensor(kw["imsizes"], **f32), torch.as_tensor(kw["pps"], **f32),
            torch.as_tensor(kw["base_focals"], **f32), torch.as_tensor(core0, device=dev),
            torch.as_tensor(anchor_xy, device=dev), co.correspondences_to_device(corres, dev),
            mst_root=root, mst_edges=edges, cfg=dataclasses.replace(cfg, niter1=GA_STEPS, niter2=0))
    card, cpu = short[str(device)], short["cpu"]
    scale = float(cpu.pts3d.abs().max())
    step_err = max(float((getattr(card, n).cpu() - getattr(cpu, n)).abs().max()) for n in ("cam2w", "pts3d")) / scale
    ok_steps = step_err <= GA_TOL

    f32 = dict(dtype=torch.float32, device=device)
    N = len(kfs)
    c2w = torch.as_tensor(np.stack([np.linalg.inv(np.asarray(slam.dataset.poses[k], np.float64)) for k in kfs]), **f32)
    args = (torch.as_tensor(depths, **f32), torch.zeros(depths.shape, **f32), c2w,
            torch.full((N,), sub.fx, **f32), torch.as_tensor(np.tile([[sub.cx, sub.cy]], (N, 1)), **f32))
    gen = torch.Generator(device=device).manual_seed(0)
    refined = co.tsdf_refine_depths(*args, gen, thresh=0.1)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    refined = co.tsdf_refine_depths(*args, gen, thresh=0.1)
    _sync(device)
    tsdf_ms = 1e3 * (time.perf_counter() - t0)
    moved = float((refined - args[0]).abs().max())
    finite = bool(torch.isfinite(refined).all())
    n_matches = [len(p[2]) for p in kw["pair_matches"]]
    print(f"cloud opt [prior run's keyframes {kfs} at {kw['imsizes'][0][0]}x{kw['imsizes'][0][1]}, oracle depths and "
          f"matches, {len(n_matches)} pairs of {min(n_matches)}-{max(n_matches)} matches, root {root}]: "
          f"sparse GA {cfg.niter1} + {cfg.niter2} steps in {ga_s:.3f} s, "
          f"{1e3 * ga_s / (cfg.niter1 + cfg.niter2):.3f} ms per Adam step; losses {losses[0]:.6f} (3D) and "
          f"{losses[1]:.6f} (2D); camera centres against the truth: Umeyama residual {resid:.4f} of the scene "
          f"(bar {GA_CENTRE_BAR}), pairwise distances {dist:.4f} (bar {GA_DIST_BAR}) {'ok' if ok else 'MISSES'}",
          flush=True)
    print(f"cloud opt: {GA_STEPS} phase-1 Adam steps on the card against the CPU: {step_err:.3e} of the scene's "
          f"scale (tolerance {GA_TOL:.0e}), loss1 {float(card.loss1):.7f} and {float(cpu.loss1):.7f} "
          f"{'ok' if ok_steps else 'DISAGREES'}; TSDF refinement, one pass of 128 samples a pixel over {N} "
          f"views: {tsdf_ms:.3f} ms, depths moved up to {moved:.4f}, finite {finite}", flush=True)
    if not ok:
        fail("sparse global alignment does not recover the prior run's cameras")
    if not ok_steps:
        fail("sparse global alignment's short run on the card differs from the CPU's")
    if not finite:
        fail("the TSDF refinement gave non-finite depths")
    return {"ga_ms_per_step": 1e3 * ga_s / (cfg.niter1 + cfg.niter2), "tsdf_ms": tsdf_ms}


def run_coarse_to_fine(net, ds) -> None:
    """Phase 3 (d): refine_matches on street frames 0 and 5 at full
    resolution (1226x370) with the network phase's full-width random-weight
    MASt3R: integer matches inside both frames; the crop pairs it ran, the
    matches and the seconds."""
    import numpy as np

    from lvdgs_torch.models.mast3r.coarse_to_fine import refine_matches

    img1, img2 = ds[0][0], ds[5][0]
    calls = []
    infer = net.infer_pair

    def counted(a, b):
        calls.append((tuple(a.shape[1:]), tuple(b.shape[1:])))
        return infer(a, b)
    net.infer_pair = counted
    _sync(img1.device)
    t0 = time.perf_counter()
    try:
        m1, m2 = refine_matches(net, img1, img2)
    finally:
        del net.infer_pair
    _sync(img1.device)
    seconds = time.perf_counter() - t0
    (H1, W1), (H2, W2) = img1.shape[1:], img2.shape[1:]
    inside = all(m.dtype == np.int64 and (m >= 0).all() and (m[:, 0] < w).all() and (m[:, 1] < h).all()
                 for m, h, w in ((m1, H1, W1), (m2, H2, W2)))
    ok = inside and len(m1) == len(m2) > 0
    print(f"coarse to fine [street frames 0 and 5 at {W1}x{H1}, MASt3RConfig() random weights]: {len(calls) - 1} "
          f"crop pairs (crop shapes {calls[1:]}), {len(m1)} matches, {seconds:.3f} s, integer and inside both "
          f"frames: {inside} {'ok' if ok else 'WRONG'}", flush=True)
    if not ok:
        fail("coarse-to-fine matching gave no matches, or matches outside the frames")


def run_dinov2(device, ds) -> dict:
    """Phase 3 (e): DINOv2Config() (ViT-B/14) with seeded random weights,
    saved in the torch.hub layout (with its mask_token) and loaded strictly
    onto the card and onto the CPU; one forward on street frame 0 resized
    to 1218x364 (87x26 patches, so the 37x37 position embedding resizes
    down one axis and up the other), the final tokens and the last block's
    attention held card against CPU (DINO_TOL, DINO_ATTN_TOL), and each
    block's tokens and attention too; the parameter count and the forward's
    ms. The LayerScale gammas are drawn in [0.5, 1.5): init_params's 1e-5
    would leave each block's update at about 1e-5 of the stream, where a
    wrong block would not show in the tokens."""
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F

    from lvdgs_torch.models.dinov2 import DINOv2Config, dinov2_forward, init_params, load_hub
    from lvdgs_torch.tools.timing import time_ms

    cfg = DINOv2Config()
    gen = torch.Generator(device=device).manual_seed(0)
    model = init_params(cfg, gen, device)
    with torch.no_grad():
        for blk in model.blocks:
            for ls in (blk.ls1, blk.ls2):
                ls.gamma.copy_(torch.rand(cfg.dim, generator=gen, device=device) + 0.5)
    n_params = sum(p.numel() for p in model.parameters())
    hub = dict(model.state_dict())
    hub["mask_token"] = torch.zeros(1, cfg.dim, device=device)
    tmp = tempfile.mkdtemp(prefix="lvdgs_dinov2_")
    try:
        path = os.path.join(tmp, "dinov2_vitb14.pth")
        torch.save(hub, path)
        card, host = load_hub(path, cfg, device=device), load_hub(path, cfg, device="cpu")
    finally:
        shutil.rmtree(tmp)
    same = all(torch.equal(v, model.state_dict()[k]) for k, v in card.state_dict().items())
    del model, hub
    hw = (364, 1218)
    mean = torch.tensor([0.485, 0.456, 0.406], device=device)[:, None, None]
    std = torch.tensor([0.229, 0.224, 0.225], device=device)[:, None, None]
    x = ((F.interpolate(ds[0][0][None], size=hw, mode="bilinear", align_corners=False) - mean) / std).float()
    out = dinov2_forward(card, x)
    t0 = time.perf_counter()
    ref = dinov2_forward(host, x.cpu())
    cpu_s = time.perf_counter() - t0
    err = float((out["final"].cpu() - ref["final"]).abs().max()) / float(ref["final"].abs().max())
    att = float((out["attn"][-1].cpu() - ref["attn"][-1]).abs().max())
    blk_err, blk_att, prev = [], [], None
    for t_card, t_cpu, a_card, a_cpu in zip(out["tokens"], ref["tokens"], out["attn"], ref["attn"]):
        upd = t_cpu if prev is None else t_cpu - prev
        blk_err.append(float((t_card.cpu() - t_cpu).abs().max()) / float(upd.abs().max()))
        blk_att.append(float((a_card.cpu() - a_cpu).abs().max()))
        prev = t_cpu
    ms = time_ms(lambda: dinov2_forward(card, x), reps=5, warmup=1)
    ok = (same and out["grid"] == (26, 87) and err <= DINO_TOL and att <= DINO_ATTN_TOL
          and len(out["tokens"]) == len(out["attn"]) == cfg.depth
          and max(blk_err) <= DINO_TOL and max(blk_att) <= DINO_ATTN_TOL)
    print(f"dinov2 [DINOv2Config(), {n_params} parameters, hub layout loaded strictly, weights equal {same}; street "
          f"frame 0 at {hw[1]}x{hw[0]}, grid {out['grid']}]: final tokens against the CPU {err:.3e} of their largest "
          f"magnitude (tolerance {DINO_TOL:.0e}), last block's attention {att:.3e} (tolerance {DINO_ATTN_TOL:.0e}); "
          f"blocks' tokens {min(blk_err):.3e}-{max(blk_err):.3e} of their updates, attention up to "
          f"{max(blk_att):.3e} (LayerScale drawn in [0.5, 1.5)); "
          f"forward {ms:.3f} ms on the card (the CPU's {cpu_s:.1f} s) {'ok' if ok else 'DISAGREES'}", flush=True)
    if not ok:
        fail("DINOv2 on the card disagrees with its CPU self, or did not load as saved")
    del card, host, out, ref
    torch.cuda.empty_cache()
    return {"forward_ms": ms}


# Phase (f), the multi-device paths, against single-device at the
# reference's tolerances (tests/test_parallel.py): tile-sharded tracking
# (:179-185), camera-DP mapping (:127-134), the sharded mapping step
# (:52-60)
TRACK_R_TOL, TRACK_T_TOL, TRACK_LOSS_RTOL, TRACK_IMAGE_TOL = 2e-4, 5e-4, 5e-3, 1e-3
# ... but at the street's 1.36 million image values, poses ~1e-6 apart
# switch a few contributions across the 1/255 alpha cut (8 values above
# 1e-3 in the first run, PERF.md §6): the image is held to TRACK_IMAGE_TOL
# at all but this share of its values, and every value to two such
# contributions (2/255)
TRACK_IMAGE_SHARE, TRACK_IMAGE_FLIP = 1e-5, 2.0 / 255.0
DP_LOSS_RTOL, DP_PARAM_TOL, DP_R_TOL = 1e-5, 5e-3, 1e-5
STEP_LOSS_RTOL, STEP_PARAM_TOL, STEP_CLOSE, STEP_CLOSE_FRAC = 1e-5, 6e-3, 1e-6, 0.95
# (f1)'s pose perturbation (tests/test_parallel.py:166), (f2)'s iterations
# (:117), the ranks of (f1)-(f4), all on one card through gloo
TRACK_TAU = (0.02, -0.015, 0.01, 0.004, -0.003, 0.002)
DP_MAP_ITERS = 4
RANKS = 2


def parallel_config(frames: int, data_parallel: bool) -> dict:
    """street.yaml as the packed run has it, with Performance.data_parallel."""
    from lvdgs_torch.core.config import load_config

    config = load_config(os.path.join(ROOT, "configs/mono/synthetic/street.yaml"))
    config["Performance"].update({"synced_timers": True, "data_parallel": data_parallel})
    config["Training"]["mono_scale_servo"] = False
    config["Results"]["eval_rendering"] = True
    config["Dataset"]["n_frames"] = frames
    return config


def parallel_inputs(slam) -> dict:
    """(f1)-(f3)'s inputs from a SLAM holding the packed run's final state:
    the newest keyframe perturbed by TRACK_TAU; the tracking configs with a
    budget that does not bind (max_per_tile), no saturation feedback and no
    period linearisation, as the sharded tracker renders; the window; the
    sharded step's batch of the window's two newest keyframes."""
    import dataclasses

    import torch
    from lvdgs_torch.core import lie
    from lvdgs_torch.slam.state import camera_from_slot

    kb = slam.kfbuf
    cam = camera_from_slot(kb, slam.kf_slots[slam.kf_indices[-1]])
    R, T = lie.apply_delta(cam.R, cam.T, torch.tensor(TRACK_TAU, device=cam.R.device))
    slots = [s for s in slam._window_slots() if s >= 0][:2]
    batch = {"images": kb.images_u8[slots].to(torch.float32) / 255.0, "mono_depths": kb.mono_depth[slots],
             "Rs": kb.R[slots], "Ts": kb.T[slots], "taus": torch.zeros((len(slots), 6), device=kb.R.device)}
    return {"cam": cam.update_RT(R, T),
            "rcfg": dataclasses.replace(slam.rcfg_track, slot_budget_per_tile=slam.rcfg.max_per_tile,
                                        saturation_feedback=False),
            "tcfg": dataclasses.replace(slam.tcfg, lin_period=False), "window": slam._window_slots(),
            "batch": batch}


def sharded_step(slam, mesh, batch) -> dict:
    """(f3): one step of make_sharded_mapping_step on `mesh` from zero Adam
    moments and the SLAM's map, dense renders: this rank's rows, on the
    host."""
    import torch
    from lvdgs_torch.parallel import make_sharded_mapping_step

    params = slam.gmap.params()
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    step, shard_fn = make_sharded_mapping_step(mesh, slam.intr, slam.rcfg)
    p, a, m, v, cb = shard_fn(params, slam.gmap.active, zeros, zeros, batch)
    t0 = time.perf_counter()
    new_p, _m, _v, _count, loss = step(p, a, m, v, 0, cb["images"], cb["mono_depths"], cb["Rs"], cb["Ts"],
                                       cb["taus"])
    _sync(slam.device)
    return {"params": {k: x.cpu() for k, x in new_p.items()}, "loss": float(loss), "s": time.perf_counter() - t0,
            "coords": (mesh.get_local_rank("data"), mesh.get_local_rank("gauss"))}


def parallel_rank(rank: int, state_path: str, config: dict, dp_config: dict, device: str) -> dict:
    """One of phase (f)'s RANKS gloo ranks, all on `device`: (f1), (f3) and
    (f2) from the packed run's state saved at `state_path` by a SLAM of
    `config`, then (f4), the data-parallel street run of `dp_config`.
    Returns this rank's results on the host."""
    import torch
    from lvdgs_torch.eval.ate import eval_ate
    from lvdgs_torch.ops import rasterizer_cuda as rc
    from lvdgs_torch.parallel import make_mesh
    from lvdgs_torch.slam.mapping import mapping_run
    from lvdgs_torch.slam.system import SLAM
    from lvdgs_torch.slam.tracking import track_camera_sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    mesh = make_mesh(device=dev)
    out = {}
    base = SLAM(config, save_dir=None, device=dev)
    base.load_state(state_path)
    inp = parallel_inputs(base)
    t0 = time.perf_counter()
    res = track_camera_sharded(base.gmap.params(), base.gmap.active, inp["cam"], base.intr, inp["rcfg"],
                               inp["tcfg"], mesh)
    _sync(dev)
    out["f1"] = {"R": res.R.cpu(), "T": res.T.cpu(), "loss": float(res.loss), "image": res.image.cpu(),
                 "iterations": res.iterations, "touched": int((res.n_touched > 0).sum()),
                 "s": time.perf_counter() - t0}
    # the sharded step before (f2) moves the map
    out["f3 (2, 1)"] = sharded_step(base, mesh, inp["batch"])
    out["f3 (1, 2)"] = sharded_step(base, make_mesh(1, RANKS, device=dev), inp["batch"])
    t0 = time.perf_counter()
    res = mapping_run(base.gmap, base.opt_state, base.kfbuf, inp["window"], torch.Generator().manual_seed(0),
                      base.iteration_count, DP_MAP_ITERS, intr=base.intr, rcfg=base.rcfg_map, opt=base.opt,
                      mcfg=base.mcfg, mesh=mesh)
    _sync(dev)
    out["f2"] = {"params": {k: v.cpu() for k, v in base.gmap.params().items()}, "R": base.kfbuf.R.cpu(),
                 "loss": float(res.last_loss), "s": time.perf_counter() - t0}
    del base, inp
    torch.cuda.empty_cache()
    slam = SLAM(dp_config, save_dir=None, device=dev, mesh=mesh)
    for w in rc.KERNEL_WRAPPERS:
        w.launches.reset()
    t0 = time.perf_counter()
    results = slam.run(progress=False)
    _sync(dev)
    out["f4"] = {
        "wall": time.perf_counter() - t0, "fps": results["fps"], "sharded": slam.mesh is not None,
        "launches": {w.__name__: w.launches.count for w in rc.KERNEL_WRAPPERS},
        "shapes": {w.__name__: w.launches.by_shape for w in (rc.packed_blend_forward, rc.packed_blend_backward)},
        "state": street_state(slam), "kf_indices": list(slam.kf_indices), "psnr": results["mean_psnr"],
        "ate": float(eval_ate(slam.frames, slam.kf_indices, None, len(slam.frames), final=True,
                              monocular=True)),
        "timers": {k: round(t["total_s"], 3) for k, t in results["timers"].items()},
    }
    return out


def _tensors(d: dict) -> dict:
    """The tensors of a rank's result, nested dicts flattened."""
    import torch

    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update({f"{k} {n}": x for n, x in _tensors(v).items()})
        elif isinstance(v, torch.Tensor):
            out[k] = v
    return out


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def run_parallel(device, slam, frames: int) -> dict:
    """Phase (f), the multi-device paths on the one card: B4 and B5 (and
    their bf16 variants) at the street's tile-sharded layout (2 ranks of 12
    of the 24 tile rows of an 80-tile-wide padded grid: goff 960 for the
    second block) against their plain versions and timed; the NCCL
    collectives at world size 1 (two NCCL ranks cannot share a card); then
    RANKS gloo ranks on the card (lvdgs_torch.parallel.launch): (f1)
    track_camera_sharded from the packed run's final state against
    track_camera, (f2) one camera-DP mapping_run of DP_MAP_ITERS iterations
    over its window against mapping_run, (f3) the sharded mapping step at
    (2, 1) and (1, 2) against (1, 1) (here, in the NCCL world of one), all
    at the reference's tolerances ((f1)'s image: see TRACK_IMAGE_SHARE),
    and every rank's result bit for bit rank 0's; (f4) SLAM.run with Performance.data_parallel on `frames` street
    frames: the ranks' maps and poses equal bit for bit, ATE < 0.08 m,
    PSNR > 17 dB, at least 2 keyframes after init, and B4 and B5 launched
    at the sharded pack's shape. Two ranks on one card measure correctness
    and the host's cost of the collectives, not scaling. Returns (f4)'s
    launches, both ranks' summed."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from lvdgs_torch.ops.rasterizer_cuda import KC
    from lvdgs_torch.parallel import make_mesh
    from lvdgs_torch.parallel.launch import spawn, world_of_one
    from lvdgs_torch.slam.mapping import mapping_run
    from lvdgs_torch.slam.system import SLAM
    from lvdgs_torch.slam.tracking import shard_layout, track_camera
    from lvdgs_torch.tools.blocks import sharded_track_block

    t0 = time.perf_counter()
    args, G, ntx = sharded_track_block(slam, RANKS, 1)
    goff = int(args[3])
    print(f"phase (f): the street's sharded layout, rank 1 of {RANKS}: goff {goff}, {ntx} tile columns, "
          f"{G} groups, NB {args[0].shape[0]}", flush=True)
    if (goff, ntx, G) != (960, 80, 60):
        fail(f"the street's sharded layout is goff {goff}, ntx {ntx}, G {G}, not 960, 80, 60")
    check_packed(args, G, ntx, f"sharded layout, goff {goff}", bf16=True, bf16_gate=False)
    del args
    print(f"phase (f) B4/B5 at goff {goff}: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="lvdgs_parallel_")
    state_path = os.path.join(work, "state")
    slam.save_state(state_path)
    config, dp_config = parallel_config(frames, False), parallel_config(frames, True)
    ref = SLAM(config, save_dir=None, device=device)
    ref.load_state(state_path)
    inp = parallel_inputs(ref)
    with world_of_one("nccl", device):
        x = torch.arange(8, dtype=torch.float32, device=device)
        outs = [x.clone(), torch.empty_like(x), torch.empty_like(x)]
        dist.all_reduce(outs[0])
        dist.all_gather_into_tensor(outs[1], x)
        dist.reduce_scatter_tensor(outs[2], x)
        _sync(device)
        ok = all(torch.equal(o, x) for o in outs)
        print(f"phase (f) {dist.get_backend()} at world size 1 on {device}: all_reduce, all_gather_into_tensor, "
              f"reduce_scatter_tensor {'ok' if ok else 'WRONG'}", flush=True)
        if not ok:
            fail("the NCCL collectives at world size 1 do not return their input")
        step11 = sharded_step(ref, make_mesh(1, 1, device=device), inp["batch"])
    track1 = track_camera(ref.gmap.params(), ref.gmap.active, inp["cam"], ref.intr, inp["rcfg"], inp["tcfg"])
    map1 = mapping_run(ref.gmap, ref.opt_state, ref.kfbuf, inp["window"], torch.Generator().manual_seed(0),
                       ref.iteration_count, DP_MAP_ITERS, intr=ref.intr, rcfg=ref.rcfg_map, opt=ref.opt,
                       mcfg=ref.mcfg)
    map1 = ({k: v.cpu() for k, v in ref.gmap.params().items()}, ref.kfbuf.R.cpu(), float(map1.last_loss))
    del ref, inp
    torch.cuda.empty_cache()
    print(f"phase (f) single-device references and the NCCL check: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    try:
        outs = spawn(parallel_rank, RANKS, backend="gloo", device=device,
                     args=(state_path, config, dp_config, str(device)), timeout=600.0, join_timeout=900.0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase (f) {RANKS} gloo ranks on {device}, (f1)-(f4): {time.perf_counter() - t0:.1f} s", flush=True)
    for key in ("f1", "f2", "f3 (2, 1)"):
        for r in range(1, RANKS):
            if not same_state(_tensors(outs[r][key]), _tensors(outs[0][key]), f"phase ({key}) rank {r} against 0"):
                fail(f"({key}) rank {r}'s result differs from rank 0's")
    secs = lambda key: ", ".join(f"rank {r} {o[key]['s']:.2f} s" for r, o in enumerate(outs))  # noqa: E731

    o = outs[0]["f1"]
    diff = (o["image"] - track1.image.cpu()).abs()
    err = {"R": _max_err(o["R"], track1.R.cpu()), "T": _max_err(o["T"], track1.T.cpu()),
           "image": float(diff.max()), "share": float((diff > TRACK_IMAGE_TOL).double().mean()),
           "loss": abs(o["loss"] - float(track1.loss)) / abs(float(track1.loss))}
    ok = (err["R"] <= TRACK_R_TOL and err["T"] <= TRACK_T_TOL and err["share"] <= TRACK_IMAGE_SHARE
          and err["image"] <= TRACK_IMAGE_FLIP and err["loss"] <= TRACK_LOSS_RTOL and o["touched"] > 0)
    print(f"phase (f1) track_camera_sharded on {RANKS} ranks against track_camera: {o['iterations']} and "
          f"{track1.iterations} iterations, R {err['R']:.3e} (<= {TRACK_R_TOL}), T {err['T']:.3e} "
          f"(<= {TRACK_T_TOL}), loss {err['loss']:.3e} relative (<= {TRACK_LOSS_RTOL}), image "
          f"{int((diff > TRACK_IMAGE_TOL).sum())} of {diff.numel()} values above {TRACK_IMAGE_TOL} (share "
          f"<= {TRACK_IMAGE_SHARE}; {int((diff > 1e-4).sum())} above 1e-4), largest {err['image']:.3e} "
          f"(<= {TRACK_IMAGE_FLIP:.3e}), {o['touched']} Gaussians touched; {secs('f1')} "
          f"{'ok' if ok else 'DISAGREES'}", flush=True)
    if not ok:
        fail("(f1) tile-sharded tracking disagrees with single-device tracking")

    o = outs[0]["f2"]
    params1, R1, loss1 = map1
    err = {"params": max(_max_err(o["params"][k], params1[k]) for k in params1), "R": _max_err(o["R"], R1),
           "loss": abs(o["loss"] - loss1) / abs(loss1)}
    ok = err["params"] <= DP_PARAM_TOL and err["R"] <= DP_R_TOL and err["loss"] <= DP_LOSS_RTOL
    print(f"phase (f2) camera-DP mapping_run on {RANKS} ranks ({DP_MAP_ITERS} iterations) against mapping_run: "
          f"loss {err['loss']:.3e} relative (<= {DP_LOSS_RTOL}), map parameters {err['params']:.3e} "
          f"(<= {DP_PARAM_TOL}), window R {err['R']:.3e} (<= {DP_R_TOL}); {secs('f2')} "
          f"{'ok' if ok else 'DISAGREES'}", flush=True)
    if not ok:
        fail("(f2) camera-DP mapping disagrees with single-device mapping")

    for key in ("f3 (2, 1)", "f3 (1, 2)"):
        # data row 0's ranks in gauss order hold the map's rows in order
        rows = [o[key] for o in sorted(outs, key=lambda o: o[key]["coords"][1]) if o[key]["coords"][0] == 0]
        full = {k: torch.cat([x["params"][k] for x in rows]) for k in step11["params"]}
        lerr = abs(outs[0][key]["loss"] - step11["loss"]) / abs(step11["loss"])
        perr = max(_max_err(full[k], step11["params"][k]) for k in full)
        frac = min(float(((full[k] - step11["params"][k]).abs() < STEP_CLOSE).double().mean()) for k in full)
        ok = lerr <= STEP_LOSS_RTOL and perr <= STEP_PARAM_TOL and frac >= STEP_CLOSE_FRAC
        print(f"phase ({key}) sharded mapping step against (1, 1): loss {lerr:.3e} relative "
              f"(<= {STEP_LOSS_RTOL}), parameters {perr:.3e} (<= {STEP_PARAM_TOL}), the fewest within "
              f"{STEP_CLOSE} {frac:.4f} (>= {STEP_CLOSE_FRAC}); {secs(key)}, (1, 1) {step11['s']:.2f} s "
              f"{'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            fail(f"({key}) the sharded mapping step disagrees with the (1, 1) step")

    cfg = slam.rcfg_track
    lay = shard_layout(slam.intr, cfg, RANKS, 0)
    shape = (lay.T_local * cfg.slot_budget_per_tile // (KC * cfg.tile_group), lay.groups_per)
    launches = {}
    for r, o in enumerate(outs):
        f4 = o["f4"]
        print(f"phase (f4) rank {r}: SLAM.run with data_parallel on {frames} street frames "
              f"({'sharded' if f4['sharded'] else 'NOT SHARDED'}): wall {f4['wall']:.1f} s, {f4['fps']:.4f} fps, "
              f"keyframes {f4['kf_indices']}, timers (s) {json.dumps(f4['timers'])}", flush=True)
        print(f"phase (f4) rank {r} launches: {json.dumps(f4['launches'])}; packed by (NB, G): "
              f"{ {n: {str(k): c for k, c in by.items()} for n, by in f4['shapes'].items()} }", flush=True)
        if not f4["sharded"]:
            fail(f"(f4) rank {r} ran without its mesh")
        for name in ("packed_blend_forward", "packed_blend_backward"):
            if f4["shapes"][name].get(shape, 0) == 0:
                fail(f"(f4) rank {r}: {name} was never launched at the sharded pack (NB, G) = {shape}")
        for name, n in f4["launches"].items():
            launches[name] = launches.get(name, 0) + n
        if r and (f4["kf_indices"] != outs[0]["f4"]["kf_indices"] or not same_state(
                f4["state"], outs[0]["f4"]["state"], f"phase (f4) rank {r}'s map and poses against rank 0's")):
            fail(f"(f4) rank {r}'s map or poses differ from rank 0's")
    f4 = outs[0]["f4"]
    n_after_init = len(f4["kf_indices"]) - 1
    print(f"phase (f4): ATE RMSE {f4['ate']:.4f} m, PSNR {f4['psnr']:.3f} dB, {n_after_init} keyframes after "
          f"init, B4/B5 at the sharded pack (NB, G) = {shape}", flush=True)
    if not (f4["ate"] < ATE_LIMIT and f4["psnr"] > PSNR_LIMIT):
        fail(f"(f4) ATE {f4['ate']:.4f} m or PSNR {f4['psnr']:.3f} dB misses {ATE_LIMIT} m / {PSNR_LIMIT} dB")
    if n_after_init < 2:
        fail(f"(f4) only {n_after_init} keyframes after init; the path needs at least 2")
    return launches


def deterministic_street(device, frames: int, out: str, against: str | None, packed: bool) -> None:
    """The float32 street run, packed or dense, under
    torch.use_deterministic_algorithms(True), where it repeats bit for bit:
    its final map and poses are written to `out` and, with `against` (a file
    that this mode wrote, from this checkout or another), compared with
    those bit for bit; any difference fails. The ATE and PSNR limits are
    printed, not held: the comparison is the result."""
    import torch

    torch.use_deterministic_algorithms(True)
    _launches, slam = run_slam(device, frames, packed=packed, hold_limits=False)
    state = street_state(slam)
    torch.save(state, out)
    print(f"deterministic street run: {len(state)} final map and pose tensors written to {out}",
          flush=True)
    if against:
        if not same_state(state, torch.load(against), f"deterministic street run against {against}"):
            fail(f"the deterministic street run differs from {against}")


def street_state(slam) -> dict:
    """A street run's final map and poses, on the host."""
    import torch

    state = {f"map {k}": v.detach().cpu() for k, v in slam.gmap.params().items()}
    state["active"] = slam.gmap.active.cpu()
    for i, f in slam.frames.items():
        state[f"frame {i} R"] = torch.as_tensor(f["R"]).cpu()
        state[f"frame {i} T"] = torch.as_tensor(f["T"]).cpu()
    return state


def same_state(state: dict, other: dict, label: str) -> bool:
    """Whether two street_state dicts are equal bit for bit (printed)."""
    import torch

    names = sorted(state.keys() | other.keys())
    differ = [k for k in names if k not in state or k not in other or not torch.equal(state[k], other[k])]
    print(f"{label}: {len(differ)} of {len(names)} tensors differ {differ[:8]}", flush=True)
    return not differ


def check_default_budgets(device) -> None:
    """A config with no budget keys renders packed on the card, as the
    reference does off the CPU: tracking at 96, mapping at 128, both with
    saturation feedback, binning the active prefix (the bucket); the exact
    renders dense."""
    from lvdgs_torch.core.config import load_config
    from lvdgs_torch.slam.system import SLAM

    config = load_config(os.path.join(ROOT, "configs/mono/synthetic/base_config.yaml"))
    if any("budget" in k or "feedback" in k for k in config.get("Performance", {})):
        fail("base_config.yaml sets a packed budget; the default check needs a config without")
    slam = SLAM(config, save_dir=None, device=device)
    t, m = slam.rcfg_track, slam.rcfg_map
    ok = (t.use_packed and t.slot_budget_per_tile == 96 and t.saturation_feedback
          and m.use_packed and m.slot_budget_per_tile == 128 and m.saturation_feedback
          and not slam.rcfg.use_packed and slam._bin_bucket_enable)
    def describe(cfg):
        return (f"packed at {cfg.slot_budget_per_tile}, feedback {cfg.saturation_feedback}"
                if cfg.use_packed else "dense")

    print(f"defaults on {device.type} (base_config.yaml, no budget keys): tracking {describe(t)}, "
          f"mapping {describe(m)}, exact renders {describe(slam.rcfg)}, binning bucket "
          f"{'on' if slam._bin_bucket_enable else 'off'} {'ok' if ok else 'WRONG'}", flush=True)
    if not ok:
        fail("SLAM's defaults on the card are not packed 96/128 with feedback and the binning bucket on")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=20,
                        help="street frames of the packed runs (float32 and its rerun) and of the dynamic and "
                             "prior runs")
    parser.add_argument("--bf16-frames", type=int, default=15,
                        help="street frames of the packed run with blend_bf16 (15 give it 2 keyframes after "
                             "init)")
    parser.add_argument("--dense-frames", type=int, default=14,
                        help="street frames of the dense run (14 give it 2 keyframes after init, 11 only 1)")
    parser.add_argument("--pyramid-frames", type=int, default=15,
                        help="street frames of the packed run with pyramid tracking (15 give it 2 keyframes "
                             "after init)")
    parser.add_argument("--detector-frames", type=int, default=10,
                        help="street frames of the detector run (its ATE and PSNRs are printed, not held)")
    parser.add_argument("--parallel-frames", type=int, default=11,
                        help="street frames of phase (f)'s data-parallel run (11 give it 2 keyframes after "
                             "init)")
    parser.add_argument("--deterministic-street", metavar="FILE",
                        help="run only the float32 street run (packed, or with --dense dense), under "
                             "deterministic algorithms, and write its final map and poses to FILE "
                             "(no result line)")
    parser.add_argument("--dense", action="store_true",
                        help="with --deterministic-street: the dense street run (--dense-frames)")
    parser.add_argument("--save-blocks", metavar="FILE",
                        help="write the packed and dense runs' final-map slot blocks to FILE "
                             "(for python -m lvdgs_torch.tools.packed_ab --blocks)")
    parser.add_argument("--against", metavar="FILE",
                        help="with --deterministic-street: compare bit for bit with a FILE it wrote")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if args.deterministic_street:
        # cuBLAS repeats its reductions only with this workspace, set before
        # its first call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    if not os.path.isdir(os.path.join(ROOT, "lvdgs_torch")):
        fail("lvdgs_torch/ not found next to chip_smoke.py: run from a checkout of the repo")
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    from lvdgs_torch.tools.timing import card_line

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    if args.deterministic_street:
        deterministic_street(device, args.dense_frames if args.dense else args.frames,
                             args.deterministic_street, args.against, packed=not args.dense)
        return

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
    phases = Phases()
    # what each kernel holds on an SM, and nvcc's report for the packed ones
    attrs = rc.kernel_attrs()
    for name, a in attrs.items():
        print(f"occupancy {name}: {a['registers']} registers, {a['local_bytes']} local (spill) bytes "
              f"per thread, {a['static_smem']} B static shared memory, {a['blocks_per_sm']} blocks per "
              f"SM", flush=True)
    for line in rc.ptxas_log("blend_packed").splitlines():
        if line.strip():
            print(f"ptxas blend_packed.cu: {line.strip()}", flush=True)

    # phase 2
    from lvdgs_torch.tools.blocks import (
        main_path_dense_block, main_path_packed_blocks, main_path_track_block, street_packed_blocks,
    )

    (tp, counts), ntx, street_packed = street_packed_blocks(device)
    report = check_kernels(tp, counts, ntx, "random street-shaped slots")
    packed_report = {}
    for budget, sort, pargs, G in street_packed:
        label = f"random street-shaped slots, budget {budget}, {'sorted with caps' if sort else 'plain'}"
        # the bf16 kernels at the tracking and mapping budgets (the probe
        # has no bf16 form)
        packed_report[budget] = check_packed(pargs, G, ntx, label, bf16=sort)
    check_packed_equals_dense(tp, counts, ntx)
    small_render_check(device)
    resident_report = check_resident(device)
    torch.cuda.empty_cache()
    phases.mark("1-2 build and kernels against their plain versions")

    # phase 3
    check_default_budgets(device)
    launches = {}
    import shutil
    import tempfile

    feed_dir = tempfile.mkdtemp(prefix="lvdgs_feed_")
    for packed, bf16, pyramid, frames in ((True, False, False, args.frames),
                                          (True, True, False, args.bf16_frames),
                                          (False, False, False, args.dense_frames),
                                          (True, False, True, args.pyramid_frames)):
        # the first float32 run writes the feed and the panels (a), and its
        # state goes through the COLMAP export (b)
        first = packed and not bf16 and not pyramid
        run_launches, slam = run_slam(device, frames, packed, bf16, pyramid=pyramid,
                                      feed=feed_dir if first else None)
        if first:
            run_colmap_export(slam)
            shutil.rmtree(feed_dir)
        stages = run_launches.pop("stages", None)
        for name, n in run_launches.items():
            launches[name] = launches.get(name, 0) + n
        if pyramid:
            # B4 and B5 at the coarse stage's pack, on the pyramid run's
            # final map: held against their plain versions and timed
            coarse_args, coarse_G, coarse_ntx, coarse_budget = main_path_track_block(slam, coarse=True)
            coarse_report = check_packed(coarse_args, coarse_G, coarse_ntx,
                                         f"pyramid run's final map, coarse stage, budget {coarse_budget}",
                                         bf16=False)
            coarse_launches = stages["coarse"]
            del coarse_args
        elif packed and not bf16:
            packed_slam = slam
        elif not packed:
            dense_slam = slam
        del slam
        torch.cuda.empty_cache()
        phases.mark(f"3 street run ({'packed' if packed else 'dense'}{' bf16' if bf16 else ''}"
                    f"{' pyramid' if pyramid else ''})")
    # the dynamic street, stopped after half its frames and resumed
    for name, n in run_dynamic(device, args.frames, args.frames // 2).items():
        launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    phases.mark("3 dynamic street, stopped and resumed")
    # the dynamic street again, on the masker build_masker makes with
    # GroundingDINO and SAM at their full widths (random weights)
    for name, n in run_detector(device, args.detector_frames).items():
        launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    phases.mark("3 detector")
    # the MASt3R prior path over the oracle, with global BA; then B3 at the
    # network's resolution on its final map, and the full-width network
    prior_launches, prior_slam = run_prior(device, args.frames)
    for name, n in prior_launches.items():
        launches[name] = launches.get(name, 0) + n
    check_median_subres(prior_slam)
    phases.mark("3 prior")
    # MASt3R's cloud optimisation on the prior run's keyframes (c)
    run_cloud_opt(device, prior_slam)
    phases.mark("(c) cloud optimisation")
    net = run_network(device, prior_slam)
    phases.mark("3 network")
    # coarse-to-fine matching with the network (d), then DINOv2 (e)
    run_coarse_to_fine(net, prior_slam.dataset)
    del net
    torch.cuda.empty_cache()
    phases.mark("(d) coarse-to-fine")
    run_dinov2(device, prior_slam.dataset)
    del prior_slam
    torch.cuda.empty_cache()
    phases.mark("(e) DINOv2")
    # one binning call of the packed run's final map, bucketed and not
    time_binning(packed_slam)
    # the same checks on the slots the packed and the dense path blend
    dense_blocks = {"packed run": main_path_dense_block(packed_slam),
                    "dense run": main_path_dense_block(dense_slam)}
    del dense_slam
    check_kernels(*dense_blocks["packed run"], "main-path slots")
    check_kernels(*dense_blocks["dense run"], "dense-run main-path slots")
    check_gather_transpose(packed_slam)
    blocks, G, bntx = main_path_packed_blocks(packed_slam)
    if args.save_blocks:
        # the final maps' slot blocks, for tools/packed_ab.py --blocks
        to_cpu = lambda xs: [x.cpu() if hasattr(x, "cpu") else x for x in xs]  # noqa: E731
        torch.save({"dense": {k: to_cpu(v) for k, v in dense_blocks.items()},
                    "packed": ([(name, to_cpu(a)) for name, a in blocks], G, bntx)}, args.save_blocks)
        print(f"final-map slot blocks written to {args.save_blocks}", flush=True)
    del dense_blocks
    for name, pargs in blocks:
        # on the map's slots, bf16 against float32 is held by the reference's
        # own measure (check_bf16_main_path), which bounds the image and the
        # map parameters' gradients; the slot-field measure is printed
        check_packed(pargs, G, bntx, f"main-path slots, {name}", timing=(name == "tracking"),
                     bf16=(name != "probe"), bf16_gate=False)
    check_bf16_main_path(packed_slam)
    packed_state = street_state(packed_slam)
    del blocks
    torch.cuda.empty_cache()
    phases.mark("3 checks on the final maps' slots")
    # phase (f): the multi-device paths, from the packed run's final state
    for name, n in run_parallel(device, packed_slam, args.parallel_frames).items():
        launches[name] = launches.get(name, 0) + n
    del packed_slam
    torch.cuda.empty_cache()
    phases.mark("(f) multi-device")
    # the float32 street run once more, after all the card's other work and
    # with the binning bucket off: it must end where the first (bucketed)
    # run did, bit for bit (its launches are not counted in the kernel line)
    _launches, slam = run_slam(device, args.frames, True, bucket=False)
    if not same_state(street_state(slam), packed_state,
                      "packed path, second run (bucket off) against the first (bucket on)"):
        fail("the float32 street run without the bucket does not repeat the bucketed run bit for bit")
    del slam
    torch.cuda.empty_cache()
    phases.mark("3 street run again, bucket off")
    launches.update(run_resident_probe())
    phases.mark("3 resident probe")

    # B4 and B5 (and their bf16 variants) in the JSON line: the tracking
    # budget's shape (NB 348), B4 without touch counts, as tracking and
    # mapping launch it (the pyramid's coarse pack below)
    track = packed_report[96]
    report["packed_blend_forward"] = track["B4 no_nt"]
    report["packed_blend_backward"] = track["B5"]
    report["packed_blend_forward_bf16"] = track["B4-bf16 no_nt"]
    report["packed_blend_backward_bf16"] = track["B5-bf16"]
    report.update(resident_report)
    # B4 and B5 again at the pyramid's coarse pack, under their own keys,
    # with the coarse stage's launches
    report["packed_blend_forward_coarse"] = coarse_report["B4 no_nt"]
    report["packed_blend_backward_coarse"] = coarse_report["B5"]
    launches["packed_blend_forward_coarse"] = coarse_launches["packed_blend_forward"]
    launches["packed_blend_backward_coarse"] = coarse_launches["packed_blend_backward"]
    kernels = []
    for name, r in report.items():
        base = name.removesuffix("_coarse")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[base], "replaces": REPLACES[base],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "kernel_ms": r.get("kernel_ms"),
            "id": KERNEL_IDS[base] + (" (pyramid coarse pack)" if base != name else ""),
            "status": "ported",
            **{k: r[k] for k in ("graph_ms", "library_graph_ms", "zero_ms", "scatter_ms") if k in r},
            **attrs[ATTRS[base]],
        })
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
