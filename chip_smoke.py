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
   B3, B4 and B5; with Performance.blend_bf16, which must launch B4-bf16 and
   B5-bf16 and no float32 B5; dense (budgets 0), which must launch B1, B2
   and B3; and as configured with Training.track_pyramid, which must launch
   B1 and B3, and B4 and B5 in both tracking stages (told apart by their
   launch shapes: the coarse stage blends 613x185 in 468 tiles, 30 groups,
   at 192 slots per tile, NB 180); each must end with finite poses and map,
   at least 2 keyframes after init, ATE RMSE < 0.08 m and PSNR > 17 dB;
   right after the pyramid run, hold B4 (with touch counts, without, and
   as the probe) and B5 against their plain versions at the coarse stage's
   pack of its final map from the newest keyframe, and time them; then
   hold the kernels against their plain versions again on the slots the
   packed and the
   dense run's final maps give from their newest keyframes (B1-B3 on both,
   timed beside the random block's), and the packed run's bf16 renders
   against the float32 ones from every keyframe by the reference's own
   measure (image and parameter gradients), and the gather's transpose on
   them against index_select's (its own sum must repeat bit for bit); then
   drive the float32 street run once more, which must end with the first
   run's map and poses bit for bit; then drive the resident-table probe
   (python -m lvdgs_torch.tools.perf_resident), which must launch R1 and R2;
4. print the per-kernel JSON line (B4 and B5 also at the coarse pack, under
   their own names, with the coarse stage's launches), then the result
   line.

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


def run_slam(device, frames: int, packed: bool, bf16: bool = False, hold_limits: bool = True,
             pyramid: bool = False):
    """Phase 3: the SLAM main path on the street scene, as configured
    (packed), as configured with blend_bf16 (bf16) or with
    Training.track_pyramid (pyramid), or with both packed budgets at 0
    (dense). Without `hold_limits` an ATE or PSNR miss is printed and does
    not fail."""
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
    config["Training"]["mono_scale_servo"] = False
    config["Training"]["track_pyramid"] = pyramid
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
          f"{budgets}, blend_bf16 {bf16}, track_pyramid {pyramid}, mono_scale_servo False", flush=True)
    if (packed != slam.rcfg_track.use_packed or packed != slam.rcfg_map.use_packed
            or bf16 != slam.rcfg_track.blend_bf16 or bf16 != slam.rcfg_map.blend_bf16
            or slam.rcfg.blend_bf16 or pyramid != slam.tcfg.pyramid):
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
    return launches, slam


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=20,
                        help="street frames of the packed runs (float32, its rerun, and with the pyramid)")
    parser.add_argument("--bf16-frames", type=int, default=20,
                        help="street frames of the packed run with blend_bf16")
    parser.add_argument("--dense-frames", type=int, default=20,
                        help="street frames of the dense run (11 give only 1 keyframe after init)")
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

    # phase 3
    check_default_budgets(device)
    launches = {}
    for packed, bf16, pyramid, frames in ((True, False, False, args.frames),
                                          (True, True, False, args.bf16_frames),
                                          (False, False, False, args.dense_frames),
                                          (True, False, True, args.frames)):
        run_launches, slam = run_slam(device, frames, packed, bf16, pyramid=pyramid)
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
    del packed_slam, blocks
    torch.cuda.empty_cache()
    # the float32 street run once more, after all the card's other work: it
    # must end where the first did, bit for bit (its launches are not
    # counted in the kernel line)
    _launches, slam = run_slam(device, args.frames, True)
    if not same_state(street_state(slam), packed_state, "packed path, second run against the first"):
        fail("the float32 street run does not repeat bit for bit")
    del slam
    torch.cuda.empty_cache()
    launches.update(run_resident_probe())

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
