"""Windowed mapping, covisibility prune and colour refinement (PyTorch port
of ``lvdgs_tpu/slam/mapping.py``).

One `mapping_run` call is one mapping invocation of the reference backend:
`n_iters` iterations over the keyframe window plus `n_random` replayed
historical keyframes, with the mapping loss, isotropic regularisation, the
densify/prune/opacity-reset cadence, the 3DGS Adam with position LR
schedule, and windowed pose/exposure refinement. Tile bins and replay
keyframes are refreshed every `rebin_every` iterations.

All control flow here depends only on host integers (iteration counters,
window slots, the keyframe count), so the loop never waits on the device.
Cameras whose loss weight is zero (padded window slots, absent replay
keyframes) contribute exactly nothing in the reference; they are skipped
here instead of rendered.

Under saturation feedback (packed renders, RenderConfig.saturation_feedback)
the window cameras' bins come from prepare_bins_with_touched once per
period, and the full-depth probe's visibility, carried through densify's
clone/split/prune, is what the opacity reset and the result's visibility
read: a budget-capped render reports contributors it dropped as untouched.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional

import torch

from ..core import lie
from ..core.camera import Intrinsics
from ..core.losses import isotropic_reg, l1_loss, ssim
from ..gaussian import model as gm
from ..ops.rasterizer import RenderConfig, prepare_bins, prepare_bins_with_touched, rasterize
from .state import KeyframeBuffer


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    window_size: int = 8
    pose_window: int = 3
    n_random: int = 2
    lambda_dssim: float = 0.2
    depth_lambda: float = 0.1
    alpha: float = 0.95
    rgb_boundary_threshold: float = 0.01
    isotropic_weight: float = 10.0
    lr_rot: float = 0.0015
    lr_trans: float = 0.0005
    lr_exposure: float = 0.01
    adam_eps: float = 1e-8
    b1: float = 0.9
    b2: float = 0.999
    # densification
    densify_grad_threshold: float = 0.0002
    percent_dense: float = 0.01
    gaussian_update_every: int = 150
    gaussian_update_offset: int = 50
    gaussian_th: float = 0.7
    gaussian_extent: float = 6.0
    gaussian_reset: int = 2001
    size_threshold: float = 20.0
    # initialisation mode
    initialization: bool = False
    init_gaussian_update: int = 100
    init_gaussian_reset: int = 500
    init_gaussian_th: float = 0.005
    init_gaussian_extent: float = 180.0
    densify_from_iter: int = 500
    monocular: bool = True
    up_pose: bool = True
    rebin_every: int = 20
    bin_margin: float = 16.0


class MappingResult(NamedTuple):
    occ_visibility: torch.Tensor  # (Ws, C) bool, n_touched > 0 per window camera
    iteration_count: int
    last_loss: torch.Tensor


def _adam(m, v, g, it: int, lr, b1, b2, eps):
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    return m, v, lr * (m / (1 - b1**it)) / (torch.sqrt(v / (1 - b2**it)) + eps)


def draw_replay(n_elig: int, generator: torch.Generator) -> tuple[int, int]:
    """Two distinct positions in the eligible list (the same draw as the
    reference: r1 uniform, r2 = r1 + 1 + uniform offset, mod n_elig)."""
    n = max(n_elig, 1)
    r1 = int(torch.randint(0, n, (), generator=generator))
    r2 = (r1 + 1 + int(torch.randint(0, max(n_elig - 1, 1), (), generator=generator))) % n
    return r1, r2


def mapping_run(
    gmap: gm.GaussianMap,
    opt_state: gm.AdamState,
    kfbuf: KeyframeBuffer,
    window_slots: List[int],
    generator: torch.Generator,
    iteration_count: int,
    n_iters: int,
    local_it0: int = 0,
    *,
    intr: Intrinsics,
    rcfg: RenderConfig,
    opt: gm.MapOptimizer,
    mcfg: MappingConfig,
) -> MappingResult:
    """Run `n_iters` mapping iterations. Updates `gmap`, `opt_state` and the
    window poses/exposures in `kfbuf` in place (the reference donated these
    buffers). `generator` (a CPU generator) draws the replay keyframes and
    the split samples."""
    dev = gmap.device
    Ws = len(window_slots)
    Nr = mcfg.n_random
    C = gmap.capacity
    M = kfbuf.capacity
    window_valid = [s >= 0 for s in window_slots]
    safe_slots = [min(max(s, 0), M - 1) for s in window_slots]
    valid_idx = [i for i in range(Ws) if window_valid[i]]
    vslots = torch.tensor([safe_slots[i] for i in valid_idx], dtype=torch.long, device=dev)
    window_frame_idx = kfbuf.frame_idx[vslots].tolist() if valid_idx else []
    frame_of = dict(zip(valid_idx, window_frame_idx))

    # replay eligibility: stored and not in the window
    in_window = {safe_slots[i] for i in valid_idx}
    elig_order = [m for m in range(kfbuf.count) if m not in in_window]
    n_elig = len(elig_order)

    # per-camera optimisation masks (frame 0 is never refined)
    pose_mask = [window_valid[i] and frame_of.get(i) != 0 and i < mcfg.pose_window and mcfg.up_pose
                 for i in range(Ws)]
    expo_mask = [window_valid[i] and frame_of.get(i) != 0 for i in range(Ws)]
    pose_m = torch.tensor(pose_mask, device=dev)[:, None]
    expo_m = torch.tensor(expo_mask, device=dev)[:, None]

    f32 = dict(dtype=torch.float32, device=dev)
    Rw = kfbuf.R[torch.tensor(safe_slots, device=dev)].clone()
    Tw = kfbuf.T[torch.tensor(safe_slots, device=dev)].clone()
    abw = kfbuf.exposure_ab[torch.tensor(safe_slots, device=dev)].clone()
    m_tau, v_tau = torch.zeros((Ws, 6), **f32), torch.zeros((Ws, 6), **f32)
    m_ab, v_ab = torch.zeros((Ws, 2), **f32), torch.zeros((Ws, 2), **f32)
    occ_vis = torch.zeros((Ws, C), dtype=torch.bool, device=dev)
    lr_tau = torch.tensor([mcfg.lr_trans] * 3 + [mcfg.lr_rot] * 3, **f32)
    loss_out = torch.zeros((), **f32)
    it_count = int(iteration_count)
    local_it = int(local_it0)
    local_end = local_it + int(n_iters)

    # per-camera targets, fixed for the run
    def targets(slot):
        image = kfbuf.images_u8[slot].to(torch.float32) / 255.0
        mono = kfbuf.mono_depth[slot]
        mr = (image.sum(0) > mcfg.rgb_boundary_threshold)[None].to(torch.float32)
        md = (mono > 0.01)[None].to(torch.float32)
        return image * mr, mr, mono[None] * md, md

    window_targets = {i: targets(safe_slots[i]) for i in valid_idx}
    use_fb = rcfg.use_packed and rcfg.saturation_feedback

    while local_it < local_end:
        # --- per-period work: replay draw and binning at current poses ---
        if Nr > 0:
            r1, r2 = draw_replay(n_elig, generator)
            # with no eligible keyframe the draw is unused (zero weight)
            replay_slots = [elig_order[r] if r < n_elig else 0 for r in (r1, r2)][:Nr]
        else:
            replay_slots = []
        replay_w = [float(n_elig > 0), float(n_elig > 1)][:Nr]
        # the reference map() is a no-op on an empty window
        if not valid_idx or mcfg.initialization:
            replay_w = [0.0] * Nr
        cams = [("w", i) for i in valid_idx] + [
            ("r", r) for r in range(len(replay_slots)) if replay_w[r] > 0
        ]
        with torch.no_grad():
            p0 = gmap.params()
            bins = {}
            if use_fb:
                # this period's full-depth probe visibility of the window
                occ_vis = torch.zeros((Ws, C), dtype=torch.bool, device=dev)
            for kind, j in cams:
                R, T = (Rw[j], Tw[j]) if kind == "w" else (kfbuf.R[replay_slots[j]], kfbuf.T[replay_slots[j]])
                if use_fb and kind == "w":
                    bins[(kind, j)], occ_vis[j] = prepare_bins_with_touched(
                        p0, gmap.active, R, T, intr, rcfg, margin=mcfg.bin_margin)
                else:
                    bins[(kind, j)] = prepare_bins(p0, gmap.active, R, T, intr, rcfg,
                                                   margin=mcfg.bin_margin)
        replay_targets = {j: targets(replay_slots[j]) for kind, j in cams if kind == "r"}

        stop_at = min(local_it + mcfg.rebin_every, local_end)
        while local_it < stop_at:
            it_count += 1
            local_it += 1
            if mcfg.initialization:
                reset_pred = it_count in (mcfg.init_gaussian_reset, mcfg.densify_from_iter)
            else:
                reset_pred = it_count % mcfg.gaussian_reset == 0
            # under feedback the period probe gives visibility (see above)
            need_nt = (reset_pred or local_it >= local_end) and not use_fb

            # --- per-camera losses; one backward for all of them ---
            params = {k: v.detach().requires_grad_(True) for k, v in gmap.params().items()}
            active = gmap.active
            total = torch.zeros((), **f32)
            taus, abs_, vss, vis_l, radii_l, nt_l = {}, {}, {}, {}, {}, {}
            for kind, j in cams:
                vs = torch.zeros((C, 2), **f32, requires_grad=True)
                if kind == "w":
                    tau = torch.zeros(6, **f32, requires_grad=True)
                    ab = abw[j].detach().requires_grad_(True)
                    taus[j], abs_[j] = tau, ab
                    R, T = lie.apply_delta(Rw[j], Tw[j], tau)
                    gt_m, mr, mono_m, md = window_targets[j]
                    weight = 1.0
                else:
                    slot = replay_slots[j]
                    ab = kfbuf.exposure_ab[slot]
                    R, T = kfbuf.R[slot], kfbuf.T[slot]
                    gt_m, mr, mono_m, md = replay_targets[j]
                    weight = replay_w[j]
                out = rasterize(params, active, R, T, intr, rcfg, vs_offset=vs,
                                bins=bins[(kind, j)], need_n_touched=need_nt)
                image = out.image if mcfg.initialization else torch.exp(ab[0]) * out.image + ab[1]
                li = mcfg.alpha * (image * mr - gt_m).abs().mean() + (1 - mcfg.alpha) * (
                    out.depth * md - mono_m
                ).abs().mean()
                total = total + li * weight
                vss[(kind, j)] = vs
                vis_l[(kind, j)] = out.visibility_filter
                radii_l[(kind, j)] = out.radii
                nt_l[(kind, j)] = out.n_touched
            # isotropic regulariser
            total = total + mcfg.isotropic_weight * isotropic_reg(torch.exp(params["log_scales"]), active)
            order = list(taus)
            leaves = list(params.values()) + [vss[c] for c in cams] + [taus[j] for j in order] + [
                abs_[j] for j in order
            ]
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
            nP = len(params)
            g_params = {k: (g if g is not None else torch.zeros_like(params[k]))
                        for k, g in zip(params, grads[:nP])}
            g_vs = grads[nP:nP + len(cams)]
            g_tau_l = grads[nP + len(cams):nP + len(cams) + len(order)]
            g_ab_l = grads[nP + len(cams) + len(order):]

            with torch.no_grad():
                # densification stats over the rendered (valid) cameras
                if cams:
                    vis_b = torch.stack([vis_l[c] for c in cams]) & active[None]
                    radii_all = torch.stack([radii_l[c] for c in cams])
                    gvs_norm = torch.stack([torch.linalg.norm(g, dim=-1) for g in g_vs])
                    gmap.max_radii2d.copy_(torch.maximum(
                        gmap.max_radii2d,
                        torch.where(vis_b, radii_all, torch.zeros_like(radii_all)).max(dim=0).values,
                    ))
                    gmap.grad_accum.add_((gvs_norm * vis_b).sum(dim=0))
                    gmap.grad_denom.add_(vis_b.sum(dim=0).to(torch.float32))

                # window visibility for the opacity reset and the result
                # (under feedback: the period probe's, after densify below)
                if not use_fb:
                    win_vis = torch.zeros((Ws, C), dtype=torch.bool, device=dev)
                    if need_nt:
                        for i in valid_idx:
                            win_vis[i] = nt_l[("w", i)] > 0

                if mcfg.initialization:
                    do_densify = (local_it - 1) % mcfg.init_gaussian_update == 0
                    do_reset = it_count in (mcfg.init_gaussian_reset, mcfg.densify_from_iter)
                    th, ext, max_screen = mcfg.init_gaussian_th, mcfg.init_gaussian_extent, None
                else:
                    do_densify = it_count % mcfg.gaussian_update_every == mcfg.gaussian_update_offset
                    do_reset = it_count % mcfg.gaussian_reset == 0 and not do_densify
                    th, ext, max_screen = mcfg.gaussian_th, mcfg.gaussian_extent, mcfg.size_threshold
                if do_densify:
                    split_eps = torch.randn((2, C, 3), generator=generator).to(dev)
                    vis_kept = gm.densify_and_prune(
                        gmap, split_eps, grad_threshold=mcfg.densify_grad_threshold,
                        min_opacity=th, extent=ext, max_screen_size=max_screen,
                        percent_dense=mcfg.percent_dense, opt_state=opt_state,
                        aux_vis=occ_vis if use_fb else None,
                    )
                    if use_fb:
                        occ_vis = vis_kept
                if use_fb:
                    win_vis = occ_vis
                if do_reset:
                    if mcfg.initialization:
                        gm.reset_opacity(gmap, opt_state)
                    else:
                        gm.reset_opacity_nonvisible(gmap, win_vis.any(dim=0), opt_state)

                # Gaussian Adam step + LR schedule
                opt.step(gmap, g_params, opt_state, 0 if mcfg.initialization else it_count)

                # keyframe pose/exposure Adam (fresh state per run)
                g_tau = torch.zeros((Ws, 6), **f32)
                g_ab = torch.zeros((Ws, 2), **f32)
                for j, gt_, ga in zip(order, g_tau_l, g_ab_l):
                    # None: the loss does not reach it (no exposure at init)
                    if gt_ is not None:
                        g_tau[j] = gt_
                    if ga is not None:
                        g_ab[j] = ga
                m_tau, v_tau, upd_tau = _adam(m_tau, v_tau, g_tau, local_it, lr_tau[None, :],
                                              mcfg.b1, mcfg.b2, mcfg.adam_eps)
                tau_new = torch.where(pose_m, -upd_tau, torch.zeros_like(upd_tau))
                for j in valid_idx:
                    if pose_mask[j]:
                        Rw[j], Tw[j] = lie.apply_delta(Rw[j], Tw[j], tau_new[j])
                m_ab, v_ab, upd_ab = _adam(m_ab, v_ab, g_ab, local_it, mcfg.lr_exposure,
                                           mcfg.b1, mcfg.b2, mcfg.adam_eps)
                abw = abw - torch.where(expo_m, upd_ab, torch.zeros_like(upd_ab))
                occ_vis = win_vis
                loss_out = total.detach()

    # write refined window poses/exposures back into the buffer
    with torch.no_grad():
        for i in valid_idx:
            kfbuf.R[safe_slots[i]] = Rw[i]
            kfbuf.T[safe_slots[i]] = Tw[i]
            kfbuf.exposure_ab[safe_slots[i]] = abw[i]
    return MappingResult(occ_visibility=occ_vis, iteration_count=it_count, last_loss=loss_out)


def color_refine_run(
    gmap: gm.GaussianMap,
    opt_state: gm.AdamState,
    kfbuf: KeyframeBuffer,
    generator: torch.Generator,
    n_iters: int,
    it0: int = 0,
    *,
    intr: Intrinsics,
    rcfg: RenderConfig,
    opt: gm.MapOptimizer,
    mcfg: MappingConfig,
    features_only: bool = False,
) -> None:
    """Post-SLAM colour refinement, in place: each iteration renders a random
    keyframe and optimises L1 + DSSIM in the keyframe's exposure frame.
    `features_only` freezes the geometry."""
    dev = gmap.device
    bg = torch.full((3,), 1.0 if rcfg.white_background else 0.0, dtype=torch.float32, device=dev)
    for i in range(int(n_iters)):
        slot = int(torch.randint(0, max(kfbuf.count, 1), (), generator=generator))
        params = {k: v.detach().requires_grad_(True) for k, v in gmap.params().items()}
        out = rasterize(params, gmap.active, kfbuf.R[slot], kfbuf.T[slot], intr, rcfg,
                        need_n_touched=False)
        ab = kfbuf.exposure_ab[slot]
        image = torch.exp(ab[0]) * out.image + ab[1]
        gt = kfbuf.images_u8[slot].to(torch.float32) / 255.0
        if bool(kfbuf.has_static[slot]):
            static = kfbuf.static_mask[slot][None]
            image = torch.where(static, image, bg[:, None, None])
            gt = torch.where(static, gt, bg[:, None, None])
        loss = (1.0 - mcfg.lambda_dssim) * l1_loss(image, gt) + mcfg.lambda_dssim * (1.0 - ssim(image, gt))
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if features_only:
            for k in ("means", "log_scales", "quats"):
                grads[k] = torch.zeros_like(grads[k])
        opt.step(gmap, grads, opt_state, it0 + i + 1)


def _prune_from_occ(gmap: gm.GaussianMap, occ_vis, window_slots: List[int], kfbuf: KeyframeBuffer,
                    initialized: bool, *, prune_num: int, window_size: int):
    dev = gmap.device
    Ws = len(window_slots)
    n_obs = occ_vis.sum(dim=0).to(torch.int32)
    gmap.n_obs.copy_(n_obs)
    valid_slots = [s for s in window_slots if s >= 0]
    full_window = len(valid_slots) == window_size
    frame_idx = sorted(
        (kfbuf.frame_idx[torch.tensor(valid_slots, device=dev)].tolist() if valid_slots else [])
        + [-1] * (Ws - len(valid_slots)),
        reverse=True,
    )
    third_newest = frame_idx[min(2, Ws - 1)]
    recent = gmap.unique_kf_ids >= (third_newest if initialized else 0)
    to_prune = (n_obs <= prune_num) & recent & gmap.active & full_window
    gm.prune_points(gmap, to_prune)
    return occ_vis & ~to_prune[None, :], initialized or full_window


@torch.no_grad()
def covisibility_prune(gmap: gm.GaussianMap, kfbuf: KeyframeBuffer, window_slots: List[int],
                       initialized: bool, *, intr: Intrinsics, rcfg: RenderConfig,
                       prune_num: int, window_size: int):
    """Covisibility prune with freshly rendered window visibility, in place:
    accumulate n_obs and prune Gaussians of recent keyframes seen by
    <= prune_num views (full window only). Returns (occ_vis (Ws, C),
    initialized')."""
    M = kfbuf.capacity
    occ = []
    for s in window_slots:
        slot = min(max(s, 0), M - 1)
        out = rasterize(gmap.params(), gmap.active, kfbuf.R[slot], kfbuf.T[slot], intr, rcfg)
        occ.append((out.n_touched > 0) & (s >= 0))
    return _prune_from_occ(gmap, torch.stack(occ), window_slots, kfbuf, initialized,
                           prune_num=prune_num, window_size=window_size)


@torch.no_grad()
def covisibility_prune_from_occ(gmap: gm.GaussianMap, kfbuf: KeyframeBuffer,
                                window_slots: List[int], occ_vis: torch.Tensor, initialized: bool,
                                *, prune_num: int, window_size: int):
    """The same prune reusing a mapping run's final-iteration visibility."""
    valid = torch.tensor([s >= 0 for s in window_slots], device=occ_vis.device)
    return _prune_from_occ(gmap, occ_vis & valid[:, None], window_slots, kfbuf, initialized,
                           prune_num=prune_num, window_size=window_size)
