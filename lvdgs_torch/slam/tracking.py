"""Frame-to-map tracking (PyTorch port of ``track_camera``,
``track_camera_pyramid`` and ``track_camera_sharded`` in
``lvdgs_tpu/slam/tracking.py``).

Up to `max_iters` Adam steps over a 6-dof se(3) pose delta and an affine
exposure (a, b), each rendering the map and differentiating the
exposure-compensated, opacity-weighted, edge-masked L1 loss. The tile
assignment is recomputed every `rebin_every` steps with a `bin_margin`
pixel slack. Exits: ||tau|| < convergence_eps, max_iters, or a loss plateau
checked at rebin-period boundaries.

On the packed path (RenderConfig.use_packed) with `lin_period`, each rebin
period linearises the per-row fields in the pose once (pose_lin_gather) and
every step renders value + Jacobian . tau_acc (rasterize_lin): a step is
row-local glue and the two packed kernels. Saturation caps are probed at
the first rebin and carried (the map is frozen here), and probed again once
the pose drift since the last probe exceeds `cap_reprobe_drift`. The final
bookkeeping render stays dense.

The reference runs the loops as `lax.while_loop`s on the device. Here they
are Python loops that read device state once per rebin period: within a
period every step runs, and the `done` flag freezes the state after it is
set, exactly as the reference's inner loop would have stopped there.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import lie
from ..core.camera import Camera, Intrinsics
from ..core.log import device_constant, span, sync
from ..core.losses import get_median_depth
from ..ops import rasterizer as rz
from ..ops.rasterizer import (
    PackedBins, RenderConfig, pose_lin_gather, prepare_bins_with_caps, rasterize, rasterize_lin,
    rasterize_pose_lin,
)
from ..ops.rasterizer_cuda import blend_packed
from ..parallel.collectives import all_gather_tiled, all_reduce_flat, all_reduce_sum
from ..parallel.mesh import dim_group, dim_rank, dim_size


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    max_iters: int = 100
    lr_rot: float = 0.003
    lr_trans: float = 0.001
    lr_exposure: float = 0.01
    convergence_eps: float = 1e-4
    rgb_boundary_threshold: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    adam_eps: float = 1e-8
    rebin_every: int = 20
    bin_margin: float = 16.0
    # loss-plateau exit at rebin-period boundaries: stop when a period
    # improved the loss by less than plateau_tol (relative); <= 0 disables
    # pose-linearised backward on the packed path (rasterize_pose_lin), for
    # steps that are not period-linearised
    pose_lin: bool = False
    # period-linearised rendering on the packed path (see the module doc)
    lin_period: bool = True
    plateau_tol: float = 0.005
    plateau_min_iters: int = 40
    # re-probe the saturation caps at the next rebin once the drift metric
    # ||d trans|| + 10 ||d rot|| since the last probe exceeds this
    cap_reprobe_drift: float = 0.02
    # coarse-to-fine (track_camera_pyramid): a half-resolution stage of at
    # most coarse_iters steps seeds the full-resolution one
    pyramid: bool = False
    coarse_iters: int = 60
    coarse_min_iters: int = 20
    fine_min_iters: int = 20  # the fine stage's plateau_min_iters
    # the final dense bookkeeping render (its n_touched); off, n_touched is 0
    final_render: bool = True
    # gate dynamic pixels out of the tracking loss with cam.static_mask
    use_static_mask: bool = False


class TrackResult(NamedTuple):
    R: torch.Tensor
    T: torch.Tensor
    exposure_a: torch.Tensor
    exposure_b: torch.Tensor
    image: torch.Tensor
    depth: torch.Tensor
    opacity: torch.Tensor
    n_touched: torch.Tensor
    median_depth: torch.Tensor
    iterations: int
    loss: torch.Tensor


def track_camera(params, active, cam: Camera, intr: Intrinsics, rcfg: RenderConfig,
                 tcfg: TrackingConfig) -> TrackResult:
    """Optimise the pose/exposure of `cam` (seeded by cam.R/cam.T) against
    the fixed map."""
    params = {k: v.detach() for k, v in params.items()}
    dev = cam.image.device
    gt = cam.image
    rgb_mask = (gt.sum(dim=0) > tcfg.rgb_boundary_threshold) & cam.grad_mask
    if tcfg.use_static_mask:
        rgb_mask = rgb_mask & cam.static_mask
    rgb_mask = rgb_mask[None].to(torch.float32)
    gt_masked = gt * rgb_mask
    lr_tau = device_constant((tcfg.lr_trans,) * 3 + (tcfg.lr_rot,) * 3, torch.float32, dev)
    b1, b2 = tcfg.b1, tcfg.b2

    def step(s: dict, bins, tpj=None) -> dict:
        """One Adam step; a state already `done` passes through unchanged.
        With `tpj` the render is period-linearised at the drift tau_acc."""
        tau = torch.zeros(6, dtype=torch.float32, device=dev, requires_grad=True)
        ab = s["ab"].detach().requires_grad_(True)
        # n_touched is consumed only after the loop (final render below)
        if tpj is not None:
            out = rasterize_lin(tpj, s["tau_acc"] + tau, intr, rcfg, bins)
        elif tcfg.pose_lin and isinstance(bins, PackedBins):
            out = rasterize_pose_lin(params, active, s["R"], s["T"], tau, intr, rcfg, bins)
        else:
            Rn, Tn = lie.apply_delta(s["R"], s["T"], tau)
            out = rasterize(params, active, Rn, Tn, intr, rcfg, bins=bins, need_n_touched=False)
        image_ab = torch.exp(ab[0]) * out.image + ab[1]
        loss = (out.opacity * (image_ab * rgb_mask - gt_masked).abs()).mean()
        g_tau, g_ab = torch.autograd.grad(loss, (tau, ab))
        with torch.no_grad():
            # non-finite guard: skip the update instead of poisoning the pose
            g_tau = torch.where(torch.isfinite(g_tau), g_tau, torch.zeros_like(g_tau))
            g_ab = torch.where(torch.isfinite(g_ab), g_ab, torch.zeros_like(g_ab))
            run = ~s["done"]
            it = s["it"] + run.to(torch.int32)
            itf = it.to(torch.float32)
            c1, c2 = 1 - b1**itf, 1 - b2**itf
            m_tau = b1 * s["m_tau"] + (1 - b1) * g_tau
            v_tau = b2 * s["v_tau"] + (1 - b2) * g_tau * g_tau
            tau_new = -lr_tau * (m_tau / c1) / (torch.sqrt(v_tau / c2) + tcfg.adam_eps)
            m_ab = b1 * s["m_ab"] + (1 - b1) * g_ab
            v_ab = b2 * s["v_ab"] + (1 - b2) * g_ab * g_ab
            ab_new = s["ab"] - tcfg.lr_exposure * (m_ab / c1) / (torch.sqrt(v_ab / c2) + tcfg.adam_eps)
            R, T = lie.apply_delta(s["R"], s["T"], tau_new)
            new = dict(
                R=R, T=T, ab=ab_new, m_tau=m_tau, v_tau=v_tau, m_ab=m_ab, v_ab=v_ab, it=it,
                done=torch.linalg.norm(tau_new) < tcfg.convergence_eps,
                image=out.image.detach(), depth=out.depth.detach(),
                opacity=out.opacity.detach(), loss=loss.detach(),
                # first-order accumulation of the left-multiplied deltas
                tau_acc=s["tau_acc"] + tau_new if tpj is not None else s["tau_acc"],
                drift_acc=s["drift_acc"] + torch.linalg.norm(tau_new[:3])
                + 10.0 * torch.linalg.norm(tau_new[3:]),
            )
            return {k: torch.where(run, v, s[k]) for k, v in new.items()}

    H, W = intr.height, intr.width
    f32 = dict(dtype=torch.float32, device=dev)
    s = dict(
        R=cam.R.to(**f32), T=cam.T.to(**f32),
        ab=torch.stack([cam.exposure_a, cam.exposure_b]).to(**f32),
        m_tau=torch.zeros(6, **f32), v_tau=torch.zeros(6, **f32),
        m_ab=torch.zeros(2, **f32), v_ab=torch.zeros(2, **f32),
        it=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        image=torch.zeros((3, H, W), **f32), depth=torch.zeros((1, H, W), **f32),
        opacity=torch.zeros((1, H, W), **f32), loss=torch.zeros((), **f32),
        tau_acc=torch.zeros(6, **f32), drift_acc=torch.zeros((), **f32),
    )
    it_host, done_host, drift_host = 0, False, 0.0
    caps = None  # saturation caps; None: probe at the next rebin
    while not done_host and it_host < tcfg.max_iters:
        with span("track.bin"):
            # caps stale after a large pose correction since the last probe
            if drift_host > tcfg.cap_reprobe_drift:
                caps = None
                s["drift_acc"] = torch.zeros((), **f32)
            # rebin at the current pose with a pixel-radius margin
            bins, caps = prepare_bins_with_caps(params, active, s["R"], s["T"], intr, rcfg,
                                                tcfg.bin_margin, caps)
            tpj = None
            if tcfg.lin_period and isinstance(bins, PackedBins):
                # linearise the per-row fields at this period's pose; the
                # drift accumulates in tau_acc from zero
                tpj, _ = pose_lin_gather(params, active, s["R"], s["T"], intr, rcfg, bins)
                s["tau_acc"] = torch.zeros(6, **f32)
        with span("track.steps"):
            prev_loss = s["loss"]
            # the period's first step is unconditional; its loss is the
            # plateau baseline of the first period
            s1 = step(s, bins, tpj)
            s2 = s1
            for _ in range(min(tcfg.rebin_every, tcfg.max_iters - it_host) - 1):
                s2 = step(s2, bins, tpj)
            if tcfg.plateau_tol > 0:
                base = torch.where(prev_loss > 0, prev_loss, s1["loss"])
                plateau = (
                    (base > 0)
                    & (s2["it"] >= tcfg.plateau_min_iters)
                    & (base - s2["loss"] < tcfg.plateau_tol * base)
                )
                s2["done"] = s2["done"] | plateau
            s = s2
            flags = torch.stack([s["it"].to(torch.float32), s["done"].to(torch.float32), s["drift_acc"]])
        # the one host read of the period
        with sync():
            it_f, done_f, drift_host = flags.tolist()
        it_host, done_host = int(it_f), bool(done_f)

    with span("track.final"):
        median_depth = get_median_depth(s["depth"], s["opacity"])
        # one exact render at the converged pose for the visibility
        # bookkeeping, dense even when the steps rendered packed: a binding
        # budget drops deep-tile Gaussians, which would skew the keyframe
        # policy's visibility
        if tcfg.final_render:
            rcfg_exact = dataclasses.replace(rcfg, use_packed=False)
            with torch.no_grad():
                final_nt = rasterize(params, active, s["R"], s["T"], intr, rcfg_exact).n_touched
        else:
            final_nt = torch.zeros(params["means"].shape[0], dtype=torch.int32, device=dev)
    return TrackResult(
        R=s["R"], T=s["T"], exposure_a=s["ab"][0], exposure_b=s["ab"][1],
        image=s["image"], depth=s["depth"], opacity=s["opacity"], n_touched=final_nt,
        median_depth=median_depth, iterations=it_host, loss=s["loss"],
    )


def _downsample2_image(img: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> (C, H // 2, W // 2) 2x2 mean pool (odd edges cropped)."""
    C, H, W = img.shape
    H2, W2 = H // 2, W // 2
    return img[:, : H2 * 2, : W2 * 2].reshape(C, H2, 2, W2, 2).mean(dim=(2, 4))


def _downsample2_mask(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) bool -> (H // 2, W // 2) any-pool: a coarse pixel is in if any
    of its fine pixels is."""
    H, W = mask.shape
    H2, W2 = H // 2, W // 2
    return mask[: H2 * 2, : W2 * 2].reshape(H2, 2, W2, 2).any(dim=3).any(dim=1)


def half_res_intrinsics(intr: Intrinsics) -> Intrinsics:
    """Half-resolution intrinsics, pixel centres kept: the fine pixel centre
    u maps to the coarse coordinate (u - 0.5) / 2. Not Intrinsics.scaled,
    which neither shifts the principal point nor floors the size."""
    return Intrinsics(
        fx=intr.fx / 2.0, fy=intr.fy / 2.0, cx=(intr.cx - 0.5) / 2.0, cy=(intr.cy - 0.5) / 2.0,
        width=intr.width // 2, height=intr.height // 2, znear=intr.znear, zfar=intr.zfar,
    )


def coarse_render_config(rcfg: RenderConfig) -> RenderConfig:
    """The pyramid's coarse-stage render config: packed at twice the slot
    budget, capped at max_per_tile (a coarse tile covers four fine ones)."""
    if not rcfg.use_packed:
        return rcfg
    return dataclasses.replace(rcfg, slot_budget_per_tile=min(rcfg.max_per_tile,
                                                              rcfg.slot_budget_per_tile * 2))


def track_camera_pyramid(params, active, cam: Camera, intr: Intrinsics, rcfg: RenderConfig,
                         tcfg: TrackingConfig) -> TrackResult:
    """Coarse-to-fine tracking (TrackingConfig.pyramid): a half-resolution
    stage (at most coarse_iters steps, plateau exit from coarse_min_iters,
    no final render, coarse_render_config), then the
    full-resolution track_camera from its pose and exposure with its plateau
    exit from fine_min_iters. Returns the fine stage's result with the two
    stages' iterations summed. Saturation caps are probed inside each stage.
    A speed choice of the reference package, with no counterpart in the
    original system, which tracks at full resolution only."""
    intr2 = half_res_intrinsics(intr)
    H2, W2 = intr2.height, intr2.width
    dev = cam.image.device
    cam2 = cam.replace(
        image=_downsample2_image(cam.image),
        grad_mask=_downsample2_mask(cam.grad_mask),
        depth=torch.zeros((H2, W2), dtype=torch.float32, device=dev),
        mono_depth=torch.zeros((H2, W2), dtype=torch.float32, device=dev),
        # all-pool: a coarse pixel is static only if all its fine pixels are
        static_mask=(~_downsample2_mask(~cam.static_mask) if tcfg.use_static_mask
                     else torch.ones((H2, W2), dtype=torch.bool, device=dev)),
    )
    rcfg2 = coarse_render_config(rcfg)
    tcfg_c = dataclasses.replace(tcfg, max_iters=tcfg.coarse_iters,
                                 plateau_min_iters=tcfg.coarse_min_iters, final_render=False)
    res_c = track_camera(params, active, cam2, intr2, rcfg2, tcfg_c)
    cam_f = cam.update_RT(res_c.R, res_c.T).replace(exposure_a=res_c.exposure_a,
                                                    exposure_b=res_c.exposure_b)
    tcfg_f = dataclasses.replace(tcfg, plateau_min_iters=tcfg.fine_min_iters)
    res_f = track_camera(params, active, cam_f, intr, rcfg, tcfg_f)
    return res_f._replace(iterations=res_c.iterations + res_f.iterations)


class ShardLayout(NamedTuple):
    """One rank's block of the tile-sharded tracker's padded tile grid:
    ntx_p columns (a multiple of the tile group, so that groups never
    straddle a tile row) by nty_p rows, cut into blocks of rows_per tile
    rows; this rank's block starts at tile row row0, global tile id tile0
    (the packed kernels' goff), and holds T_local tiles in groups_per
    groups."""
    ntx_p: int
    nty_p: int
    rows_per: int
    T_local: int
    groups_per: int
    row0: int
    tile0: int


def shard_layout(intr: Intrinsics, rcfg: RenderConfig, n_ranks: int, rank: int) -> ShardLayout:
    ts, TG = rcfg.tile_size, rcfg.tile_group
    ntx, nty = -(-intr.width // ts), -(-intr.height // ts)
    ntx_p = -(-ntx // TG) * TG
    rows_per = -(-nty // n_ranks)
    T_local = ntx_p * rows_per
    return ShardLayout(ntx_p=ntx_p, nty_p=rows_per * n_ranks, rows_per=rows_per, T_local=T_local,
                       groups_per=T_local // TG, row0=rank * rows_per, tile0=rank * rows_per * ntx_p)


@torch.no_grad()
def shard_bins(params, active, R, T, intr: Intrinsics, rcfg: RenderConfig, lay: ShardLayout,
               margin: float) -> PackedBins:
    """A rank's packed bins: binned on the padded grid, its block's tiles
    sliced out and packed at the budget (no saturation caps), as the
    reference's sharded tracker packs them."""
    proj = rz.project_gaussians(params["means"], params["quats"], params["log_scales"], active, R, T, intr)
    tile_idx, slot_valid = rz.bin_gaussians(
        proj["mean2d"], proj["radius"], proj["depth"], proj["valid"], margin, ntx=lay.ntx_p, nty=lay.nty_p,
        tile_size=rcfg.tile_size, max_per_tile=rcfg.max_per_tile, tile_chunk=rcfg.tile_chunk,
        coarse_factor=rcfg.coarse_factor, max_per_coarse=rcfg.max_per_coarse, bin_bucket=rcfg.bin_bucket)
    budget = rcfg.slot_budget_per_tile if rcfg.use_packed else rcfg.max_per_tile
    rows = slice(lay.tile0, lay.tile0 + lay.T_local)
    return rz.pack_bins(tile_idx[rows], slot_valid[rows], params["means"].shape[0], tile_group=rcfg.tile_group,
                        slot_budget_per_tile=budget)


def track_camera_sharded(params, active, cam: Camera, intr: Intrinsics, rcfg: RenderConfig,
                         tcfg: TrackingConfig, mesh) -> TrackResult:
    """Tile-sharded tracking over the mesh's "data" ranks (port of the
    reference's track_camera_sharded); every rank calls it with the same
    inputs and gets the same result.

    The tile grid is padded so that tile groups never straddle a tile row
    (ntx_p columns) and split into contiguous blocks of rows_per tile rows,
    one per rank. Each step, each rank bins, packs and blends only its rows
    (the packed kernels take the block's first tile id as their offset
    goff), takes its part of the masked L1 loss, normalised by the global
    3*H*W, and one all-reduce sums (loss, 6 pose and 2 exposure gradients)
    over the ranks, so every rank takes the same Adam step and the same
    plateau exit. Projection stays replicated. The packs run at the
    budget without saturation caps, and the steps render exactly (no
    period linearisation), as in the reference. A final local render at
    the converged pose gives the touch counts, summed over the ranks; the
    last step's rows are all-gathered into the frame, whose median depth
    is taken whole."""
    group = dim_group(mesh, "data")
    lay = shard_layout(intr, rcfg, dim_size(mesh, "data"), dim_rank(mesh, "data"))
    ts = rcfg.tile_size
    H, W = intr.height, intr.width
    hl, Wp = lay.rows_per * ts, lay.ntx_p * ts
    C = params["means"].shape[0]
    params = {k: v.detach() for k, v in params.items()}
    dev = cam.image.device
    f32 = dict(dtype=torch.float32, device=dev)
    # the packed kernels' global tile-id offset: the block's tile ids start
    # at 0, its pixel coordinates are the frame's
    goff = device_constant((lay.tile0,), torch.int32, dev)

    rgb_mask = (cam.image.sum(dim=0) > tcfg.rgb_boundary_threshold) & cam.grad_mask
    if tcfg.use_static_mask:
        rgb_mask = rgb_mask & cam.static_mask

    def rows_of(x):
        """(c, H, W) -> this rank's rows of the padded frame (c, hl, Wp)."""
        full = torch.zeros((x.shape[0], lay.nty_p * ts, Wp), **f32)
        full[:, :H, :W] = x
        return full[:, lay.row0 * ts:lay.row0 * ts + hl]

    mask_l = rows_of(rgb_mask[None])
    gt_masked_l = rows_of(cam.image) * mask_l
    colors, opac = rz._blend_inputs(params, active)
    bg = rz._background(rcfg, dev)
    lr_tau = device_constant((tcfg.lr_trans,) * 3 + (tcfg.lr_rot,) * 3, torch.float32, dev)
    b1, b2 = tcfg.b1, tcfg.b2

    def render_local(tau, R, T, pb: rz.PackedBins, need_nt: bool):
        """This rank's rows: image (3, hl, Wp), depth and opacity (1, hl,
        Wp), and (with need_nt) per-Gaussian touch counts."""
        Rn, Tn = lie.apply_delta(R, T, tau)
        proj = rz.project_gaussians(params["means"], params["quats"], params["log_scales"], active, Rn, Tn,
                                    intr)
        tp = rz._gather_rows(rz._fields(proj["mean2d"], proj["conic"], colors, opac, proj["depth"]),
                             pb.gid)
        acc, trans, nt = blend_packed(tp, pb.cg, pb.k0, goff, pb.tids, lay.groups_per, lay.ntx_p, need_nt,
                                      rcfg.blend_bf16)
        img_t, dep_t, alpha_t = rz._packed_to_tiles(acc, trans, pb.inv, lay.T_local, bg)
        rows = lambda t: rz._tiles_to_image(t, lay.ntx_p, lay.rows_per, ts, hl, Wp)  # noqa: E731
        n_touched = rz._n_touched_packed(pb.gid, nt, C) if need_nt else None
        return rows(img_t).permute(2, 0, 1), rows(dep_t)[None], rows(alpha_t)[None], n_touched

    def step(s: dict, pb) -> dict:
        """One Adam step on the all-reduced gradients; a state already
        `done` passes through unchanged."""
        tau = torch.zeros(6, **f32, requires_grad=True)
        ab = s["ab"].detach().requires_grad_(True)
        img, dep, alpha, _ = render_local(tau, s["R"], s["T"], pb, False)
        image_ab = torch.exp(ab[0]) * img + ab[1]
        loss_l = (alpha * (image_ab * mask_l - gt_masked_l).abs()).sum() / (3.0 * H * W)
        g_tau, g_ab = torch.autograd.grad(loss_l, (tau, ab))
        with torch.no_grad():
            loss, g_tau, g_ab = all_reduce_flat([loss_l.detach().reshape(1), g_tau, g_ab], group)
            loss = loss[0]
            g_tau = torch.where(torch.isfinite(g_tau), g_tau, torch.zeros_like(g_tau))
            g_ab = torch.where(torch.isfinite(g_ab), g_ab, torch.zeros_like(g_ab))
            run = ~s["done"]
            it = s["it"] + run.to(torch.int32)
            itf = it.to(torch.float32)
            c1, c2 = 1 - b1**itf, 1 - b2**itf
            m_tau = b1 * s["m_tau"] + (1 - b1) * g_tau
            v_tau = b2 * s["v_tau"] + (1 - b2) * g_tau * g_tau
            tau_new = -lr_tau * (m_tau / c1) / (torch.sqrt(v_tau / c2) + tcfg.adam_eps)
            m_ab = b1 * s["m_ab"] + (1 - b1) * g_ab
            v_ab = b2 * s["v_ab"] + (1 - b2) * g_ab * g_ab
            ab_new = s["ab"] - tcfg.lr_exposure * (m_ab / c1) / (torch.sqrt(v_ab / c2) + tcfg.adam_eps)
            R, T = lie.apply_delta(s["R"], s["T"], tau_new)
            new = dict(R=R, T=T, ab=ab_new, m_tau=m_tau, v_tau=v_tau, m_ab=m_ab, v_ab=v_ab, it=it,
                       done=torch.linalg.norm(tau_new) < tcfg.convergence_eps,
                       image=img.detach(), depth=dep.detach(), opacity=alpha.detach(), loss=loss)
            return {k: torch.where(run, v, s[k]) for k, v in new.items()}

    s = dict(
        R=cam.R.to(**f32), T=cam.T.to(**f32),
        ab=torch.stack([cam.exposure_a, cam.exposure_b]).to(**f32),
        m_tau=torch.zeros(6, **f32), v_tau=torch.zeros(6, **f32),
        m_ab=torch.zeros(2, **f32), v_ab=torch.zeros(2, **f32),
        it=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        image=torch.zeros((3, hl, Wp), **f32), depth=torch.zeros((1, hl, Wp), **f32),
        opacity=torch.zeros((1, hl, Wp), **f32), loss=torch.zeros((), **f32),
    )
    it_host, done_host = 0, False
    while not done_host and it_host < tcfg.max_iters:
        with span("track.bin"):
            pb = shard_bins(params, active, s["R"], s["T"], intr, rcfg, lay, tcfg.bin_margin)
        with span("track.steps"):
            prev_loss = s["loss"]
            # the period's first step is unconditional; its loss is the
            # plateau baseline of the first period
            s1 = step(s, pb)
            s2 = s1
            for _ in range(min(tcfg.rebin_every, tcfg.max_iters - it_host) - 1):
                s2 = step(s2, pb)
            if tcfg.plateau_tol > 0:
                # the losses are all-reduced: every rank takes the same exit
                base = torch.where(prev_loss > 0, prev_loss, s1["loss"])
                plateau = ((base > 0) & (s2["it"] >= tcfg.plateau_min_iters)
                           & (base - s2["loss"] < tcfg.plateau_tol * base))
                s2["done"] = s2["done"] | plateau
            s = s2
            flags = torch.stack([s["it"].to(torch.float32), s["done"].to(torch.float32)])
        with sync():
            it_f, done_f = flags.tolist()
        it_host, done_host = int(it_f), bool(done_f)

    with span("track.final"):
        # one local render at the converged pose for the visibility
        # bookkeeping
        with torch.no_grad():
            pb = shard_bins(params, active, s["R"], s["T"], intr, rcfg, lay, tcfg.bin_margin)
            nt_local = render_local(torch.zeros(6, **f32), s["R"], s["T"], pb, True)[3]
        n_touched = all_reduce_sum(nt_local, group)
        # the frame from the ranks' rows: one all-gather
        frame = all_gather_tiled(torch.cat([s["image"], s["depth"], s["opacity"]]), group, dim=1)[:, :H, :W]
        image, depth, opacity = frame[:3], frame[3:4], frame[4:5]
    return TrackResult(
        R=s["R"], T=s["T"], exposure_a=s["ab"][0], exposure_b=s["ab"][1],
        image=image, depth=depth, opacity=opacity, n_touched=n_touched,
        median_depth=get_median_depth(depth, opacity), iterations=it_host, loss=s["loss"],
    )
