"""Frame-to-map tracking of the benchmark's plain reference: a frozen copy
of the port's `track_camera` (up to `max_iters` Adam steps over a 6-dof
se(3) pose delta and an affine exposure, each rendering the map and
differentiating the exposure-compensated, opacity-weighted, edge-masked L1
loss; the packed tile assignment recomputed every `rebin_every` steps with
a `bin_margin` pixel slack and the render linearised in the pose over each
such period; exits at ||tau|| < convergence_eps, max_iters or a loss
plateau at period boundaries), rendering through the plain reference of
`render` in float32. Returns the pose, exposure, iterations and last loss;
the port's bookkeeping render after the loop is not part of it."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import lie
from .camera import Intrinsics
from .render import PackedBins, RenderConfig, pose_lin_gather, prepare_bins_with_caps, rasterize, rasterize_lin


class TrackInput(NamedTuple):
    """The frame as the tracker sees it: image (3, H, W), grad_mask and
    static_mask (H, W) bool, the seed pose R (3, 3), T (3,) and the seed
    exposure (a, b)."""
    image: torch.Tensor
    grad_mask: torch.Tensor
    static_mask: torch.Tensor
    R: torch.Tensor
    T: torch.Tensor
    exposure_a: torch.Tensor
    exposure_b: torch.Tensor


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
    iterations: int
    loss: torch.Tensor


def track_camera(params, active, cam: TrackInput, intr: Intrinsics, rcfg: RenderConfig,
                 tcfg: TrackingConfig, period_poses: list | None = None) -> TrackResult:
    """Optimise the pose/exposure of `cam` (seeded by cam.R/cam.T) against
    the fixed map. `period_poses` collects the pose (R, T) at the start of
    each rebin period."""
    params = {k: v.detach() for k, v in params.items()}
    dev = cam.image.device
    gt = cam.image
    rgb_mask = (gt.sum(dim=0) > tcfg.rgb_boundary_threshold) & cam.grad_mask
    if tcfg.use_static_mask:
        rgb_mask = rgb_mask & cam.static_mask
    rgb_mask = rgb_mask[None].to(torch.float32)
    gt_masked = gt * rgb_mask
    lr_tau = torch.tensor([tcfg.lr_trans] * 3 + [tcfg.lr_rot] * 3, dtype=torch.float32, device=dev)
    b1, b2 = tcfg.b1, tcfg.b2

    def step(s: dict, bins, tpj=None) -> dict:
        """One Adam step; a state already `done` passes through unchanged.
        With `tpj` the render is period-linearised at the drift tau_acc."""
        tau = torch.zeros(6, dtype=torch.float32, device=dev, requires_grad=True)
        ab = s["ab"].detach().requires_grad_(True)
        # n_touched is consumed only after the loop (final render below)
        if tpj is not None:
            out = rasterize_lin(tpj, s["tau_acc"] + tau, intr, rcfg, bins)
        else:
            Rn, Tn = lie.apply_delta(s["R"], s["T"], tau)
            out = rasterize(params, active, Rn, Tn, intr, rcfg, bins)
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
        # caps stale after a large pose correction since the last probe
        if drift_host > tcfg.cap_reprobe_drift:
            caps = None
            s["drift_acc"] = torch.zeros((), **f32)
        # rebin at the current pose with a pixel-radius margin
        if period_poses is not None:
            period_poses.append((s["R"].clone(), s["T"].clone()))
        bins, caps = prepare_bins_with_caps(params, active, s["R"], s["T"], intr, rcfg,
                                            tcfg.bin_margin, caps)
        tpj = None
        if tcfg.lin_period and isinstance(bins, PackedBins):
            # linearise the per-row fields at this period's pose; the drift
            # accumulates in tau_acc from zero
            tpj, _ = pose_lin_gather(params, active, s["R"], s["T"], intr, rcfg, bins)
            s["tau_acc"] = torch.zeros(6, **f32)
        prev_loss = s["loss"]
        # the period's first step is unconditional; its loss is the plateau
        # baseline of the first period
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
        # the one host read of the period
        it_f, done_f, drift_host = torch.stack(
            [s["it"].to(torch.float32), s["done"].to(torch.float32), s["drift_acc"]]).tolist()
        it_host, done_host = int(it_f), bool(done_f)

    return TrackResult(R=s["R"], T=s["T"], exposure_a=s["ab"][0], exposure_b=s["ab"][1],
                       iterations=it_host, loss=s["loss"])
