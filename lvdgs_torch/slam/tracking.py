"""Frame-to-map tracking on the dense path (PyTorch port of
``track_camera`` in ``lvdgs_tpu/slam/tracking.py``).

Up to `max_iters` Adam steps over a 6-dof se(3) pose delta and an affine
exposure (a, b), each rendering the map and differentiating the
exposure-compensated, opacity-weighted, edge-masked L1 loss. The tile
assignment is recomputed every `rebin_every` steps with a `bin_margin`
pixel slack. Exits: ||tau|| < convergence_eps, max_iters, or a loss plateau
checked at rebin-period boundaries.

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
from ..core.losses import get_median_depth
from ..ops.rasterizer import RenderConfig, prepare_bins, rasterize


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
    plateau_tol: float = 0.005
    plateau_min_iters: int = 40
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
    lr_tau = torch.tensor([tcfg.lr_trans] * 3 + [tcfg.lr_rot] * 3, dtype=torch.float32, device=dev)
    b1, b2 = tcfg.b1, tcfg.b2

    def step(s: dict, bins) -> dict:
        """One Adam step; a state already `done` passes through unchanged."""
        tau = torch.zeros(6, dtype=torch.float32, device=dev, requires_grad=True)
        ab = s["ab"].detach().requires_grad_(True)
        Rn, Tn = lie.apply_delta(s["R"], s["T"], tau)
        # n_touched is consumed only after the loop (final render below)
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
    )
    it_host, done_host = 0, False
    while not done_host and it_host < tcfg.max_iters:
        # rebin at the current pose with a pixel-radius margin
        bins = prepare_bins(params, active, s["R"], s["T"], intr, rcfg, tcfg.bin_margin)
        prev_loss = s["loss"]
        # the period's first step is unconditional; its loss is the plateau
        # baseline of the first period
        s1 = step(s, bins)
        s2 = s1
        for _ in range(min(tcfg.rebin_every, tcfg.max_iters - it_host) - 1):
            s2 = step(s2, bins)
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
        it_host, done_host = int(s["it"]), bool(s["done"])

    median_depth = get_median_depth(s["depth"], s["opacity"])
    # one exact render at the converged pose for the visibility bookkeeping
    with torch.no_grad():
        final_nt = rasterize(params, active, s["R"], s["T"], intr, rcfg).n_touched
    return TrackResult(
        R=s["R"], T=s["T"], exposure_a=s["ab"][0], exposure_b=s["ab"][1],
        image=s["image"], depth=s["depth"], opacity=s["opacity"], n_touched=final_nt,
        median_depth=median_depth, iterations=it_host, loss=s["loss"],
    )
