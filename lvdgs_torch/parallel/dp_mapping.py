"""Multi-device mapping step: camera-data-parallel x Gaussian-sharded
(port of ``lvdgs_tpu/parallel/dp_mapping.py``).

Layout on a (data, gauss) mesh (make_mesh), one process per rank:

- The map (the five parameter fields and their Adam moments) is cut along
  its capacity over the "gauss" dim; the camera batch over "data".
- Each rank all-gathers the map along "gauss", renders its cameras, and
  the gather's transpose, a sum reduce-scatter, hands each rank the map
  gradient of its own rows; an all-reduce over "data" completes the sum
  over cameras.
- Adam runs on each rank's rows alone: its state never leaves them.

Every rank of a "data" row renders the same cameras, so the
reduce-scatter adds "gauss"-many equal copies of their gradient, and the
isotropic term's sum over "gauss" is transposed to a sum too. The
reference keeps that factor: its gradients and Adam moments are n_gauss
times the single-device ones, and Adam's eps turns the factor into
parameter differences where a gradient is near eps (ROADMAP C18). The port
differentiates 1/n_gauss of the objective instead, so its gradients, and
so its steps, are the single-device ones on any mesh; the loss it returns
is the objective's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core import lie
from ..core.camera import Intrinsics
from ..gaussian.model import PARAM_FIELDS
from ..ops.rasterizer import RenderConfig, rasterize
from .collectives import all_gather_tiled, all_reduce_flat, all_reduce_sum, gather_along, sum_over
from .mesh import dim_group, dim_rank, dim_size

DEFAULT_LRS = {
    "means": 1.6e-4,
    "features_dc": 2.5e-3,
    "log_scales": 1e-3,
    "quats": 1e-3,
    "logit_opacities": 5e-2,
}


def _block(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Block i of n equal blocks of x along dim 0."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} equal blocks")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def make_sharded_mapping_step(
    mesh,
    intr: Intrinsics,
    rcfg: RenderConfig,
    *,
    lrs: Optional[Dict[str, float]] = None,
    alpha: float = 0.95,
    rgb_boundary_threshold: float = 0.01,
    isotropic_weight: float = 10.0,
    b1: float = 0.9,
    b2: float = 0.999,
    adam_eps: float = 1e-15,
):
    """Returns (step_fn, shard_fn).

    shard_fn(params, active, m, v, cam_batch) -> this rank's (params,
    active, m, v, cam_batch): the map's rows of its "gauss" block and the
    cameras of its "data" block. cam_batch holds images (B, 3, H, W),
    mono_depths (B, H, W), Rs, Ts and taus (per-camera pose deltas, B x 6).

    step_fn(params, active, m, v, count, images, mono_depths, Rs, Ts, taus)
      -> (new_params, new_m, new_v, new_count, loss)
    on this rank's blocks; loss (the sum over all cameras plus the
    isotropic term) is the same on every rank."""
    lrs = dict(DEFAULT_LRS if lrs is None else lrs)
    g_gauss, g_data = dim_group(mesh, "gauss"), dim_group(mesh, "data")
    n_data, n_gauss = dim_size(mesh, "data"), dim_size(mesh, "gauss")

    def per_cam_loss(full, full_active, image, mono, R, T, tau):
        Rn, Tn = lie.apply_delta(R, T, tau)
        out = rasterize(full, full_active, Rn, Tn, intr, rcfg, need_n_touched=False)
        mr = (image.sum(0) > rgb_boundary_threshold)[None].to(torch.float32)
        md = (mono > 0.01)[None].to(torch.float32)
        l_rgb = (out.image * mr - image * mr).abs().mean()
        l_d = (out.depth * md - mono[None] * md).abs().mean()
        return alpha * l_rgb + (1 - alpha) * l_d

    def step_fn(params, active, m, v, count, images, mono_depths, Rs, Ts, taus):
        p = {f: params[f].detach().requires_grad_(True) for f in PARAM_FIELDS}
        # the full map on every rank of the "gauss" row; the transpose of
        # this gather reduce-scatters the cotangents back to the rows
        full = {f: gather_along(p[f], g_gauss) for f in PARAM_FIELDS}
        full_active = all_gather_tiled(active, g_gauss)
        loss = torch.zeros((), dtype=torch.float32, device=active.device)
        for i in range(images.shape[0]):
            loss = loss + per_cam_loss(full, full_active, images[i], mono_depths[i], Rs[i], Ts[i], taus[i])
        # isotropic term on this rank's rows, summed over "gauss"; every
        # "data" rank adds it and the loss is summed over "data", so each
        # adds its share
        scaling = torch.exp(p["log_scales"])
        dev = (scaling - scaling.mean(dim=1, keepdim=True)).abs()
        nactive = all_reduce_sum(active.sum().to(torch.float32), g_gauss)
        iso = sum_over((dev * active[:, None].to(torch.float32)).sum(), g_gauss) / (nactive * 3 + 1e-8)
        total = loss + isotropic_weight * iso / n_data
        # 1/n_gauss: the "gauss" row's equal copies sum to one (C18)
        grads = dict(zip(PARAM_FIELDS, torch.autograd.grad(total / n_gauss, [p[f] for f in PARAM_FIELDS])))
        # DDP: the sum over the cameras of every "data" rank, in one call
        red = all_reduce_flat({"loss": total.detach().reshape(1), **grads}, g_data)
        new_count = int(count) + 1
        new_p, new_m, new_v = {}, {}, {}
        with torch.no_grad():
            for f in PARAM_FIELDS:
                g = red[f]
                mask = active if g.dim() == 1 else active[:, None]
                g = torch.where(mask, g, torch.zeros_like(g))
                mf = b1 * m[f] + (1 - b1) * g
                vf = b2 * v[f] + (1 - b2) * g * g
                mhat = mf / (1 - b1**new_count)
                vhat = vf / (1 - b2**new_count)
                upd = lrs[f] * mhat / (torch.sqrt(vhat) + adam_eps)
                new_p[f] = params[f] - torch.where(mask, upd, torch.zeros_like(upd))
                new_m[f], new_v[f] = mf, vf
        return new_p, new_m, new_v, new_count, red["loss"][0]

    def shard_fn(params, active, m, v, cam_batch):
        gi, di = dim_rank(mesh, "gauss"), dim_rank(mesh, "data")
        rows = lambda d: {f: _block(d[f], n_gauss, gi).contiguous() for f in PARAM_FIELDS}  # noqa: E731
        cams = {k: _block(x, n_data, di).contiguous() for k, x in cam_batch.items()}
        return rows(params), _block(active, n_gauss, gi).contiguous(), rows(m), rows(v), cams

    return step_fn, shard_fn
