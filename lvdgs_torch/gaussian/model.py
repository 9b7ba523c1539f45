"""Fixed-capacity Gaussian map: a structure of tensors (PyTorch).

Port of ``lvdgs_tpu/gaussian/model.py``. The map has a fixed capacity C and
an ``active`` mask; seeding, densify and prune are masked writes at fixed
shape, so states compare slot by slot with the reference package:

- seeding: backproject a strided, masked depth map, initial scales from
  the mean squared distance to the 3 nearest neighbours, write into free
  slots (lowest free index first);
- densify: clone small high-gradient Gaussians, split large ones;
- prune: clear the active bit.

The optimizer is a per-field Adam whose per-slot moments are zeroed when a
slot is (re)allocated, with the 3DGS exponential position learning rate.
Functions here update the map and optimizer tensors in place where the
reference donated its buffers; each such function says so.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.camera import Camera, Intrinsics
from ..core.log import device_constant, sync
from ..ops.rasterizer import SH_C0, quat_to_rotmat

# learnable field names (everything else is bookkeeping)
PARAM_FIELDS = ("means", "features_dc", "log_scales", "quats", "logit_opacities")


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


@dataclasses.dataclass
class GaussianMap:
    """All tensors have leading dim = capacity C."""

    means: torch.Tensor  # (C, 3) world positions
    features_dc: torch.Tensor  # (C, 3) SH DC coefficients
    log_scales: torch.Tensor  # (C, 3)
    quats: torch.Tensor  # (C, 4) wxyz, normalised on use
    logit_opacities: torch.Tensor  # (C,)
    active: torch.Tensor  # (C,) bool
    unique_kf_ids: torch.Tensor  # (C,) int32, -1 when inactive
    n_obs: torch.Tensor  # (C,) int32 covisibility counter
    max_radii2d: torch.Tensor  # (C,) float32
    grad_accum: torch.Tensor  # (C,) accumulated ||d loss / d ndc mean2d||
    grad_denom: torch.Tensor  # (C,) visibility count for grad_accum

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def num_active(self) -> int:
        with sync():
            return int(self.active.sum())

    @property
    def scaling(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    @property
    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.logit_opacities)

    @property
    def colors(self) -> torch.Tensor:
        return torch.clamp(0.5 + SH_C0 * self.features_dc, 0.0, 1.0)

    def params(self) -> Dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in PARAM_FIELDS}

    def replace(self, **kw) -> "GaussianMap":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "GaussianMap":
        return GaussianMap(**{f.name: getattr(self, f.name).clone() for f in dataclasses.fields(self)})


def create_map(capacity: int, device) -> GaussianMap:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return GaussianMap(
        means=torch.zeros((capacity, 3), **f32),
        features_dc=torch.zeros((capacity, 3), **f32),
        log_scales=torch.full((capacity, 3), -10.0, **f32),
        quats=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).repeat(capacity, 1),
        logit_opacities=torch.full((capacity,), -10.0, **f32),
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        unique_kf_ids=torch.full((capacity,), -1, **i32),
        n_obs=torch.zeros((capacity,), **i32),
        max_radii2d=torch.zeros((capacity,), **f32),
        grad_accum=torch.zeros((capacity,), **f32),
        grad_denom=torch.zeros((capacity,), **f32),
    )


@dataclasses.dataclass
class AdamState:
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    count: int

    def clone(self) -> "AdamState":
        return AdamState(
            m={k: x.clone() for k, x in self.m.items()},
            v={k: x.clone() for k, x in self.v.items()},
            count=self.count,
        )


# ---------------------------------------------------------------------------
# free-slot allocation


def _alloc_destinations(active: torch.Tensor, want: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map each wanted candidate to a free slot (lowest free index first).

    Returns (dest, ok): dest[i] is candidate i's slot, or C where no write
    happens (unwanted, or no free slot left); ok[i] says whether it does."""
    C = active.shape[0]
    free_order = torch.sort(active.to(torch.int32), stable=True).indices
    n_free = C - active.sum()
    cand_rank = torch.cumsum(want.to(torch.int64), 0) - 1
    ok = want & (cand_rank < n_free) & (cand_rank >= 0)
    dest = torch.where(ok, free_order[cand_rank.clamp(0, C - 1)], torch.full_like(cand_rank, C))
    return dest, ok


def _scatter_rows(arr: torch.Tensor, dest: torch.Tensor, ok: torch.Tensor, vals) -> None:
    """arr[dest[ok]] = vals[ok], in place. `dest` holds distinct slots where
    `ok`, so the write order does not matter."""
    with sync():  # the mask's rows, counted on the host
        rows = ok.nonzero()[:, 0]
    slots = dest[rows]
    if isinstance(vals, torch.Tensor):
        arr[slots] = vals[rows]
    else:  # a host scalar: a kernel argument, where an index_put would copy it
        arr.index_fill_(0, slots, vals)


def zero_adam_slots(opt_state: AdamState, dest: torch.Tensor, ok: torch.Tensor) -> None:
    """Zero Adam moments at (re)allocated slots, in place."""
    for f in PARAM_FIELDS:
        _scatter_rows(opt_state.m[f], dest, ok, 0.0)
        _scatter_rows(opt_state.v[f], dest, ok, 0.0)


def _write_new(gmap: GaussianMap, dest, ok, *, means, features_dc, log_scales, quats,
               logit_opacities, kf_id) -> None:
    """Write new Gaussians into their destination slots, in place."""
    _scatter_rows(gmap.means, dest, ok, means)
    _scatter_rows(gmap.features_dc, dest, ok, features_dc)
    _scatter_rows(gmap.log_scales, dest, ok, log_scales)
    _scatter_rows(gmap.quats, dest, ok, quats)
    _scatter_rows(gmap.logit_opacities, dest, ok, logit_opacities)
    _scatter_rows(gmap.active, dest, ok, True)
    _scatter_rows(gmap.unique_kf_ids, dest, ok, kf_id)
    _scatter_rows(gmap.n_obs, dest, ok, 0)
    _scatter_rows(gmap.max_radii2d, dest, ok, 0.0)
    _scatter_rows(gmap.grad_accum, dest, ok, 0.0)
    _scatter_rows(gmap.grad_denom, dest, ok, 0.0)


# ---------------------------------------------------------------------------
# seeding from a depth map


def _knn_mean_sq_dist(pts: torch.Tensor, valid: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Mean squared distance to the k nearest valid neighbours (blocked
    dense distances + topk). Invalid points get distance 1.

    Reproduces the reference's blocking exactly, including its last block:
    when P is not a multiple of the block, that block's slice is clamped to
    start at P - block while its self-exclusion rows are not, so those rows
    count one wrong point as "self" and may keep their own zero distance
    (ROADMAP C5)."""
    P = pts.shape[0]
    block = 1024 if P > 1024 else P
    big = 1e12
    pts_sq = (pts**2).sum(-1)
    out = torch.zeros(P, dtype=torch.float32, device=pts.device)
    cols = torch.arange(P, device=pts.device)
    for i in range(-(-P // block)):
        start = min(i * block, P - block)
        chunk = pts[start:start + block]
        d2 = (chunk**2).sum(-1)[:, None] - 2.0 * chunk @ pts.T + pts_sq[None, :]
        rows = torch.arange(i * block, i * block + block, device=pts.device)
        d2 = torch.where((rows[:, None] == cols[None]) | ~valid[None, :], torch.full_like(d2, big), d2)
        out[start:start + block] = torch.topk(d2, k, dim=1, largest=False).values.mean(dim=-1)
    return torch.clamp(torch.where(valid, out, torch.ones_like(out)), min=1e-7)


def backproject(depth: torch.Tensor, cam_R: torch.Tensor, cam_T: torch.Tensor, intr: Intrinsics):
    """Depth map (H, W) -> world points (H, W, 3) using the w2c pose."""
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - intr.cx) * depth / intr.fx
    y = (v - intr.cy) * depth / intr.fy
    p_cam = torch.stack([x, y, depth], dim=-1)
    R_c2w = cam_R.T
    t_c2w = -(R_c2w @ cam_T)
    return p_cam @ R_c2w.T + t_c2w


@torch.no_grad()
def seed_from_depth(gmap: GaussianMap, cam: Camera, depth: torch.Tensor, intr: Intrinsics, *,
                    kf_id: int, downsample: int, point_size: float = 0.01,
                    adaptive_pointsize: bool = True, init_opacity: float = 0.5,
                    opt_state: Optional[AdamState] = None) -> None:
    """Seed new Gaussians from a (masked) depth map, in place: pixels strided
    by sqrt(downsample), zero depth skipped, colours from the frame, scale
    sqrt(mean 3-NN squared distance), clamped to point_size * depth when
    adaptive_pointsize is on."""
    stride = max(1, int(round(np.sqrt(downsample))))
    d_s = depth[::stride, ::stride]
    pts = backproject(depth, cam.R, cam.T, intr)[::stride, ::stride].reshape(-1, 3)
    rgb = cam.image.permute(1, 2, 0)[::stride, ::stride].reshape(-1, 3)
    d_flat = d_s.reshape(-1)
    P = d_flat.shape[0]
    valid = d_flat > 0.0

    scale = torch.sqrt(_knn_mean_sq_dist(pts, valid))
    if adaptive_pointsize:
        scale = torch.minimum(scale, point_size * d_flat)
    scale = torch.clamp(scale, min=1e-6)

    dest, ok = _alloc_destinations(gmap.active, valid)
    init_logit = float(math.log(init_opacity / (1.0 - init_opacity)))
    _write_new(
        gmap, dest, ok,
        means=pts,
        features_dc=(rgb - 0.5) / SH_C0,
        log_scales=torch.log(scale)[:, None].expand(P, 3),
        quats=device_constant((1.0, 0.0, 0.0, 0.0), torch.float32, pts.device).expand(P, 4),
        logit_opacities=init_logit,
        kf_id=int(kf_id),
    )
    if opt_state is not None:
        zero_adam_slots(opt_state, dest, ok)


# ---------------------------------------------------------------------------
# densification / pruning (3DGS semantics at fixed shape)


def prune_points(gmap: GaussianMap, mask: torch.Tensor) -> None:
    """Deactivate Gaussians where mask is True, in place."""
    keep = gmap.active & ~mask
    gmap.active.copy_(keep)
    gmap.unique_kf_ids.masked_fill_(~keep, -1)
    gmap.logit_opacities.masked_fill_(~keep, -10.0)


def _zero_opacity_moments(opt_state: AdamState, target: torch.Tensor) -> None:
    opt_state.m["logit_opacities"].masked_fill_(target, 0.0)
    opt_state.v["logit_opacities"].masked_fill_(target, 0.0)


def reset_opacity(gmap: GaussianMap, opt_state: Optional[AdamState] = None) -> None:
    """opacity <- min(opacity, 0.01) on active Gaussians, in place (with the
    opacity Adam moments reset)."""
    target = gmap.active.clone()
    new_logit = inverse_sigmoid(torch.clamp(gmap.opacities, max=0.01))
    gmap.logit_opacities.copy_(torch.where(target, new_logit, gmap.logit_opacities))
    if opt_state is not None:
        _zero_opacity_moments(opt_state, target)


def reset_opacity_nonvisible(gmap: GaussianMap, visible_any: torch.Tensor,
                             opt_state: Optional[AdamState] = None) -> None:
    """Opacity reset restricted to Gaussians seen by no window keyframe."""
    target = gmap.active & ~visible_any
    new_logit = inverse_sigmoid(torch.clamp(gmap.opacities, max=0.01))
    gmap.logit_opacities.copy_(torch.where(target, new_logit, gmap.logit_opacities))
    if opt_state is not None:
        _zero_opacity_moments(opt_state, target)


@torch.no_grad()
def densify_and_prune(gmap: GaussianMap, split_eps: torch.Tensor, *, grad_threshold: float,
                      min_opacity: float, extent: float, max_screen_size: Optional[float],
                      percent_dense: float = 0.01, opt_state: Optional[AdamState] = None,
                      aux_vis: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Clone + split + prune with 3DGS semantics, in place.

    `split_eps` (2, C, 3) holds the standard-normal samples of the two split
    children (the caller draws them; tests inject the reference's).
    `aux_vis` (..., C) bool, optional, carries per-Gaussian visibility
    columns through the reshuffle: clone and split children inherit their
    parent's column and pruned slots are cleared, so that a visibility
    snapshot taken before the call stays valid after it. Returned when
    given (a new tensor; the argument is not changed)."""
    def inherit(vis, dest):
        # column dest[i] takes column i; unwritten candidates (dest = C)
        # land in a column that is dropped
        if vis is None:
            return None
        ext = torch.cat([vis, vis.new_zeros(*vis.shape[:-1], 1)], dim=-1)
        ext[..., dest] = vis
        return ext[..., :-1]

    grads = torch.where(gmap.grad_denom > 0,
                        gmap.grad_accum / torch.clamp(gmap.grad_denom, min=1.0),
                        torch.zeros_like(gmap.grad_accum))
    max_scale = gmap.scaling.max(dim=1).values
    hi_grad = (grads >= grad_threshold) & gmap.active
    clone_mask = hi_grad & (max_scale <= percent_dense * extent)
    split_mask = hi_grad & (max_scale > percent_dense * extent)

    # --- clone: copy parameters verbatim into free slots
    dest, ok = _alloc_destinations(gmap.active, clone_mask)
    src = {f: getattr(gmap, f).clone() for f in PARAM_FIELDS}
    _write_new(gmap, dest, ok, kf_id=gmap.unique_kf_ids.clone(), **src)
    if opt_state is not None:
        zero_adam_slots(opt_state, dest, ok)
    aux_vis = inherit(aux_vis, dest)

    # --- split: two children at 1/1.6 scale, parent pruned only when at
    # least one child was written (splitting at capacity keeps map mass)
    parent = {f: getattr(gmap, f).clone() for f in PARAM_FIELDS}
    parent_kf = gmap.unique_kf_ids.clone()
    child_ls = parent["log_scales"] - math.log(1.6)
    Rm = quat_to_rotmat(parent["quats"])
    stds = torch.exp(parent["log_scales"])
    any_child_ok = torch.zeros_like(split_mask)
    for eps in split_eps:
        child_means = parent["means"] + torch.einsum("nij,nj->ni", Rm, eps * stds)
        dest, ok = _alloc_destinations(gmap.active, split_mask)
        _write_new(
            gmap, dest, ok, means=child_means, features_dc=parent["features_dc"],
            log_scales=child_ls, quats=parent["quats"],
            logit_opacities=parent["logit_opacities"], kf_id=parent_kf,
        )
        if opt_state is not None:
            zero_adam_slots(opt_state, dest, ok)
        aux_vis = inherit(aux_vis, dest)
        any_child_ok = any_child_ok | ok
    split_parent_prune = split_mask & any_child_ok
    prune_points(gmap, split_parent_prune)

    # --- prune by opacity / screen size / world size
    prune_mask = gmap.active & (gmap.opacities < min_opacity)
    if max_screen_size is not None:
        big_vs = gmap.max_radii2d > max_screen_size
        big_ws = gmap.scaling.max(dim=1).values > 0.1 * extent
        prune_mask = prune_mask | (gmap.active & (big_vs | big_ws))
    prune_points(gmap, prune_mask)

    # reset densification stats
    gmap.grad_accum.zero_()
    gmap.grad_denom.zero_()
    gmap.max_radii2d.zero_()
    if aux_vis is not None:
        return aux_vis & ~split_parent_prune & ~prune_mask
    return None


# ---------------------------------------------------------------------------
# optimizer: per-field Adam with 3DGS learning-rate semantics


def position_lr(step: int, *, lr_init: float, lr_final: float, lr_delay_mult: float,
                max_steps: int, spatial_scale: float) -> float:
    """3DGS exponential position LR schedule."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t) * spatial_scale


@dataclasses.dataclass(frozen=True)
class MapOptimizer:
    """Per-field Adam; position follows the exponential schedule scaled by
    `spatial_scale`, the other rates are constant."""

    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.001
    rotation_lr: float = 0.001
    position_lr_init: float = 0.0016
    position_lr_final: float = 0.00016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    spatial_scale: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-15

    def init(self, gmap: GaussianMap) -> AdamState:
        return AdamState(
            m={f: torch.zeros_like(getattr(gmap, f)) for f in PARAM_FIELDS},
            v={f: torch.zeros_like(getattr(gmap, f)) for f in PARAM_FIELDS},
            count=0,
        )

    def lrs(self, step: int) -> Dict[str, float]:
        return {
            "means": position_lr(
                step, lr_init=self.position_lr_init, lr_final=self.position_lr_final,
                lr_delay_mult=self.position_lr_delay_mult,
                max_steps=self.position_lr_max_steps, spatial_scale=self.spatial_scale,
            ),
            "features_dc": self.feature_lr,
            "log_scales": self.scaling_lr,
            "quats": self.rotation_lr,
            "logit_opacities": self.opacity_lr,
        }

    @torch.no_grad()
    def step(self, gmap: GaussianMap, grads: Dict[str, torch.Tensor], state: AdamState,
             lr_step: int) -> None:
        """One Adam step on active slots, in place (map params and moments)."""
        state.count += 1
        c1 = 1.0 - self.b1 ** state.count
        c2 = 1.0 - self.b2 ** state.count
        lrs = self.lrs(lr_step)
        active = gmap.active
        for f in PARAM_FIELDS:
            g = grads[f]
            mask = active if g.dim() == 1 else active[:, None]
            # non-finite guard: one NaN/Inf component costs one zeroed
            # update, not the whole map
            g = torch.where(mask & torch.isfinite(g), g, torch.zeros_like(g))
            m, v = state.m[f], state.v[f]
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            upd = lrs[f] * (m / c1) / (torch.sqrt(v / c2) + self.eps)
            getattr(gmap, f).sub_(torch.where(mask, upd, torch.zeros_like(upd)))


@torch.no_grad()
def gauge_rescale(gmap: GaussianMap, opt_state: AdamState, k: float) -> None:
    """Similarity-rescale the map about the origin by `k`, in place
    (means *= k, scales *= k, position Adam moments rescaled to match)."""
    gmap.means.mul_(k)
    gmap.log_scales.add_(math.log(k))
    opt_state.m["means"].div_(k)
    opt_state.v["means"].div_(k * k)


def grow_capacity(gmap: GaussianMap, new_capacity: int, opt_state: AdamState):
    """Grow the slot capacity; existing slot indices are preserved (slots
    are appended), so stale tile bins stay valid."""
    C = gmap.capacity
    if new_capacity <= C:
        return gmap, opt_state
    fresh = create_map(new_capacity, gmap.device)
    gmap = GaussianMap(**{
        f.name: torch.cat([getattr(gmap, f.name), getattr(fresh, f.name)[C:]], 0)
        for f in dataclasses.fields(GaussianMap)
    })
    pad = lambda x: torch.cat([x, x.new_zeros((new_capacity - C,) + x.shape[1:])], 0)  # noqa: E731
    opt_state = AdamState(
        m={f: pad(opt_state.m[f]) for f in PARAM_FIELDS},
        v={f: pad(opt_state.v[f]) for f in PARAM_FIELDS},
        count=opt_state.count,
    )
    return gmap, opt_state


def compact_and_resize(gmap: GaussianMap, new_capacity: int, opt_state: AdamState):
    """Compact active Gaussians to the slot prefix and resize capacity.
    Returns (gmap, opt_state, take) with take[j] the old slot of new slot j;
    callers re-index their slot-aligned arrays with it."""
    order = torch.sort((~gmap.active).to(torch.int32), stable=True).indices
    take = order[:new_capacity]
    gmap = GaussianMap(**{f.name: getattr(gmap, f.name)[take] for f in dataclasses.fields(GaussianMap)})
    opt_state = AdamState(
        m={f: opt_state.m[f][take] for f in PARAM_FIELDS},
        v={f: opt_state.v[f][take] for f in PARAM_FIELDS},
        count=opt_state.count,
    )
    return gmap, opt_state, take
