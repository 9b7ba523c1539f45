"""Differentiable tile-based 3D Gaussian rasterizer, dense path (PyTorch).

Port of the dense path of ``lvdgs_tpu/ops/rasterizer.py``:

1. **Project** (EWA splatting): world -> camera -> pixel means, 2D
   covariance through the local affine Jacobian, conic and radius.
2. **Bin**: Gaussians are depth-sorted once, then each 16x16 tile takes its
   front-most ``max_per_tile`` intersecting Gaussians with an exact
   ``torch.topk`` over the depth-sorted order (two-level through coarse
   tiles for large maps). Each tile's valid slots form a prefix of its row,
   so ``counts = slot_valid.sum(1)`` is the per-tile slot count.
3. **Blend**: the per-tile parameters are gathered into a (K, T, 10) block
   and blended front to back by the CUDA kernels of ``rasterizer_cuda``
   (their plain versions on the CPU). The gather's autograd transpose is the
   per-Gaussian scatter-add; the blend's backward is a kernel too.

Gradients flow to the Gaussian parameters, to (R, t) and to ``vs_offset``,
a (C, 2) zero tensor in NDC units whose gradient is the screen-space mean
gradient used for densification.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

from ..core import lie
from ..core.camera import Camera, Intrinsics
from .rasterizer_cuda import blend, median_depth

INF = 3.0e38
NEAR_PLANE = 0.2  # near-cull distance
COV_DILATION = 0.3  # low-pass dilation added to the 2D covariance
SH_C0 = 0.28209479177387814
_INT_CLAMP = float(2**30)  # keeps float->int32 tile indices in range


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rasterizer configuration (dense path)."""

    tile_size: int = 16
    max_per_tile: int = 256
    tile_chunk: int = 128  # tiles per binning step (single-level binning)
    white_background: bool = False
    # two-level binning: coarse tiles of (coarse_factor x coarse_factor)
    # fine tiles pre-select max_per_coarse front-most candidates
    coarse_factor: int = 8
    max_per_coarse: int = 2048

    def __post_init__(self):
        if self.tile_size != 16:
            raise ValueError("the blend kernels take 16x16 tiles (one thread per pixel)")

    def grid(self, intr: Intrinsics):
        ts = self.tile_size
        return -(-intr.width // ts), -(-intr.height // ts)


class RenderOutput(NamedTuple):
    image: torch.Tensor  # (3, H, W)
    depth: torch.Tensor  # (1, H, W) alpha-accumulated z
    opacity: torch.Tensor  # (1, H, W)
    radii: torch.Tensor  # (C,) float, 0 for culled
    visibility_filter: torch.Tensor  # (C,) bool
    n_touched: torch.Tensor  # (C,) int32


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz quaternions -> (N, 3, 3) rotation matrices."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def project_gaussians(means, quats, log_scales, active, R, t, intr: Intrinsics) -> Dict[str, torch.Tensor]:
    """EWA projection of all Gaussians. Everything differentiable."""
    p_cam = means @ R.T + t
    z = p_cam[:, 2]
    in_front = z > NEAR_PLANE
    zs = torch.where(in_front, z, torch.ones_like(z))  # guarded division

    mean2d = torch.stack(
        [intr.fx * p_cam[:, 0] / zs + intr.cx, intr.fy * p_cam[:, 1] / zs + intr.cy], dim=-1
    )

    Rm = quat_to_rotmat(quats)
    S = torch.exp(log_scales)
    M = Rm * S[:, None, :]
    cov3d = M @ M.transpose(1, 2)
    covc = R @ cov3d @ R.T  # camera-space covariance

    limx = 1.3 * math.tan(intr.fovx * 0.5)
    limy = 1.3 * math.tan(intr.fovy * 0.5)
    txz = torch.clamp(p_cam[:, 0] / zs, -limx, limx)
    tyz = torch.clamp(p_cam[:, 1] / zs, -limy, limy)
    j00 = intr.fx / zs
    j02 = -intr.fx * txz / zs
    j11 = intr.fy / zs
    j12 = -intr.fy * tyz / zs
    # cov2d = J covc J^T for J = [[j00, 0, j02], [0, j11, j12]]
    a = (j00 * j00 * covc[:, 0, 0] + 2.0 * j00 * j02 * covc[:, 0, 2]
         + j02 * j02 * covc[:, 2, 2] + COV_DILATION)
    b = (j00 * j11 * covc[:, 0, 1] + j00 * j12 * covc[:, 0, 2]
         + j02 * j11 * covc[:, 1, 2] + j02 * j12 * covc[:, 2, 2])
    c = (j11 * j11 * covc[:, 1, 1] + 2.0 * j11 * j12 * covc[:, 1, 2]
         + j12 * j12 * covc[:, 2, 2] + COV_DILATION)

    det = a * c - b * b
    # det floor (not just > 0): a denormal det passes the cull but its conic
    # and the backward's 1/det^2 overflow, and one such Gaussian NaN-poisons
    # the map through one Adam step
    valid = in_front & active & (det > 1e-6)
    det_s = torch.where(valid, det, torch.ones_like(det))
    conic = torch.stack([c / det_s, -b / det_s, a / det_s], dim=-1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return {
        "mean2d": mean2d,
        "conic": conic,
        "depth": z,
        "radius": radius,
        "valid": valid & (radius > 0.0),
    }


def _tile_floor(x: torch.Tensor, ts: int) -> torch.Tensor:
    return torch.floor(torch.clamp(x / ts, -_INT_CLAMP, _INT_CLAMP)).to(torch.int32)


def _resort_by_rank(sel, vals, sentinel: float):
    """Re-sort selected slots by depth rank (their selection index), with
    unselected (-INF score) entries at the back."""
    key = torch.where(vals > -INF * 0.5, sel.to(torch.float32), torch.full_like(vals, sentinel))
    order = torch.sort(key, dim=1, stable=True).indices
    return torch.gather(sel, 1, order)


@torch.no_grad()
def bin_gaussians(
    mean2d: torch.Tensor,
    radius: torch.Tensor,
    depth: torch.Tensor,
    valid: torch.Tensor,
    margin: float = 0.0,
    *,
    ntx: int,
    nty: int,
    tile_size: int,
    max_per_tile: int,
    tile_chunk: int,
    coarse_factor: int = 8,
    max_per_coarse: int = 4096,
):
    """Per-tile front-most-K selection over the global depth sort.

    `margin` (pixels) also admits Gaussians whose radius + margin reaches the
    tile, so the assignment stays valid while the pose drifts between
    rebins. Margin-only candidates rank strictly below every real
    intersector, and the slot list is re-sorted by depth.

    Returns (tile_idx (T, K) int64 with C for empty slots, slot_valid
    (T, K) bool); the valid slots of each row form a prefix."""
    dev = mean2d.device
    C = mean2d.shape[0]
    T = ntx * nty
    K = max_per_tile
    ts = tile_size

    key = torch.where(valid, depth, torch.full_like(depth, INF))
    order = torch.sort(key, stable=True).indices
    sm, sr, sv = mean2d[order], radius[order], valid[order]
    if C < K:  # tiny maps: pad so topk(K) is well formed
        pad_n = K - C
        sm = torch.cat([sm, sm.new_zeros(pad_n, 2)])
        sr = torch.cat([sr, sr.new_zeros(pad_n)])
        sv = torch.cat([sv, sv.new_zeros(pad_n)])
        order = torch.cat([order, order.new_full((pad_n,), C)])
    Cs = sv.shape[0]

    srm = sr + margin
    x0 = _tile_floor(sm[:, 0] - sr, ts)
    x1 = _tile_floor(sm[:, 0] + sr, ts)
    y0 = _tile_floor(sm[:, 1] - sr, ts)
    y1 = _tile_floor(sm[:, 1] + sr, ts)
    mx0 = _tile_floor(sm[:, 0] - srm, ts)
    mx1 = _tile_floor(sm[:, 0] + srm, ts)
    my0 = _tile_floor(sm[:, 1] - srm, ts)
    my1 = _tile_floor(sm[:, 1] + srm, ts)
    sv = sv & (mx1 >= 0) & (mx0 <= ntx - 1) & (my1 >= 0) & (my0 <= nty - 1)
    ranks = torch.arange(Cs, dtype=torch.float32, device=dev)
    neg_inf = -INF

    if Cs > max_per_coarse and T > coarse_factor**2:
        cf = coarse_factor
        ncx, ncy = -(-ntx // cf), -(-nty // cf)
        Tc = ncx * ncy
        Kc = max_per_coarse
        ctx = torch.arange(Tc, device=dev) % ncx
        cty = torch.arange(Tc, device=dev) // ncx
        cxa, cxb = (ctx * cf)[:, None], ((ctx + 1) * cf - 1)[:, None]
        cya, cyb = (cty * cf)[:, None], ((cty + 1) * cf - 1)[:, None]
        inter_cr = (x0[None] <= cxb) & (x1[None] >= cxa) & (y0[None] <= cyb) & (y1[None] >= cya) & sv[None]
        inter_c = (mx0[None] <= cxb) & (mx1[None] >= cxa) & (my0[None] <= cyb) & (my1[None] >= cya) & sv[None]
        score_c = torch.where(inter_cr, -ranks[None], torch.where(inter_c, -ranks[None] - Cs, neg_inf))
        vals_c, sel_c = torch.topk(score_c, Kc, dim=1)
        sel_c = _resort_by_rank(sel_c, vals_c, 2.0 * Cs).clamp(max=Cs - 1)  # (Tc, Kc)
        cand_valid = torch.gather(inter_c, 1, sel_c)
        big = torch.full_like(sel_c, ntx + 1, dtype=torch.int32)
        neg1 = torch.full_like(sel_c, -1, dtype=torch.int32)
        bigy = torch.full_like(sel_c, nty + 1, dtype=torch.int32)
        cx0 = torch.where(cand_valid, x0[sel_c], big)
        cx1 = torch.where(cand_valid, x1[sel_c], neg1)
        cy0 = torch.where(cand_valid, y0[sel_c], bigy)
        cy1 = torch.where(cand_valid, y1[sel_c], neg1)
        cmx0 = torch.where(cand_valid, mx0[sel_c], big)
        cmx1 = torch.where(cand_valid, mx1[sel_c], neg1)
        cmy0 = torch.where(cand_valid, my0[sel_c], bigy)
        cmy1 = torch.where(cand_valid, my1[sel_c], neg1)

        tids = torch.arange(T, device=dev)
        tx, ty = (tids % ntx)[:, None], (tids // ntx)[:, None]
        parent = (tids // ntx // cf) * ncx + (tids % ntx) // cf
        inter_r = (cx0[parent] <= tx) & (cx1[parent] >= tx) & (cy0[parent] <= ty) & (cy1[parent] >= ty)
        inter_m = (cmx0[parent] <= tx) & (cmx1[parent] >= tx) & (cmy0[parent] <= ty) & (cmy1[parent] >= ty)
        local_ranks = torch.arange(Kc, dtype=torch.float32, device=dev)[None]
        score = torch.where(inter_r, -local_ranks, torch.where(inter_m, -local_ranks - Kc, neg_inf))
        vals, sel_f = torch.topk(score, min(K, Kc), dim=1)
        sel_f = _resort_by_rank(sel_f, vals, 2.0 * Kc)
        sel = torch.gather(sel_c[parent], 1, sel_f.clamp(max=Kc - 1))
        if K > Kc:  # degenerate config
            sel = torch.cat([sel, sel.new_zeros(T, K - Kc)], 1)
        counts = torch.clamp(inter_m.sum(dim=1), max=K)
    else:
        sels, cnts = [], []
        for c0 in range(0, T, tile_chunk):
            tids = torch.arange(c0, c0 + tile_chunk, device=dev)
            tx = (tids % ntx)[:, None]
            ty = torch.clamp(tids // ntx, max=nty - 1)[:, None]
            inter_r = (x0[None] <= tx) & (x1[None] >= tx) & (y0[None] <= ty) & (y1[None] >= ty) & sv[None]
            inter_m = (mx0[None] <= tx) & (mx1[None] >= tx) & (my0[None] <= ty) & (my1[None] >= ty) & sv[None]
            score = torch.where(inter_r, -ranks[None], torch.where(inter_m, -ranks[None] - Cs, neg_inf))
            vals, sel = torch.topk(score, K, dim=1)
            sels.append(_resort_by_rank(sel, vals, 2.0 * Cs))
            cnts.append(torch.clamp(inter_m.sum(dim=1), max=K))
        sel = torch.cat(sels)[:T]
        counts = torch.cat(cnts)[:T]

    slot_valid = torch.arange(K, device=dev)[None] < counts[:, None]
    tile_idx = torch.where(slot_valid, order[sel.clamp(max=Cs - 1)], torch.full_like(sel, C))
    return tile_idx, slot_valid


def _tile_params(tile_idx, mean2d, conic, colors, opacities, depth):
    """Gather per-(slot, tile) fields into the kernels' (K, T, 10) layout
    (index C is a zero sentinel row). Differentiable: its transpose is the
    per-Gaussian scatter-add.

    index_select, whose backward is index_add_ (atomic adds on CUDA), not
    advanced indexing, whose backward sorts the indices and accumulates
    each run of equal indices in one thread: every empty slot holds the
    sentinel, so that run is most of the (K, T) block and took ~98 ms per
    backward at 1226x370 on the H100 (PERF.md)."""
    C = mean2d.shape[0]
    K, T = tile_idx.shape[1], tile_idx.shape[0]
    fields = torch.cat([mean2d, conic, colors, depth[:, None], opacities[:, None]], dim=1)
    fields = torch.cat([fields, fields.new_zeros(1, fields.shape[1])], dim=0)
    idx = tile_idx.clamp(max=C).T.reshape(-1)
    return torch.index_select(fields, 0, idx).view(K, T, fields.shape[1])


def _blend_dense(tile_idx, slot_valid, mean2d, conic, colors, opacities, depth, bg, *, ntx,
                 need_n_touched=True):
    """Kernel blending path. Returns per-tile (image (T, P, 3), depth (T, P),
    alpha (T, P)) and per-Gaussian n_touched (C,)."""
    C = mean2d.shape[0]
    tp = _tile_params(tile_idx, mean2d, conic, colors, opacities, depth)
    counts = slot_valid.sum(dim=1, dtype=torch.int32)
    acc, trans, nt = blend(tp, counts, ntx)
    img = acc[:, :3, :].transpose(1, 2) + trans[..., None] * bg[None, None, :]
    if need_n_touched:
        # the sentinel index C lands in an extra row that is dropped
        n_touched = torch.zeros(C + 1, dtype=torch.int32, device=nt.device).index_add_(
            0, tile_idx.reshape(-1), nt.reshape(-1)
        )[:C]
    else:
        n_touched = torch.zeros(C, dtype=torch.int32, device=nt.device)
    return img, acc[:, 3, :], 1.0 - trans, n_touched


def _tiles_to_image(tiles: torch.Tensor, ntx: int, nty: int, ts: int, H: int, W: int):
    """(T, P, ...) tile buffers -> (H, W, ...) image crop."""
    extra = tiles.shape[2:]
    img = tiles.reshape(nty, ntx, ts, ts, *extra).transpose(1, 2)
    return img.reshape(nty * ts, ntx * ts, *extra)[:H, :W]


def _bin_for(proj, cfg: RenderConfig, ntx: int, nty: int, margin: float = 0.0, mean2d=None):
    return bin_gaussians(
        (proj["mean2d"] if mean2d is None else mean2d).detach(),
        proj["radius"].detach(),
        proj["depth"].detach(),
        proj["valid"],
        margin,
        ntx=ntx, nty=nty, tile_size=cfg.tile_size, max_per_tile=cfg.max_per_tile,
        tile_chunk=cfg.tile_chunk, coarse_factor=cfg.coarse_factor,
        max_per_coarse=cfg.max_per_coarse,
    )


@torch.no_grad()
def prepare_bins(params, active, R, t, intr: Intrinsics, cfg: RenderConfig, margin: float = 0.0):
    """Project and bin only (no blending) -> (tile_idx, slot_valid), for
    reuse across several optimisation steps. `margin` keeps the assignment
    valid under small pose changes (see bin_gaussians)."""
    ntx, nty = cfg.grid(intr)
    proj = project_gaussians(
        params["means"], params["quats"], params["log_scales"], active, R, t, intr
    )
    return _bin_for(proj, cfg, ntx, nty, margin)


def rasterize(
    params: Dict[str, torch.Tensor],
    active: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    intr: Intrinsics,
    cfg: RenderConfig,
    vs_offset: Optional[torch.Tensor] = None,
    bins=None,
    need_n_touched: bool = True,
) -> RenderOutput:
    """Differentiable rasterization of ``params`` (means, features_dc,
    log_scales, quats, logit_opacities) from pose (R, t). `bins` (from
    prepare_bins) reuses a precomputed tile assignment."""
    ntx, nty = cfg.grid(intr)
    proj = project_gaussians(
        params["means"], params["quats"], params["log_scales"], active, R, t, intr
    )
    mean2d = proj["mean2d"]
    if vs_offset is not None:
        mean2d = mean2d + torch.stack(
            [vs_offset[:, 0] * (intr.width * 0.5), vs_offset[:, 1] * (intr.height * 0.5)], dim=-1
        )
    colors = torch.clamp(0.5 + SH_C0 * params["features_dc"], 0.0, 1.0)
    # active-gated so stale bins can never resurrect an inactive slot
    opac = torch.where(active, torch.sigmoid(params["logit_opacities"]),
                       torch.zeros_like(params["logit_opacities"]))
    if bins is None:
        tile_idx, slot_valid = _bin_for(proj, cfg, ntx, nty, mean2d=mean2d)
    else:
        tile_idx, slot_valid = bins
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, dtype=torch.float32,
                    device=mean2d.device)
    img_t, depth_t, alpha_t, n_touched = _blend_dense(
        tile_idx, slot_valid, mean2d, proj["conic"], colors, opac, proj["depth"], bg,
        ntx=ntx, need_n_touched=need_n_touched,
    )
    H, W, ts = intr.height, intr.width, cfg.tile_size
    return RenderOutput(
        image=_tiles_to_image(img_t, ntx, nty, ts, H, W).permute(2, 0, 1),
        depth=_tiles_to_image(depth_t, ntx, nty, ts, H, W)[None],
        opacity=_tiles_to_image(alpha_t, ntx, nty, ts, H, W)[None],
        radii=proj["radius"].detach(),
        visibility_filter=proj["valid"],
        n_touched=n_touched,
    )


@torch.no_grad()
def rasterize_median_depth(params, active, R, t, intr: Intrinsics, cfg: RenderConfig):
    """Transmittance-median (front-surface) depth: the z of the first splat
    at which accumulated opacity crosses 0.5. Returns ((1, H, W) depth,
    (1, H, W) opacity); pixels that never reach opacity 0.5 get depth 0.

    The alpha-blended depth is an unnormalised transmittance-weighted sum,
    so a surface of opacity o reads ~(1 - o) shallow; keyframe scale
    alignment needs a surface measurement instead. Not differentiable."""
    ntx, nty = cfg.grid(intr)
    proj = project_gaussians(
        params["means"], params["quats"], params["log_scales"], active, R, t, intr
    )
    opac = torch.where(active, torch.sigmoid(params["logit_opacities"]),
                       torch.zeros_like(params["logit_opacities"]))
    tile_idx, slot_valid = _bin_for(proj, cfg, ntx, nty)
    C = proj["mean2d"].shape[0]
    colors = torch.zeros((C, 3), dtype=torch.float32, device=opac.device)  # unused
    tp = _tile_params(tile_idx, proj["mean2d"], proj["conic"], colors, opac, proj["depth"])
    counts = slot_valid.sum(dim=1, dtype=torch.int32)
    dmed_t, opac_t = median_depth(tp, counts, ntx)
    H, W, ts = intr.height, intr.width, cfg.tile_size
    return (_tiles_to_image(dmed_t, ntx, nty, ts, H, W)[None],
            _tiles_to_image(opac_t, ntx, nty, ts, H, W)[None])


def render(gmap, cam: Camera, intr: Intrinsics, cfg: RenderConfig,
           tau: Optional[torch.Tensor] = None, vs_offset: Optional[torch.Tensor] = None):
    """Render the map from a camera; with `tau` the pose is exp(tau) @ [R|T]
    so gradients w.r.t. tau are pose gradients."""
    if tau is None:
        R, t = cam.R, cam.T
    else:
        R, t = lie.apply_delta(cam.R, cam.T, tau)
    return rasterize(gmap.params(), gmap.active, R, t, intr, cfg, vs_offset=vs_offset)


def render_with_custom_resolution(gmap, cam: Camera, intr: Intrinsics, cfg: RenderConfig,
                                  target_width: int, target_height: int):
    """Render at a different resolution with rescaled intrinsics."""
    sub = intr.scaled(target_width, target_height)
    return rasterize(gmap.params(), gmap.active, cam.R, cam.T, sub, cfg)
