"""Projection, binning, packing and the pose-linearised render of the
benchmark's plain reference: a frozen copy of the port's plain PyTorch
render path (EWA projection, per-tile front-most selection over the global
depth sort, the group-CSR pack under a slot budget with the saturation
probe's caps, the pose-linearised fields), in float32, with the plain
packed blend of `blend` in place of the kernels. It imports nothing of the
program: the benchmark holds the program's outputs against it."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

from . import lie
from .blend import KC, P, blend_packed, packed_blend_forward_plain
from .camera import Intrinsics

INF = 3.0e38
NEAR_PLANE = 0.2  # near-cull distance
COV_DILATION = 0.3  # low-pass dilation added to the 2D covariance
SH_C0 = 0.28209479177387814
_INT_CLAMP = float(2**30)  # keeps float->int32 tile indices in range


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rasterizer configuration."""

    tile_size: int = 16
    max_per_tile: int = 256
    tile_chunk: int = 128  # tiles per binning step (single-level binning)
    white_background: bool = False
    # two-level binning: coarse tiles of (coarse_factor x coarse_factor)
    # fine tiles pre-select max_per_coarse front-most candidates
    coarse_factor: int = 8
    max_per_coarse: int = 2048
    # tiles per group of the packed layout
    tile_group: int = 16
    # packed (group-CSR) slot lists: chunks of KC slots per tile group,
    # sized by the group's deepest tile under a static budget of
    # slot_budget_per_tile slots per tile (waterfill cap where it binds);
    # the same slots in the same order as the dense lists where it does not
    use_packed: bool = False
    slot_budget_per_tile: int = 128
    # saturation feedback: a gradient-free full-depth probe caps each
    # saturated tile at its useful depth and the repack hands the released
    # budget to deep unsaturated tiles
    saturation_feedback: bool = False
    # per-pixel error tolerance of the feedback cap (one 8-bit LSB)
    feedback_tol: float = 1.0 / 255.0
    # active-prefix binning bucket (0 = full capacity): the depth-sorted
    # candidate arrays are sliced to this many entries before the tile
    # top-k selections. Exact while the valid count stays <= bucket; when it
    # binds, only the farthest valid Gaussians drop out of binning. The
    # SLAM host re-buckets as the map grows and prunes.
    bin_bucket: int = 0

    def __post_init__(self):
        if self.tile_size != 16:
            raise ValueError("the blend takes 16x16 tiles")

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
    bin_bucket: int = 0,
):
    """Per-tile front-most-K selection over the global depth sort.

    `margin` (pixels) also admits Gaussians whose radius + margin reaches the
    tile, so the assignment stays valid while the pose drifts between
    rebins. Margin-only candidates rank strictly below every real
    intersector, and the slot list is re-sorted by depth.

    `bin_bucket` > 0 bins only the first `bin_bucket` entries of the depth
    sort (at least K), which hold every valid Gaussian while their count
    stays within it.

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
    if 0 < bin_bucket < Cs:
        # the depth sort puts the valid Gaussians first, so while they fit
        # the slice drops only invalid entries; the scores below rank by
        # position alone, so the selections keep their slots and order
        # (the two-level choice reads the sliced Cs)
        Cs = max(bin_bucket, K)
        sm, sr, sv, order = sm[:Cs], sr[:Cs], sv[:Cs], order[:Cs]

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


def _fields(mean2d, conic, colors, opacities, depth) -> torch.Tensor:
    """(C + 1, 10) per-Gaussian blend fields; row C is the zero sentinel,
    whose opacity 0 renders at alpha 0."""
    fields = torch.cat([mean2d, conic, colors, depth[:, None], opacities[:, None]], dim=1)
    return torch.cat([fields, fields.new_zeros(1, fields.shape[1])], dim=0)


class _SentinelGather(torch.autograd.Function):
    """table[idx] (idx flat) whose transpose adds each row's gradients in a
    fixed order, so that a run repeats bit for bit on the card.

    index_select's own backward is index_add_, whose atomics add in the
    order the threads happen to run: the map's gradients then differ in
    their last bits from run to run, and the SLAM loop's keyframe tests
    carry that into other trajectories. Here the backward sorts idx
    (stably) and sums each row's run of gradients in index order, as
    index_add_ does on the CPU, so the two devices add in the same order.
    The table's last row is the zero sentinel of the empty slots (_fields),
    a constant: its run, most of a dense block, is skipped and its
    gradient is 0."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        rows = ctx.rows
        sorted_idx, order = torch.sort(idx, stable=True)
        # row r sums sorted positions [offsets[r], offsets[r + 1]); the
        # sentinel's segment (the last) is empty
        bounds = torch.arange(rows + 1, device=idx.device, dtype=idx.dtype).clamp(max=rows - 1)
        offsets = torch.searchsorted(sorted_idx, bounds)
        flat = grad.reshape(grad.shape[0], -1).index_select(0, order)
        dtable = torch.segment_reduce(flat, "sum", offsets=offsets, axis=0, unsafe=True, initial=0)
        return dtable.view(rows, *grad.shape[1:]), None


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for an index array of any shape, through index_select
    with a deterministic transpose (_SentinelGather; see _tile_params).
    The table's last row must be the zero sentinel: it gets no gradient."""
    return _SentinelGather.apply(table, idx.reshape(-1)).view(*idx.shape, *table.shape[1:])


# ---------------------------------------------------------------------------
# packed (group-CSR) slot lists


class PackedBins(NamedTuple):
    """Group-CSR tile assignment (RenderConfig.use_packed).

    gid:    (NB, KC, TG) int64 Gaussian id per (chunk, slot, lane), C = empty
            (the zero sentinel row, alpha 0).
    cg:     (NB,) int32 tile group of each chunk (n_groups = padding).
    k0:     (NB,) int32 slot offset of the chunk in its group's lists.
    kalloc: (T_pad,) int32 slots allocated per tile, in tile order, after
            the waterfill cap and any tile cap (saturation feedback).
    tids:   (NB, TG) int32 tile id per (chunk, lane); with sort_by_depth a
            group holds tiles of similar depth, not a run of tiles.
    inv:    (T_pad,) int32 position of tile t in the group-major layout.
    """

    gid: torch.Tensor
    cg: torch.Tensor
    k0: torch.Tensor
    kalloc: torch.Tensor
    tids: torch.Tensor
    inv: torch.Tensor


@torch.no_grad()
def pack_bins(tile_idx: torch.Tensor, slot_valid: torch.Tensor, C: int, *, tile_group: int,
              slot_budget_per_tile: int, tile_cap: Optional[torch.Tensor] = None,
              sort_by_depth: bool = False) -> PackedBins:
    """Pack dense (T, K) slot lists into ragged per-group chunk lists.

    Each group of TG tiles gets ceil(kmax_g / KC) chunks, kmax_g its deepest
    tile's count, capped by the waterfill threshold theta: the largest
    per-tile depth whose chunk total fits the static budget NB = T_pad *
    slot_budget_per_tile / (KC * TG). Where the budget does not bind, the
    packed lists hold the dense lists' slots in the same order. `tile_cap`
    (T,) bounds each tile's depth (saturation feedback); `sort_by_depth`
    groups tiles by descending count, so that a group's deepest tile is
    close to its others. Runs on the device without a host sync: the
    waterfill is a fixed number of bisection steps."""
    T, K = tile_idx.shape
    TG = tile_group
    G = -(-T // TG)
    T_pad = G * TG
    if slot_budget_per_tile < KC:
        raise ValueError(f"the budget must cover one chunk of {KC} slots per group")
    NB = (T_pad * slot_budget_per_tile) // (KC * TG)
    dev = tile_idx.device
    i32 = torch.int32

    counts = slot_valid.sum(dim=1, dtype=i32)
    if tile_cap is not None:
        counts = torch.minimum(counts, torch.clamp(tile_cap.to(i32), min=0))
    if T_pad != T:
        counts = torch.cat([counts, counts.new_zeros(T_pad - T)])
        tile_idx = torch.cat([tile_idx, tile_idx.new_full((T_pad - T, K), C)])
    if sort_by_depth:
        perm = torch.argsort(-counts, stable=True)
    else:
        perm = torch.arange(T_pad, device=dev)
    counts_s = counts[perm]
    gmax = counts_s.reshape(G, TG).max(dim=1).values

    def nchunks(theta):
        return torch.clamp(-(-torch.minimum(gmax, theta) // KC), min=1)

    # waterfill: the largest per-tile depth cap whose chunk total fits NB
    lo = torch.full((), KC, dtype=i32, device=dev)
    hi = torch.full((), K, dtype=i32, device=dev)
    for _ in range(max(int(math.ceil(math.log2(max(K - KC, 1) + 1))), 1)):
        mid = (lo + hi + 1) // 2
        ok = nchunks(mid).sum() <= NB
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    theta = lo

    kalloc_s = torch.minimum(counts_s, theta)
    nch = nchunks(theta)
    cum = torch.cumsum(nch, 0)
    start_g = cum - nch
    bids = torch.arange(NB, device=dev, dtype=cum.dtype)
    cg = torch.searchsorted(cum, bids, right=True)  # G for padding chunks
    safe_g = cg.clamp(max=G - 1)
    k0 = torch.where(cg < G, (bids - start_g[safe_g]) * KC, KC)
    pos_of = safe_g[:, None] * TG + torch.arange(TG, device=dev)[None]  # (NB, TG)
    tids = perm[pos_of]
    k_of = k0[:, None] + torch.arange(KC, device=dev)[None]  # (NB, KC)
    valid = (cg < G)[:, None, None] & (k_of[:, :, None] < kalloc_s[pos_of][:, None, :])
    gid = torch.where(valid, tile_idx[tids[:, None, :], k_of.clamp(max=K - 1)[:, :, None]], C)
    inv = torch.argsort(perm, stable=True)
    return PackedBins(gid=gid, cg=cg.to(i32), k0=k0.to(i32), kalloc=kalloc_s[inv].to(i32),
                      tids=tids.to(i32), inv=inv.to(i32))


@torch.no_grad()
def saturation_caps(pbins: PackedBins, wmax: torch.Tensor, T: int, *, tile_group: int,
                    max_per_tile: int, tol: float = 1.0 / 255.0) -> torch.Tensor:
    """Per-tile useful blend depth (T,) int32 from a probe render's per-slot
    max blend weights `wmax` (NB, KC, TG), in 1/65536 units.

    Each tile's chunk weights are suffix-summed back to front at chunk
    granularity, and the tile is capped after the last chunk whose remaining
    total exceeds `tol`, so that what the cap drops changes no pixel by more
    than about `tol`. Tiles whose tail still carries weight, or whose cap
    would not cut their allocation, get max_per_tile (uncapped)."""
    TG = tile_group
    T_pad = pbins.kalloc.shape[0]
    n_groups = T_pad // TG
    MC = max(max_per_tile // KC, 1)  # chunk ordinals per tile
    chunk_w = wmax.to(torch.float32).sum(dim=1) * (1.0 / 65536.0)  # (NB, TG)
    ord_of = torch.clamp(pbins.k0 // KC, max=MC - 1).long()
    t_of = torch.where(pbins.cg[:, None] < n_groups, pbins.tids, T_pad).long()
    flat_idx = (t_of * MC + ord_of[:, None]).reshape(-1)
    dense = torch.zeros((T_pad + 1) * MC, dtype=torch.float32, device=wmax.device).index_add_(
        0, flat_idx, chunk_w.reshape(-1)).reshape(T_pad + 1, MC)[:T]
    suffix = torch.flip(torch.cumsum(torch.flip(dense, [1]), dim=1), [1])
    keep = suffix > tol
    last = torch.argmax(torch.flip(keep, [1]).to(torch.int32), dim=1)
    cap = KC * (MC - last) * keep.any(dim=1)
    return torch.where(cap < pbins.kalloc[:T], cap, max_per_tile).to(torch.int32)


def _blend_inputs(params, active):
    """(colours, active-gated opacities) of the map."""
    colors = torch.clamp(0.5 + SH_C0 * params["features_dc"], 0.0, 1.0)
    opac = torch.where(active, torch.sigmoid(params["logit_opacities"]),
                       torch.zeros_like(params["logit_opacities"]))
    return colors, opac


def _goff(device) -> torch.Tensor:
    """The packed blend's tile-id offset: 0 on one device."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _packed_to_tiles(acc, trans, inv, T: int, bg):
    """Group-major blend rows -> per-tile (image (T, P, 3), depth (T, P),
    alpha (T, P)), through the pack's inverse permutation."""
    G1, _, TG, _ = acc.shape
    G = G1 - 1
    take = inv[:T].long()
    acc_t = acc[:G].transpose(1, 2).reshape(G * TG, 4, P).index_select(0, take)
    trans_t = trans[:G].reshape(G * TG, P).index_select(0, take)
    img = acc_t[:, :3, :].transpose(1, 2) + trans_t[..., None] * bg[None, None, :]
    return img, acc_t[:, 3, :], 1.0 - trans_t


def _n_touched_packed(gid, nt, C: int) -> torch.Tensor:
    """Per-Gaussian touched-pixel counts; the sentinel C sums into a row
    that is dropped."""
    return torch.zeros(C + 1, dtype=torch.int32, device=nt.device).index_add_(
        0, gid.reshape(-1), nt.reshape(-1))[:C]


def _blend_packed(pbins: PackedBins, mean2d, conic, colors, opacities, depth, bg, *, ntx, nty,
                  tile_group, need_n_touched=True):
    """Packed blending path: gathers only the budgeted slots
    (differentiable, its transpose the per-Gaussian scatter-add) into
    (NB, KC, TG, 10) chunks for the packed blend."""
    C = mean2d.shape[0]
    T = ntx * nty
    G = -(-T // tile_group)
    tp = _gather_rows(_fields(mean2d, conic, colors, opacities, depth), pbins.gid)
    acc, trans, nt = blend_packed(tp, pbins.cg, pbins.k0, _goff(tp.device), pbins.tids, G, ntx,
                                  need_n_touched)
    img, depth_t, alpha_t = _packed_to_tiles(acc, trans, pbins.inv, T, bg)
    if need_n_touched:
        n_touched = _n_touched_packed(pbins.gid, nt, C)
    else:
        n_touched = torch.zeros(C, dtype=torch.int32, device=nt.device)
    return img, depth_t, alpha_t, n_touched


@torch.no_grad()
def probe_saturation_caps(tile_idx, slot_valid, proj, params, active, cfg: RenderConfig, ntx: int,
                          nty: int, want_touched: bool = False):
    """Full-depth gradient-free probe blend -> per-tile useful-depth caps
    (see saturation_caps). With `want_touched` also a (C,) bool of
    per-Gaussian visibility (a blend weight > 0 at some pixel of the
    full-depth blend): the exact n_touched > 0 that a budget-capped render
    cannot give, since contributors it drops read as untouched."""
    C = params["means"].shape[0]
    T = ntx * nty
    pb = pack_bins(tile_idx, slot_valid, C, tile_group=cfg.tile_group,
                   slot_budget_per_tile=cfg.max_per_tile)
    colors, opac = _blend_inputs(params, active)
    tp = _gather_rows(_fields(proj["mean2d"], proj["conic"], colors, opac, proj["depth"]), pb.gid)
    _acc, _trans, wmax, _march = packed_blend_forward_plain(tp, pb.cg, pb.k0, _goff(tp.device), pb.tids,
                                                      -(-T // cfg.tile_group), ntx, probe_wmax=True)
    caps = saturation_caps(pb, wmax, T, tile_group=cfg.tile_group, max_per_tile=cfg.max_per_tile,
                           tol=cfg.feedback_tol)
    if not want_touched:
        return caps
    return caps, _n_touched_packed(pb.gid, (wmax > 0).to(torch.int32), C) > 0


@torch.no_grad()
def _pack_for_cfg(tile_idx, slot_valid, proj, params, active, cfg: RenderConfig, ntx: int,
                  nty: int, tile_cap=None) -> PackedBins:
    """Pack dense slot lists as the config says: a plain budgeted pack, or
    with saturation_feedback a probe-capped, depth-sorted pack. `tile_cap`
    supplies caps measured before (tracking probes once and reuses them:
    the map is frozen there)."""
    C = params["means"].shape[0]
    if not cfg.saturation_feedback:
        return pack_bins(tile_idx, slot_valid, C, tile_group=cfg.tile_group,
                         slot_budget_per_tile=cfg.slot_budget_per_tile)
    if tile_cap is None:
        tile_cap = probe_saturation_caps(tile_idx, slot_valid, proj, params, active, cfg, ntx, nty)
    return pack_bins(tile_idx, slot_valid, C, tile_group=cfg.tile_group,
                     slot_budget_per_tile=cfg.slot_budget_per_tile, tile_cap=tile_cap,
                     sort_by_depth=True)


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
        max_per_coarse=cfg.max_per_coarse, bin_bucket=cfg.bin_bucket,
    )


@torch.no_grad()
def prepare_bins(params, active, R, t, intr: Intrinsics, cfg: RenderConfig, margin: float = 0.0):
    """Project and bin only (no blending) -> (tile_idx, slot_valid), or
    PackedBins under cfg.use_packed, for reuse across several optimisation
    steps. `margin` keeps the assignment valid under small pose changes
    (see bin_gaussians)."""
    ntx, nty = cfg.grid(intr)
    proj = project_gaussians(
        params["means"], params["quats"], params["log_scales"], active, R, t, intr
    )
    bins = _bin_for(proj, cfg, ntx, nty, margin)
    if cfg.use_packed:
        return _pack_for_cfg(*bins, proj, params, active, cfg, ntx, nty)
    return bins


@torch.no_grad()
def prepare_bins_with_touched(params, active, R, t, intr: Intrinsics, cfg: RenderConfig,
                              margin: float = 0.0):
    """prepare_bins for the mapping loop under saturation feedback: returns
    (packed bins, touched) with `touched` the full-depth probe's (C,)
    per-Gaussian visibility, which the loop's n_touched > 0 consumers
    (covisibility, the opacity reset) read instead of capped renders."""
    if not (cfg.use_packed and cfg.saturation_feedback):
        raise ValueError("prepare_bins_with_touched needs use_packed and saturation_feedback")
    ntx, nty = cfg.grid(intr)
    proj = project_gaussians(
        params["means"], params["quats"], params["log_scales"], active, R, t, intr
    )
    tile_idx, slot_valid = _bin_for(proj, cfg, ntx, nty, margin)
    caps, touched = probe_saturation_caps(tile_idx, slot_valid, proj, params, active, cfg, ntx, nty,
                                          want_touched=True)
    return _pack_for_cfg(tile_idx, slot_valid, proj, params, active, cfg, ntx, nty,
                         tile_cap=caps), touched


@torch.no_grad()
def prepare_bins_with_caps(params, active, R, t, intr: Intrinsics, cfg: RenderConfig,
                           margin: float, caps: Optional[torch.Tensor]):
    """prepare_bins with carried saturation caps (the tracking loop): the
    probe runs only when `caps` is None, else the caps measured before are
    reused. Returns (bins, caps'). The caller decides on the host when to
    probe again."""
    ntx, nty = cfg.grid(intr)
    proj = project_gaussians(
        params["means"], params["quats"], params["log_scales"], active, R, t, intr
    )
    tile_idx, slot_valid = _bin_for(proj, cfg, ntx, nty, margin)
    if not cfg.use_packed:
        return (tile_idx, slot_valid), caps
    if not cfg.saturation_feedback:
        return _pack_for_cfg(tile_idx, slot_valid, proj, params, active, cfg, ntx, nty), caps
    if caps is None:
        caps = probe_saturation_caps(tile_idx, slot_valid, proj, params, active, cfg, ntx, nty)
    return _pack_for_cfg(tile_idx, slot_valid, proj, params, active, cfg, ntx, nty,
                         tile_cap=caps), caps


def _fields_at(params, active, R, t, intr: Intrinsics, tau):
    """(C + 1, 10) blend fields from pose exp(tau) @ [R | t], and the
    projection."""
    colors, opac = _blend_inputs(params, active)
    Rn, Tn = lie.apply_delta(R, t, tau)
    proj = project_gaussians(params["means"], params["quats"], params["log_scales"], active, Rn, Tn,
                             intr)
    return _fields(proj["mean2d"], proj["conic"], colors, opac, proj["depth"]), proj


def _fields_and_jacobian(params, active, R, t, intr: Intrinsics, tau):
    """((C + 1, 10, 7) fields at tau with their se(3) Jacobian columns, the
    projection at tau); the Jacobian is six forward-mode derivatives."""
    params = {k: v.detach() for k, v in params.items()}
    tau = tau.detach()
    with torch.no_grad():
        fields0, proj0 = _fields_at(params, active, R, t, intr, tau)
    J = torch.func.jacfwd(lambda d: _fields_at(params, active, R, t, intr, tau + d)[0])(
        torch.zeros(6, dtype=torch.float32, device=tau.device))
    return torch.cat([fields0[:, :, None], J.detach()], dim=2), proj0


def pose_lin_gather(params, active, R, t, intr: Intrinsics, cfg: RenderConfig, bins: PackedBins):
    """Gather per-row (field value, d field / d tau) at the linearisation
    pose -> (tpj (NB, KC, TG, 10, 7), projection). One widened gather; the
    Jacobian is computed once per call, so tracking calls this once per
    rebin period (period-linearised tracking)."""
    FJ, proj0 = _fields_and_jacobian(params, active, R, t, intr,
                                     torch.zeros(6, dtype=torch.float32, device=R.device))
    return _gather_rows(FJ, bins.gid), proj0


def _background(cfg: RenderConfig, device) -> torch.Tensor:
    return torch.full((3,), 1.0 if cfg.white_background else 0.0, dtype=torch.float32,
                      device=device)


def _render_output(img_t, depth_t, alpha_t, intr: Intrinsics, cfg: RenderConfig, radii=None,
                   visibility=None, n_touched=None) -> RenderOutput:
    """Per-tile (image (T, P, 3), depth (T, P), alpha (T, P)) -> the
    (C, H, W) render."""
    ntx, nty = cfg.grid(intr)
    H, W, ts = intr.height, intr.width, cfg.tile_size
    return RenderOutput(
        image=_tiles_to_image(img_t, ntx, nty, ts, H, W).permute(2, 0, 1),
        depth=_tiles_to_image(depth_t, ntx, nty, ts, H, W)[None],
        opacity=_tiles_to_image(alpha_t, ntx, nty, ts, H, W)[None],
        radii=radii, visibility_filter=visibility, n_touched=n_touched,
    )


def _linearised_tp(tpj, dtau):
    """Per-row fields at pose delta dtau: value + Jacobian . dtau."""
    return tpj[..., 0] + torch.einsum("...fd,d->...f", tpj[..., 1:], dtau)


def rasterize_lin(tpj, dtau, intr: Intrinsics, cfg: RenderConfig, bins: PackedBins) -> RenderOutput:
    """Blend the pose-linearised per-row fields (from pose_lin_gather) at
    pose delta `dtau` (differentiable). Each call is row-local glue and the
    packed blend: no projection, gather or scatter. Exact at dtau = 0,
    first-order accurate away from it. radii, visibility_filter and
    n_touched are None."""
    ntx, nty = cfg.grid(intr)
    tp = _linearised_tp(tpj, dtau)
    acc, trans, _nt = blend_packed(tp, bins.cg, bins.k0, _goff(tp.device), bins.tids,
                                   -(-ntx * nty // cfg.tile_group), ntx, False)
    return _render_output(*_packed_to_tiles(acc, trans, bins.inv, ntx * nty,
                                            _background(cfg, tp.device)), intr, cfg)


def rasterize(params: Dict[str, torch.Tensor], active: torch.Tensor, R: torch.Tensor,
              t: torch.Tensor, intr: Intrinsics, cfg: RenderConfig, bins: PackedBins,
              vs_offset: Optional[torch.Tensor] = None) -> RenderOutput:
    """Differentiable packed render of ``params`` from pose (R, t) on the
    packed tile assignment `bins` (from prepare_bins)."""
    ntx, nty = cfg.grid(intr)
    proj = project_gaussians(
        params["means"], params["quats"], params["log_scales"], active, R, t, intr
    )
    mean2d = proj["mean2d"]
    if vs_offset is not None:
        mean2d = mean2d + torch.stack(
            [vs_offset[:, 0] * (intr.width * 0.5), vs_offset[:, 1] * (intr.height * 0.5)], dim=-1
        )
    colors, opac = _blend_inputs(params, active)
    img_t, depth_t, alpha_t, n_touched = _blend_packed(
        bins, mean2d, proj["conic"], colors, opac, proj["depth"], _background(cfg, mean2d.device),
        ntx=ntx, nty=nty, tile_group=cfg.tile_group, need_n_touched=False,
    )
    return _render_output(img_t, depth_t, alpha_t, intr, cfg, radii=proj["radius"].detach(),
                          visibility=proj["valid"], n_touched=n_touched)
