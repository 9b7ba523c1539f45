"""Slot blocks at the street scene's shapes, for holding the blend kernels
against their plain versions and against other builds on the card: random
depth-sorted slot lists shaped like the street scene's, packed as tracking,
mapping and the saturation probe pack them, and the dense and packed blocks
that a SLAM run's final map gives."""
from __future__ import annotations

import torch

TG = 16  # tiles per group of the packed layout


def street_block(K: int, T: int, ntx: int, seed: int, device):
    """Random depth-sorted slot lists with ragged counts, shaped like the
    street scene's: Gaussians scattered around each tile, 1-60 px wide.
    Returns (tp (K, T, 10), counts (T,) int32)."""
    g = torch.Generator(device=device).manual_seed(seed)
    tid = torch.arange(T, device=device)
    cx = ((tid % ntx) * 16 + 8).to(torch.float32)
    cy = ((tid // ntx) * 16 + 8).to(torch.float32)
    u = lambda *shape: torch.rand(*shape, generator=g, device=device)  # noqa: E731
    tp = torch.empty((K, T, 10), device=device)
    tp[..., 0] = cx[None] + (u(K, T) - 0.5) * 40.0
    tp[..., 1] = cy[None] + (u(K, T) - 0.5) * 40.0
    sigma = 1.0 + 20.0 * u(K, T) ** 2  # pixels
    a = 1.0 / sigma**2
    tp[..., 2] = a
    tp[..., 3] = (u(K, T) - 0.5) * 0.5 * a
    tp[..., 4] = a * (0.5 + u(K, T))
    tp[..., 5:8] = u(K, T, 3)
    tp[..., 8] = torch.sort(1.0 + 60.0 * u(K, T), dim=0).values
    # some opacities reach the 0.99 clamp, whose gate the backward must keep
    tp[..., 9] = 0.05 + 0.95 * u(K, T)
    counts = (u(T) * (K + 1)).floor().clamp(max=K).to(torch.int32)
    return tp.contiguous(), counts


def packed_from_dense(tp, counts, budget: int, sort_by_depth: bool, seed: int):
    """A packed block made by pack_bins from a dense (K, T, 10) block: the
    kernels' inputs [tp, cg, k0, goff, tids] and the number of groups. With
    `sort_by_depth` the tiles get random caps and depth-sorted grouping, as
    under saturation feedback; without, plain grouping, as the probe packs."""
    from ..ops import rasterizer as tr

    K, T, NF = tp.shape
    dev = tp.device
    C = K * T
    # fields row t * K + k is slot k of tile t
    fields = torch.cat([tp.permute(1, 0, 2).reshape(C, NF), tp.new_zeros(1, NF)])
    slot_valid = torch.arange(K, device=dev)[None] < counts[:, None].long()
    tile_idx = torch.where(slot_valid, torch.arange(C, device=dev).reshape(T, K), C)
    cap = None
    if sort_by_depth:
        g = torch.Generator(device=dev).manual_seed(seed)
        cap = torch.randint(0, K + 1, (T,), generator=g, device=dev, dtype=torch.int32)
    pb = tr.pack_bins(tile_idx, slot_valid, C, tile_group=TG, slot_budget_per_tile=budget,
                      tile_cap=cap, sort_by_depth=sort_by_depth)
    goff = torch.zeros(1, dtype=torch.int32, device=dev)
    return [tr._gather_rows(fields, pb.gid).contiguous(), pb.cg, pb.k0, goff, pb.tids], -(-T // TG)


def street_packed_blocks(device):
    """The random street-shaped block (K 256, 77x24 tiles, seed 0) packed at
    the tracking budget (96, sorted with caps: NB 348), the mapping budget
    (128: NB 464) and as the probe packs it (256, plain grouping: NB 928).
    Returns (the dense block (tp, counts), ntx, [(budget, sorted, packed
    inputs, G)])."""
    ntx, nty, K = 77, 24, 256  # the street frame: 1226x370 in 16x16 tiles
    tp, counts = street_block(K, ntx * nty, ntx, seed=0, device=device)
    packed = []
    for budget, sort in ((96, True), (128, True), (256, False)):
        args, G = packed_from_dense(tp, counts, budget, sort, seed=budget)
        packed.append((budget, sort, args, G))
    return (tp, counts), ntx, packed


def main_path_packed_blocks(slam):
    """The packed blocks the main path blends at its end: the final map seen
    from the newest keyframe, packed as tracking, as mapping and as the
    feedback probe packs it. Returns ([(name, packed inputs)], G, ntx)."""
    from ..ops import rasterizer as tr

    p, active = slam.gmap.params(), slam.gmap.active
    slot = slam.kf_slots[slam.kf_indices[-1]]
    R, T = slam.kfbuf.R[slot], slam.kfbuf.T[slot]
    ntx, nty = slam.rcfg.grid(slam.intr)
    proj = tr.project_gaussians(p["means"], p["quats"], p["log_scales"], active, R, T, slam.intr)
    colors, opac = tr._blend_inputs(p, active)
    fields = tr._fields(proj["mean2d"], proj["conic"], colors, opac, proj["depth"])
    goff = torch.zeros(1, dtype=torch.int32, device=fields.device)
    G = -(-ntx * nty // slam.rcfg_map.tile_group)
    blocks = []
    for name, cfg in (("tracking", slam.rcfg_track), ("mapping", slam.rcfg_map)):
        pb = tr.prepare_bins(p, active, R, T, slam.intr, cfg)
        blocks.append((name, [tr._gather_rows(fields, pb.gid).contiguous(), pb.cg, pb.k0, goff, pb.tids]))
    tile_idx, slot_valid = tr._bin_for(proj, slam.rcfg, ntx, nty)
    pb = tr.pack_bins(tile_idx, slot_valid, p["means"].shape[0], tile_group=slam.rcfg.tile_group,
                      slot_budget_per_tile=slam.rcfg.max_per_tile)
    blocks.append(("probe", [tr._gather_rows(fields, pb.gid).contiguous(), pb.cg, pb.k0, goff, pb.tids]))
    return blocks, G, ntx


def main_path_track_block(slam, coarse: bool):
    """The packed block tracking blends at a run's end: the final map seen
    from the newest keyframe's pose, packed as tracking packs it, at full
    resolution or (`coarse`) as the pyramid's coarse stage does, at half
    resolution (half_res_intrinsics) and twice the tracking budget, capped
    at max_per_tile (coarse_render_config). Returns (packed inputs, G, ntx,
    budget): the kernels launch it at (NB, G) = (inputs[0].shape[0], G)."""
    from ..ops import rasterizer as tr
    from ..slam.tracking import coarse_render_config, half_res_intrinsics

    p, active = slam.gmap.params(), slam.gmap.active
    slot = slam.kf_slots[slam.kf_indices[-1]]
    R, T = slam.kfbuf.R[slot], slam.kfbuf.T[slot]
    intr = half_res_intrinsics(slam.intr) if coarse else slam.intr
    cfg = coarse_render_config(slam.rcfg_track) if coarse else slam.rcfg_track
    ntx, nty = cfg.grid(intr)
    proj = tr.project_gaussians(p["means"], p["quats"], p["log_scales"], active, R, T, intr)
    colors, opac = tr._blend_inputs(p, active)
    fields = tr._fields(proj["mean2d"], proj["conic"], colors, opac, proj["depth"])
    goff = torch.zeros(1, dtype=torch.int32, device=fields.device)
    pb = tr.prepare_bins(p, active, R, T, intr, cfg)
    args = [tr._gather_rows(fields, pb.gid).contiguous(), pb.cg, pb.k0, goff, pb.tids]
    return args, -(-ntx * nty // cfg.tile_group), ntx, cfg.slot_budget_per_tile


def main_path_dense_block(slam):
    """The (K, T, 10) slot block and counts that a run's exact render of its
    final map from the newest keyframe blends (dense, max_per_tile slots).
    Returns (tp, counts, ntx)."""
    from ..ops import rasterizer as tr

    p, active = slam.gmap.params(), slam.gmap.active
    slot = slam.kf_slots[slam.kf_indices[-1]]
    ntx, nty = slam.rcfg.grid(slam.intr)
    proj = tr.project_gaussians(p["means"], p["quats"], p["log_scales"], active,
                                slam.kfbuf.R[slot], slam.kfbuf.T[slot], slam.intr)
    tile_idx, slot_valid = tr._bin_for(proj, slam.rcfg, ntx, nty)
    colors, opac = tr._blend_inputs(p, active)
    tp = tr._tile_params(tile_idx, proj["mean2d"], proj["conic"], colors, opac, proj["depth"])
    return tp, slot_valid.sum(dim=1, dtype=torch.int32), ntx
