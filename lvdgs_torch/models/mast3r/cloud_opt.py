"""MASt3R cloud optimisation in PyTorch (port of
``lvdgs_tpu/models/mast3r/cloud_opt.py``).

- `batched_triangulate` / `matches_to_depths`: batched DLT triangulation of
  2D matches (normal equations and a batched 3x3 solve) and
  confidence-weighted depth aggregation; a degenerate system gives NaN.
- `tsdf_refine_depths`: per pixel, a search along the ray for the depth
  whose multi-view truncated signed distance is closest to zero. The
  candidate offsets come from a `torch.Generator`; `tsdf_refine_depths_core`
  takes them as input.
- `sparse_scene_optimizer` / `sparse_global_alignment`: sparse global
  alignment: per-image quaternion and translation composed along a
  maximum-score spanning tree, log-focals, principal points, log-sizes and
  subsampled ("core") depth maps, optimised in two Adam phases (a 3D
  matching loss at gamma 1.1, then a 2D reprojection loss at gamma 0.4)
  under a cosine learning-rate schedule. Each phase is a plain loop of
  `torch.autograd.grad` steps.

The reference's simplifications are kept: confidence-weighted canonical
views, no low-confidence-pair fallback loss and no low-rank depth
projection. Nothing in the SLAM loop calls this module.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# triangulation


def batched_triangulate(pts2d: torch.Tensor, proj_mats: torch.Tensor) -> torch.Tensor:
    """DLT triangulation. pts2d (B, Ncams, Npts, 2), proj_mats (B, Ncams, 3, 4)
    -> (B, Npts, 3) world points (NaN where the system is degenerate)."""
    B, Nc, Np, two = pts2d.shape
    assert two == 2 and proj_mats.shape == (B, Nc, 3, 4)
    # rows: P0 - x P2 and P1 - y P2
    x = proj_mats[:, :, None, 0, :] - pts2d[..., 0:1] * proj_mats[:, :, None, 2, :]
    y = proj_mats[:, :, None, 1, :] - pts2d[..., 1:2] * proj_mats[:, :, None, 2, :]
    eq = torch.cat([x, y], dim=1).transpose(1, 2)  # (B, Npts, 2Nc, 4)
    A = eq[..., :3]
    b = -eq[..., 3]
    # least squares through the normal equations: (A^T A) p = A^T b
    AtA = torch.einsum("bpni,bpnj->bpij", A, A)
    Atb = torch.einsum("bpni,bpn->bpi", A, b)
    # solve_ex does not raise on a singular system; those rows are masked
    sol = torch.linalg.solve_ex(AtA, Atb[..., None])[0][..., 0]
    ok = torch.linalg.det(AtA) > 1e-12
    return torch.where(ok[..., None], sol, torch.full_like(sol, math.nan))


def matches_to_depths(
    intrinsics: torch.Tensor,  # (B, Ncams, 3, 3)
    extrinsics: torch.Tensor,  # (B, Ncams, 3, 4) w2c
    matches: torch.Tensor,  # (B, Ncams-1, H, W, 5) = (x1, y1, x2, y2, conf)
    min_num_valids_ratio: float = 0.3,
):
    """Triangulate each pair's matches against the reference view and
    aggregate them into a confidence-weighted depth map. Returns (points
    (B,H,W,3), depths (B,H,W), confs (B,H,W))."""
    B, Nv, H, W, five = matches.shape
    assert five == 5
    pts1 = matches[..., 0:2].reshape(B * Nv, 1, H * W, 2)
    pts2 = matches[..., 2:4].reshape(B * Nv, 1, H * W, 2)
    confs = matches[..., 4]

    P_all = torch.einsum("bnij,bnjk->bnik", intrinsics, extrinsics)  # (B, Nc, 3, 4)
    P1 = P_all[:, 0:1].expand(B, Nv, 3, 4).reshape(B * Nv, 1, 3, 4)
    P2 = P_all[:, 1:].reshape(B * Nv, 1, 3, 4)

    pts3d = batched_triangulate(torch.cat([pts1, pts2], dim=1), torch.cat([P1, P2], dim=1))
    pts3d = pts3d.reshape(B, Nv, H, W, 3)
    valid = torch.isfinite(pts3d).all(dim=-1)
    confs = torch.where(valid, confs, torch.zeros_like(confs))
    w = confs / torch.clamp(confs.sum(dim=1, keepdim=True), min=1e-5)
    agg = torch.nansum(torch.where(valid[..., None], pts3d, torch.zeros_like(pts3d)) * w[..., None], dim=1)
    n_valid = valid.sum(dim=1)
    enough = n_valid > math.floor(Nv * min_num_valids_ratio)
    agg = torch.where(enough[..., None], agg, torch.full_like(agg, math.nan))

    # world -> reference-camera depth
    E0 = extrinsics[:, 0]
    pc = torch.einsum("bij,bhwj->bhwi", E0[:, :3, :3], agg) + E0[:, None, None, :3, 3]
    return agg, pc[..., 2], confs.sum(dim=1)


# ---------------------------------------------------------------------------
# TSDF depth refinement


def _project(pts: torch.Tensor, cam2w: torch.Tensor, focals: torch.Tensor, pps: torch.Tensor):
    """(..., 3) world points -> pixel xy and camera depth in each of N views.
    cam2w (N,4,4), focals (N,) or (N,2), pps (N,2). Returns xy (N, ..., 2),
    z (N, ...)."""
    N = cam2w.shape[0]
    ones = (1,) * (pts.ndim - 1)
    R = cam2w[:, :3, :3]
    t = cam2w[:, :3, 3]
    pc = torch.einsum("nji,...j->n...i", R, pts) - torch.einsum("nji,nj->ni", R, t).reshape((N,) + ones + (3,))
    f = focals[:, None] if focals.ndim == 1 else focals
    f = f.reshape((N,) + ones + (-1,))
    pp = pps.reshape((N,) + ones + (2,))
    z = pc[..., 2]
    xy = pc[..., :2] / torch.clamp(z[..., None].abs(), min=1e-9) * torch.sign(z[..., None]) * f + pp
    return xy, z


def tsdf_query(qpts, depthmaps, confs, cam2w, focals, pps, thresh: float):
    """Confidence-weighted truncated SDF of query points (Q, 3) against all
    views (depthmaps, confs (N, H, W)). Returns (tsdf (Q,), valid (Q,))."""
    N, H, W = depthmaps.shape
    xy, z = _project(qpts, cam2w, focals, pps)  # (N, Q, 2), (N, Q)
    xi = torch.round(xy[..., 0]).to(torch.int64)
    yi = torch.round(xy[..., 1]).to(torch.int64)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & (z > 0)
    flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    dm = torch.gather(depthmaps.reshape(N, H * W), 1, flat)
    cf = torch.gather(confs.reshape(N, H * W), 1, flat)
    sdf = dm - z
    unseen = sdf < -thresh
    tsdf = torch.clamp(sdf, min=-thresh)
    wgt = torch.exp(cf) * (~unseen) * inb
    wsum = wgt.sum(dim=0)
    valid = wsum > 0
    vals = (wgt * tsdf).sum(dim=0) / torch.clamp(wsum, min=1e-9)
    return torch.where(valid, vals, torch.zeros_like(vals)), valid


def tsdf_refine_depths_core(depthmaps, confs, cam2w, focals, pps, noise: Sequence[torch.Tensor],
                            thresh: float = 0.1) -> torch.Tensor:
    """Refine every depth map toward the TSDF zero level along each ray,
    one pass per entry of `noise`: the standard-normal draws (N, H, W, S)
    of that pass, which become the candidate offsets (noise - 1) times the
    pass's threshold. Returns the refined (N, H, W) depth maps."""
    N, H, W = depthmaps.shape
    niter = len(noise)
    dev = depthmaps.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    out = []
    for vi in range(N):
        fx = focals[vi] if focals.ndim == 1 else focals[vi, 0]
        fy = focals[vi] if focals.ndim == 1 else focals[vi, 1]
        R, t = cam2w[vi, :3, :3], cam2w[vi, :3, 3]
        dm = depthmaps[vi]
        for it in range(niter):
            curthresh = (niter - it) * thresh
            cand = dm[..., None] + (noise[it][vi] - 1.0) * curthresh  # (H, W, S)
            x = (xs[..., None] - pps[vi, 0]) / fx * cand
            y = (ys[..., None] - pps[vi, 1]) / fy * cand
            pts = torch.einsum("ij,hwsj->hwsi", R, torch.stack([x, y, cand], dim=-1)) + t
            vals, valid = tsdf_query(pts.reshape(-1, 3), depthmaps, confs, cam2w, focals, pps, curthresh)
            vals = torch.where(valid, vals.abs(), torch.full_like(vals, math.inf)).reshape(cand.shape)
            best = torch.argmin(vals, dim=-1)
            allbad = ~torch.isfinite(vals).any(dim=-1)
            picked = torch.gather(cand, -1, best[..., None])[..., 0]
            dm = torch.where(allbad, dm, picked)
        out.append(dm)
    return torch.stack(out)


def tsdf_refine_depths(depthmaps, confs, cam2w, focals, pps, generator: Optional[torch.Generator] = None,
                       thresh: float = 0.1, niter: int = 1, nsamples: int = 128) -> torch.Tensor:
    """`tsdf_refine_depths_core` with its candidate offsets drawn from
    `generator` (on the depth maps' device), `nsamples` a pixel and pass."""
    N, H, W = depthmaps.shape
    noise = [torch.randn((N, H, W, nsamples), generator=generator, device=depthmaps.device)
             for _ in range(niter)]
    return tsdf_refine_depths_core(depthmaps, confs, cam2w, focals, pps, noise, thresh)


# ---------------------------------------------------------------------------
# sparse global alignment


def gamma_loss(dist: torch.Tensor, gamma: float, clip: float = math.inf) -> torch.Tensor:
    """Robust |d|^gamma loss with unit slope at 0."""
    if gamma == 1.0:
        return dist
    offset = (1.0 / gamma) ** (1.0 / (gamma - 1.0))
    return (torch.clamp(dist, max=clip) + offset) ** gamma - offset**gamma


def cosine_schedule(alpha, lr_base, lr_end=0.0):
    """Scalars (NumPy float32 keeps float32 rounding)."""
    return lr_end + (lr_base - lr_end) * (1 + np.cos(alpha * np.float32(np.pi))) / 2


def _quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw -> (..., 3, 3)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


class Correspondences(NamedTuple):
    """Flattened correspondences between image pairs: row m ties anchor
    `a1[m]` of image `i[m]` (at pixel `xy1[m]`) to anchor `a2[m]` of image
    `j[m]` (at pixel `xy2[m]`) with confidence `conf[m]` (0 for padding);
    `rel1`/`rel2` are the match pixel's depth relative to its anchor's (1.0
    without a full-resolution depth to measure it from)."""

    i: torch.Tensor  # (M,) int64
    j: torch.Tensor
    a1: torch.Tensor  # (M,) anchor index into core_depth[i]
    a2: torch.Tensor
    xy1: torch.Tensor  # (M, 2) pixels in image i
    xy2: torch.Tensor
    conf: torch.Tensor  # (M,)
    rel1: torch.Tensor  # (M,)
    rel2: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SparseGAConfig:
    """The reference's sparse_scene_optimizer defaults."""

    lr1: float = 0.2
    niter1: int = 500
    gamma1: float = 1.1
    lr2: float = 0.02
    niter2: int = 500
    gamma2: float = 0.4
    opt_pp: bool = True
    opt_depth: bool = True
    lr_end_factor: float = 1e-2
    b1: float = 0.9
    b2: float = 0.9  # Adam(betas=(0.9, 0.9))
    eps: float = 1e-8


class SparseGAResult(NamedTuple):
    cam2w: torch.Tensor  # (N, 4, 4)
    intrinsics: torch.Tensor  # (N, 3, 3)
    anchor_depths: torch.Tensor  # (N, S) optimised anchor depths
    pts3d: torch.Tensor  # (N, S, 3) anchor points in the world
    loss1: torch.Tensor
    loss2: torch.Tensor


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The median along `dim` with an even count's two middle values
    averaged, as jnp.median does (torch.median takes the lower one)."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo, hi = s.narrow(dim, (n - 1) // 2, 1), s.narrow(dim, n // 2, 1)
    return ((lo + hi) * 0.5).squeeze(dim)


def _cam2w(Rw: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=Rw.dtype, device=Rw.device).expand(Rw.shape[0], 1, 4)
    return torch.cat([torch.cat([Rw, t[..., None]], -1), bottom], dim=1)


PARAM_NAMES = ("quats", "trans", "log_focals", "pps", "log_sizes", "core_depth")


def sparse_scene_optimizer(
    imsizes: torch.Tensor,  # (N, 2) [W, H]
    pps0: torch.Tensor,  # (N, 2) pixels
    base_focals: torch.Tensor,  # (N,)
    core_depth0: torch.Tensor,  # (N, S) initial anchor depths
    anchor_xy: torch.Tensor,  # (N, S, 2) pixel of each anchor
    corres: Correspondences,
    *,
    mst_root: int,
    mst_edges: Tuple[Tuple[int, int], ...],
    cfg: SparseGAConfig = SparseGAConfig(),
    depth_mode: str = "add",
) -> SparseGAResult:
    """Two-phase sparse global alignment, on the inputs' device.

    Cameras are a kinematic chain over the spanning tree: each image holds a
    relative (quat, trans) to its tree parent; focals, principal points,
    log-sizes and core depths are per image. Phase 1 minimises the
    confidence-weighted 3D distance between matched anchors (poses and
    sizes only); phase 2 the 2D reprojection error of the partner anchor
    (intrinsics and depths as `cfg` allows)."""
    N, S = core_depth0.shape
    dev, f32 = core_depth0.device, torch.float32
    imsizes = imsizes.to(f32)

    median_depths = _median(core_depth0, 1)
    core0 = core_depth0 / torch.clamp(median_depths[:, None], min=1e-9)
    diags = torch.linalg.norm(imsizes, dim=1)
    min_f, max_f = 0.25 * diags, 10.0 * diags

    params0 = {
        "quats": torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=f32, device=dev).repeat(N, 1),
        "trans": torch.zeros((N, 3), dtype=f32, device=dev),
        "log_focals": torch.log(base_focals.to(f32)),
        "pps": pps0.to(f32) / imsizes,  # normalised
        "log_sizes": torch.zeros((N,), dtype=f32, device=dev),
        "core_depth": core0.to(f32),
    }

    def make_cams(p):
        focals = torch.minimum(torch.maximum(torch.exp(p["log_focals"]), min_f), max_f)  # (N,)
        pps_pix = p["pps"] * imsizes
        sizes = torch.exp(p["log_sizes"])
        global_scaling = 1.0 / sizes.min()
        z_cameras = sizes * median_depths * focals / base_focals

        R_rel = _quat_to_rotmat(p["quats"])
        t_rel = p["trans"]
        # the kinematic chain along the spanning tree
        Rw: List = [None] * N
        tw: List = [None] * N
        Rw[mst_root] = R_rel[mst_root]
        tw[mst_root] = t_rel[mst_root]
        for pi, ci in mst_edges:
            Rw[ci] = Rw[pi] @ R_rel[ci]
            tw[ci] = Rw[pi] @ t_rel[ci] + tw[pi]
        Rw = torch.stack(Rw)
        tw = torch.stack(tw)

        # recentre so that the camera sits z_cameras in front of its focal plane
        trans_offset = z_cameras[:, None] * torch.cat(
            [imsizes / focals[:, None] * (0.5 - p["pps"]), torch.ones((N, 1), dtype=f32, device=dev)], dim=-1)
        t_new = global_scaling * (tw - torch.einsum("nij,nj->ni", Rw, trans_offset))

        if depth_mode == "add":
            depths = z_cameras[:, None] + (p["core_depth"] - 1.0) * (median_depths * sizes)[:, None]
        else:  # 'mul'
            depths = z_cameras[:, None] * p["core_depth"]
        depths = global_scaling * torch.clamp(depths, min=1e-6)
        return Rw, t_new, depths, focals, pps_pix

    def anchors_world(Rw, t, depths, focals, pps_pix):
        rays = torch.cat([(anchor_xy - pps_pix[:, None, :]) / focals[:, None, None],
                          torch.ones((N, S, 1), dtype=f32, device=dev)], dim=-1)
        return torch.einsum("nij,nsj->nsi", Rw, rays * depths[..., None]) + t[:, None, :]

    def match_points(Rw, t, depths, focals, pps_pix, idx, a, xy, rel):
        """World point of each match: its exact pixel's ray at the depth of
        the pixel's anchor."""
        d = depths[idx, a] * rel
        rays = torch.cat([(xy - pps_pix[idx]) / focals[idx][:, None],
                          torch.ones((xy.shape[0], 1), dtype=f32, device=dev)], dim=-1)
        return torch.einsum("mij,mj->mi", Rw[idx], rays * d[:, None]) + t[idx]

    conf_sum = torch.clamp(corres.conf.sum(), min=1e-9)

    def both_points(p):
        Rw, t, depths, focals, pps_pix = make_cams(p)
        p1 = match_points(Rw, t, depths, focals, pps_pix, corres.i, corres.a1, corres.xy1, corres.rel1)
        p2 = match_points(Rw, t, depths, focals, pps_pix, corres.j, corres.a2, corres.xy2, corres.rel2)
        return Rw, t, focals, pps_pix, p1, p2

    def loss_3d(p):
        _, _, _, _, p1, p2 = both_points(p)
        d = torch.linalg.norm(p1 - p2, dim=-1)
        return (corres.conf * gamma_loss(d, cfg.gamma1)).sum() / conf_sum

    def loss_2d(p):
        Rw, t, focals, pps_pix, p1, p2 = both_points(p)

        def reproj(idx, pts, xy_target):
            # each match's partner point in the match's own view
            R = Rw[idx]
            pc = torch.einsum("mji,mj->mi", R, pts) - torch.einsum("mji,mj->mi", R, t[idx])
            z = pc[:, 2:3]
            xy = pc[:, :2] / torch.clamp(z.abs(), min=1e-9) * torch.sign(z) * focals[idx][:, None] + pps_pix[idx]
            return torch.linalg.norm(xy - xy_target, dim=-1)

        d1 = reproj(corres.i, p2, corres.xy1)
        d2 = reproj(corres.j, p1, corres.xy2)
        # pixel errors over the image diagonal (scale invariance)
        l = gamma_loss(d1 / diags[corres.i] * 512.0, cfg.gamma2) + \
            gamma_loss(d2 / diags[corres.j] * 512.0, cfg.gamma2)
        return (corres.conf * l).sum() / (2 * conf_sum)

    # phase 1 optimises poses and sizes only; phase 2 also intrinsics and depth
    frozen1 = {"quats": False, "trans": False, "log_focals": True, "pps": True, "log_sizes": False,
               "core_depth": True}
    frozen2 = {"quats": False, "trans": False, "log_focals": False, "pps": not cfg.opt_pp,
               "log_sizes": False, "core_depth": not cfg.opt_depth}

    def run_phase(params, loss_fn, lr_base, steps, frozen):
        names = [k for k in PARAM_NAMES if not frozen[k]]
        m = {k: torch.zeros_like(params[k]) for k in names}
        v = {k: torch.zeros_like(params[k]) for k in names}
        params = dict(params)
        one = np.float32(1.0)
        for it in range(steps):
            # the schedule and the bias corrections in float32, as the
            # reference computes them: Adam's first steps turn rounding of
            # these scalars into ties (or not) between equal-sized updates
            alpha = np.float32(it) / np.float32(max(steps, 1))
            lr = cosine_schedule(alpha, np.float32(lr_base), np.float32(lr_base * cfg.lr_end_factor))
            leaves = {k: params[k].detach().requires_grad_(True) for k in names}
            grads = torch.autograd.grad(loss_fn({**params, **leaves}), [leaves[k] for k in names])
            itf = np.float32(it + 1)
            bc1, bc2 = one - np.float32(cfg.b1) ** itf, one - np.float32(cfg.b2) ** itf
            for k, g in zip(names, grads):
                g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                m[k] = cfg.b1 * m[k] + (1 - cfg.b1) * g
                v[k] = cfg.b2 * v[k] + (1 - cfg.b2) * g * g
                # divided by full tensors: torch divides by a scalar through
                # its reciprocal, which rounds otherwise
                mh = m[k] / torch.full_like(g, float(bc1))
                vh = v[k] / torch.full_like(g, float(bc2))
                upd = float(lr) * mh / (torch.sqrt(vh) + cfg.eps)
                if k in ("quats", "trans"):
                    upd[mst_root] = 0.0  # the root camera is pinned (gauge freedom)
                params[k] = params[k] - upd
            # unit quaternions keep Adam well scaled
            params["quats"] = params["quats"] / (torch.linalg.norm(params["quats"], dim=-1, keepdim=True) + 1e-12)
        with torch.no_grad():
            return params, loss_fn(params)

    params, l1 = run_phase(params0, loss_3d, cfg.lr1, cfg.niter1, frozen1)
    params, l2 = run_phase(params, loss_2d, cfg.lr2, cfg.niter2, frozen2)

    with torch.no_grad():
        Rw, t, depths, focals, pps_pix = make_cams(params)
        K = torch.zeros((N, 3, 3), dtype=f32, device=dev)
        K[:, 0, 0] = focals
        K[:, 1, 1] = focals
        K[:, :2, 2] = pps_pix
        K[:, 2, 2] = 1.0
        return SparseGAResult(cam2w=_cam2w(Rw, t), intrinsics=K, anchor_depths=depths,
                              pts3d=anchors_world(Rw, t, depths, focals, pps_pix), loss1=l1, loss2=l2)


def compute_min_spanning_tree(scores: np.ndarray) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
    """Maximum-score spanning tree and the root farthest from its leaves,
    on the host (scipy)."""
    from scipy import sparse as sp

    n = scores.shape[0]
    graph = sp.dok_array((n, n))
    for i, j in zip(*np.nonzero(scores)):
        graph[i, j] = -float(scores[i, j])
    msp = sp.csgraph.minimum_spanning_tree(graph)

    def bfs_dist(start):
        d, _ = sp.csgraph.breadth_first_order(msp, start, directed=False, return_predecessors=True)
        ranks = np.zeros(n, dtype=np.int64)
        ranks[d] = np.arange(len(d))
        return ranks

    r1 = bfs_dist(0)
    r2 = bfs_dist(int(r1.argmax()))
    r1 = bfs_dist(int(r2.argmax()))
    root = int(np.minimum(r1, r2).argmax())
    order, preds = sp.csgraph.breadth_first_order(msp, root, directed=False)
    edges = tuple((int(preds[i]), int(i)) for i in order[1:])
    return root, edges


def build_correspondences(canonical_depths: Sequence[np.ndarray], pair_matches, subsample: int):
    """Host side of `sparse_global_alignment`: the anchors' pixels (N, S, 2),
    the initial core depths (N, S), the matches snapped to the anchor grid
    as NumPy `Correspondences` fields, and the pair scores (N, N)."""
    N = len(canonical_depths)
    hs, ws = canonical_depths[0].shape
    S = hs * ws
    ys, xs = np.meshgrid(np.arange(hs), np.arange(ws), indexing="ij")
    anchor_xy_one = np.stack([xs * subsample + subsample / 2, ys * subsample + subsample / 2], -1).reshape(S, 2)
    anchor_xy = np.tile(anchor_xy_one[None], (N, 1, 1)).astype(np.float32)
    core_depth0 = np.stack([np.asarray(d).reshape(S) for d in canonical_depths]).astype(np.float32)

    scores = np.zeros((N, N), np.float64)
    ii, jj, a1, a2, xy1, xy2, cf = [], [], [], [], [], [], []
    for (i, j, mxy1, mxy2, conf) in pair_matches:
        g1x = np.clip((mxy1[:, 0] // subsample).astype(np.int64), 0, ws - 1)
        g1y = np.clip((mxy1[:, 1] // subsample).astype(np.int64), 0, hs - 1)
        g2x = np.clip((mxy2[:, 0] // subsample).astype(np.int64), 0, ws - 1)
        g2y = np.clip((mxy2[:, 1] // subsample).astype(np.int64), 0, hs - 1)
        ii.append(np.full(len(conf), i))
        jj.append(np.full(len(conf), j))
        a1.append(g1y * ws + g1x)
        a2.append(g2y * ws + g2x)
        xy1.append(mxy1)
        xy2.append(mxy2)
        cf.append(conf)
        scores[i, j] = scores[j, i] = float(np.median(conf)) if len(conf) else 0.0
    M = sum(len(c) for c in cf)
    corres = {
        "i": np.concatenate(ii).astype(np.int64), "j": np.concatenate(jj).astype(np.int64),
        "a1": np.concatenate(a1).astype(np.int64), "a2": np.concatenate(a2).astype(np.int64),
        "xy1": np.concatenate(xy1).astype(np.float32), "xy2": np.concatenate(xy2).astype(np.float32),
        "conf": np.concatenate(cf).astype(np.float32),
        "rel1": np.ones((M,), np.float32), "rel2": np.ones((M,), np.float32),
    }
    return anchor_xy, core_depth0, corres, scores


def correspondences_to_device(corres: Dict[str, np.ndarray], device) -> Correspondences:
    return Correspondences(**{k: torch.as_tensor(v, device=device) for k, v in corres.items()})


def sparse_global_alignment(
    imsizes: np.ndarray,  # (N, 2) [W, H]
    base_focals: np.ndarray,  # (N,)
    pps: np.ndarray,  # (N, 2)
    canonical_depths: Sequence[np.ndarray],  # N x (hs, ws) subsampled depths
    pair_matches: Sequence[Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]],
    # (i, j, xy_i (M,2), xy_j (M,2), conf (M,)) per pair, pixel coordinates
    subsample: int = 8,
    cfg: SparseGAConfig = SparseGAConfig(),
    device=None,
) -> SparseGAResult:
    """Sparse alignment from per-image canonical depths and pairwise pixel
    matches, on `device` (the card when None). Matches snap to the
    subsample anchor grid."""
    dev = torch.device("cuda" if device is None else device)
    anchor_xy, core_depth0, corres, scores = build_correspondences(canonical_depths, pair_matches, subsample)
    root, edges = compute_min_spanning_tree(scores)
    f32 = dict(dtype=torch.float32, device=dev)
    return sparse_scene_optimizer(
        torch.as_tensor(np.asarray(imsizes), **f32), torch.as_tensor(np.asarray(pps), **f32),
        torch.as_tensor(np.asarray(base_focals), **f32), torch.as_tensor(core_depth0, device=dev),
        torch.as_tensor(anchor_xy, device=dev), correspondences_to_device(corres, dev),
        mst_root=root, mst_edges=edges, cfg=cfg,
    )
