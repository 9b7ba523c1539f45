"""The port's MASt3R cloud optimisation (lvdgs_torch/models/mast3r/cloud_opt.py):
copies of tests/test_cloud_opt.py on the port, and parity with the
reference on the same NumPy inputs.

Tolerances: triangulated points and depths 1e-5 absolute (float32 normal
equations, the same formulas); the TSDF refinement's picks equal, given the
reference's own draws; the spanning tree equal; the optimiser's parameters
after a few Adam steps within 1e-4 relative of the scene's scale (Adam
divides each gradient by its running magnitude, so rounding-level gradient
differences move parameters by far less than a step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (one thread, no TF32)
from lvdgs_torch.models.mast3r import cloud_opt as tco
from lvdgs_tpu.models.mast3r import cloud_opt as jco
from tests.test_cloud_opt import _lookat_cams, _project_np


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def test_batched_triangulate_recovers_points():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 3)) * 0.5
    c2w = _lookat_cams(3)
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    pts2d, projs = [], []
    for c in c2w:
        w2c = np.linalg.inv(c)
        xy, _ = _project_np(pts, w2c, K)
        pts2d.append(xy)
        projs.append(K @ w2c[:3])
    out = tco.batched_triangulate(_t(np.stack(pts2d)[None]), _t(np.stack(projs)[None]))
    np.testing.assert_allclose(out[0].numpy(), pts, atol=1e-2)


def _plane_matches(seed=1, H=8, W=10):
    rng = np.random.default_rng(seed)
    c2w = _lookat_cams(3)
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]])
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    d0 = 4.0 + 0.1 * rng.random((H, W))
    pc = np.stack([(xs - K[0, 2]) / K[0, 0] * d0, (ys - K[1, 2]) / K[1, 1] * d0, d0], -1)
    pw = pc.reshape(-1, 3) @ c2w[0][:3, :3].T + c2w[0][:3, 3]
    matches = []
    for c in c2w[1:]:
        xy2, _ = _project_np(pw, np.linalg.inv(c), K)
        xy1 = np.stack([xs, ys], -1).reshape(-1, 2)
        m = np.concatenate([xy1, xy2, np.ones((H * W, 1))], -1)
        matches.append(m.reshape(H, W, 5))
    extr = np.stack([np.linalg.inv(c)[:3] for c in c2w])
    intr = np.stack([K] * 3)
    return intr[None], extr[None], np.stack(matches)[None], d0


def test_matches_to_depths_aggregates():
    intr, extr, matches, d0 = _plane_matches()
    _, depths, _ = tco.matches_to_depths(_t(intr), _t(extr), _t(matches))
    np.testing.assert_allclose(depths[0].numpy(), d0, atol=0.02)


def _sphere_views(seed=2, H=16, W=16):
    rng = np.random.default_rng(seed)
    c2w = _lookat_cams(4, radius=3.0)
    f, pp = 40.0, np.array([W / 2, H / 2])

    def render_depth(c):
        ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
        rays = np.stack([(xs - pp[0]) / f, (ys - pp[1]) / f, np.ones((H, W))], -1)
        rays_w = rays @ c[:3, :3].T
        o = c[:3, 3]
        a = (rays_w**2).sum(-1)
        b = 2 * (rays_w * o).sum(-1)
        cc = (o**2).sum() - 1.0
        disc = b * b - 4 * a * cc
        t = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
        hit = disc > 0
        return np.where(hit, t, 2.5), hit

    depths, hits = zip(*[render_depth(c) for c in c2w])
    depths = np.stack(depths).astype(np.float32)
    confs = np.where(np.stack(hits), 3.0, 0.0).astype(np.float32)
    noisy = depths.copy()
    noise = (rng.random((H, W)).astype(np.float32) - 0.5) * 0.2
    noisy[0] = depths[0] + noise * hits[0]
    return noisy, depths, confs, c2w.astype(np.float32), np.full((4,), f, np.float32), \
        np.tile(pp, (4, 1)).astype(np.float32), hits


def test_tsdf_refine_pulls_depth_to_surface():
    """A perturbed view's depth moves toward the consensus of the clean
    views (the draws from a seeded torch.Generator)."""
    noisy, depths, confs, c2w, focals, pps, hits = _sphere_views()
    refined = tco.tsdf_refine_depths(_t(noisy), _t(confs), _t(c2w), _t(focals), _t(pps),
                                     torch.Generator().manual_seed(0), thresh=0.15, nsamples=64)
    err_before = np.abs(noisy[0] - depths[0])[hits[0]].mean()
    err_after = np.abs(refined[0].numpy() - depths[0])[hits[0]].mean()
    assert err_after < err_before * 0.8, (err_before, err_after)


def test_mst():
    scores = np.array([[0, 5, 1, 0], [5, 0, 4, 0.5], [1, 4, 0, 3], [0, 0.5, 3, 0]])
    root, edges = tco.compute_min_spanning_tree(scores)
    es = {tuple(sorted(e)) for e in edges}
    assert es == {(0, 1), (1, 2), (2, 3)}
    assert root in (1, 2)
    assert len(edges) == 3


def _ga_problem(seed=3, n=4, hs=6, ws=8, subsample=8):
    """4 views of a sphere, exact correspondences on the anchor grid, a
    wrong focal and noisy canonical depths (tests/test_cloud_opt.py)."""
    rng = np.random.default_rng(seed)
    W, H = ws * subsample, hs * subsample
    f = 70.0
    pp = np.array([W / 2, H / 2])
    c2w = _lookat_cams(n, radius=3.5)
    ys, xs = np.meshgrid(np.arange(hs) * subsample + subsample / 2,
                         np.arange(ws) * subsample + subsample / 2, indexing="ij")

    anchors_w, depths = [], []
    for c in c2w:
        rays = np.stack([(xs - pp[0]) / f, (ys - pp[1]) / f, np.ones((hs, ws))], -1)
        rays_w = rays @ c[:3, :3].T
        o = c[:3, 3]
        a = (rays_w**2).sum(-1)
        b = 2 * (rays_w * o).sum(-1)
        cc = (o**2).sum() - 1.2**2
        disc = np.maximum(b * b - 4 * a * cc, 0.01)
        t = (-b - np.sqrt(disc)) / (2 * a)
        anchors_w.append((o + rays_w * t[..., None]).reshape(-1, 3))
        depths.append(t)
    pair_matches = []
    K = np.array([[f, 0, pp[0]], [0, f, pp[1]], [0, 0, 1]])
    for i in range(n):
        for j in range(i + 1, n):
            xyj, zj = _project_np(anchors_w[i], np.linalg.inv(c2w[j]), K)
            ok = (zj > 0.5) & (xyj[:, 0] > 0) & (xyj[:, 0] < W) & (xyj[:, 1] > 0) & (xyj[:, 1] < H)
            xy1 = np.stack([xs, ys], -1).reshape(-1, 2)[ok]
            pair_matches.append((i, j, xy1, xyj[ok], np.full(ok.sum(), 2.0)))
    kw = dict(imsizes=np.tile([[W, H]], (n, 1)), base_focals=np.full(n, f * 1.15), pps=np.tile(pp, (n, 1)),
              canonical_depths=[d * (1.0 + 0.15 * rng.standard_normal()) for d in depths],
              pair_matches=pair_matches, subsample=subsample)
    return kw, c2w


def test_sparse_ga_recovers_geometry():
    kw, c2w = _ga_problem()
    res = tco.sparse_global_alignment(**kw, cfg=tco.SparseGAConfig(niter1=300, niter2=100), device="cpu")
    assert np.isfinite(float(res.loss1)) and np.isfinite(float(res.loss2))
    c_gt = c2w[:, :3, 3]
    c_est = res.cam2w[:, :3, 3].numpy()
    mu_g, mu_e = c_gt.mean(0), c_est.mean(0)
    g0, e0 = c_gt - mu_g, c_est - mu_e
    U, D, Vt = np.linalg.svd(e0.T @ g0)
    Smat = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    R = U @ Smat @ Vt
    s = (D * np.diag(Smat)).sum() / max((e0**2).sum(), 1e-12)
    resid = np.linalg.norm(s * e0 @ R - g0, axis=-1)
    scene_scale = np.linalg.norm(g0, axis=-1).mean()
    assert resid.max() / scene_scale < 0.25, (resid, scene_scale)
    d_gt = np.linalg.norm(c_gt[:, None] - c_gt[None], axis=-1)
    d_est = np.linalg.norm(c_est[:, None] - c_est[None], axis=-1)
    d_gt /= d_gt.max()
    d_est /= max(d_est.max(), 1e-9)
    assert np.abs(d_gt - d_est).max() < 0.2


# ----------------------------------------------------------------- parity


def test_triangulation_and_depths_match_reference_with_degenerate_rows():
    """Points and depths within 1e-5 of the reference's, NaN at the same
    places: a pair whose two projection matrices are equal (a zero
    baseline) leaves A^T A singular for every point, and a NaN match
    poisons its own point."""
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(30, 3)) * 0.5
    c2w = _lookat_cams(3)
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    pts2d, projs = [], []
    for c in c2w:
        w2c = np.linalg.inv(c)
        pts2d.append(_project_np(pts, w2c, K)[0])
        projs.append(K @ w2c[:3])
    pts2d, projs = np.stack(pts2d), np.stack(projs)
    degenerate_p = np.zeros_like(projs)  # every row zero: A^T A = 0
    pts2d_b = pts2d.copy()
    pts2d_b[:, 5] = np.nan
    P = np.stack([projs, projs, degenerate_p]).astype(np.float32)
    X = np.stack([pts2d, pts2d_b, pts2d]).astype(np.float32)
    ours = tco.batched_triangulate(_t(X), _t(P)).numpy()
    ref = np.asarray(jco.batched_triangulate(jnp.asarray(X), jnp.asarray(P)))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert np.isnan(ref[2]).all() and np.isnan(ref[1, 5]).all() and np.isfinite(ref[0]).all()
    np.testing.assert_allclose(ours, ref, atol=1e-5)

    intr, extr, matches, _ = _plane_matches(seed=5)
    matches = matches.copy()
    matches[0, 1, 2:4, 3:6, 2:4] = np.nan  # those pixels valid in one pair only
    outs = tco.matches_to_depths(_t(intr), _t(extr), _t(matches))
    refs = jco.matches_to_depths(jnp.asarray(intr, jnp.float32), jnp.asarray(extr, jnp.float32),
                                 jnp.asarray(matches, jnp.float32), min_num_valids_ratio=0.5)
    refs_default = jco.matches_to_depths(jnp.asarray(intr, jnp.float32), jnp.asarray(extr, jnp.float32),
                                         jnp.asarray(matches, jnp.float32))
    outs_half = tco.matches_to_depths(_t(intr), _t(extr), _t(matches), min_num_valids_ratio=0.5)
    for o, r in list(zip(outs, refs_default)) + list(zip(outs_half, refs)):
        o, r = o.numpy(), np.asarray(r)
        np.testing.assert_array_equal(np.isnan(o), np.isnan(r))
        np.testing.assert_allclose(o, r, atol=1e-5)
    assert np.isnan(np.asarray(refs[1][0, 2:4, 3:6])).all()  # one valid pair of 2 is not enough at 0.5


def test_tsdf_refine_matches_reference_on_its_draws():
    """The core, handed the reference's own normal draws (split per view,
    fold_in per pass), picks the same candidates: on one pass the picked
    sample of every pixel is the reference's (the depths themselves within
    1e-6: the candidate's sum may round differently), and on two passes the
    depth maps agree within 1e-6 (a different pick moves a depth by about
    the 0.15 threshold); the TSDF query itself within 1e-5."""
    noisy, _, confs, c2w, focals, pps, _ = _sphere_views(seed=6)
    N, H, W = noisy.shape
    S, thresh = 16, 0.15
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, N)
    for niter in (1, 2):
        draws = [np.stack([np.asarray(jax.random.normal(jax.random.fold_in(keys[v], it), (H, W, S)))
                           for v in range(N)]) for it in range(niter)]
        ref = np.asarray(jco.tsdf_refine_depths(jnp.asarray(noisy), jnp.asarray(confs), jnp.asarray(c2w),
                                                jnp.asarray(focals), jnp.asarray(pps), key, thresh=thresh,
                                                niter=niter, nsamples=S))
        ours = tco.tsdf_refine_depths_core(_t(noisy), _t(confs), _t(c2w), _t(focals), _t(pps),
                                           [_t(d) for d in draws], thresh=thresh).numpy()
        assert (np.abs(ref - noisy) > 1e-4).mean() > 0.3  # the refinement moved most pixels
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
        if niter == 1:
            cand = noisy[..., None] + (draws[0] - 1.0) * thresh
            moved = np.abs(ref - noisy) > 1e-6
            pick_ref = np.abs(cand - ref[..., None]).argmin(-1)
            pick_ours = np.abs(cand - ours[..., None]).argmin(-1)
            np.testing.assert_array_equal(pick_ours[moved], pick_ref[moved])
            np.testing.assert_array_equal(np.abs(ours - noisy) > 1e-6, moved)

    q = np.random.default_rng(7).normal(size=(200, 3)).astype(np.float32) * 0.8
    tv, tval = tco.tsdf_query(_t(q), _t(noisy), _t(confs), _t(c2w), _t(focals), _t(pps), 0.1)
    rv, rval = jco.tsdf_query(jnp.asarray(q), jnp.asarray(noisy), jnp.asarray(confs), jnp.asarray(c2w),
                              jnp.asarray(focals), jnp.asarray(pps), 0.1)
    np.testing.assert_array_equal(tval.numpy(), np.asarray(rval))
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=1e-5)


def test_spanning_tree_matches_reference():
    rng = np.random.default_rng(8)
    s = rng.uniform(0.1, 3.0, (7, 7)) * (rng.uniform(size=(7, 7)) > 0.3)
    s = np.triu(s, 1)
    s = s + s.T
    s[np.arange(6), np.arange(1, 7)] = s[np.arange(1, 7), np.arange(6)] = 0.05  # connected
    assert tco.compute_min_spanning_tree(s) == jco.compute_min_spanning_tree(s)


@pytest.mark.parametrize("depth_mode", ["add", "mul"])
def test_sparse_scene_optimizer_matches_reference(depth_mode):
    """A few Adam steps of each phase on the reference test's problem (seed
    3): an even anchor count (6x8), whose median averages the two middle
    depths; cameras, intrinsics, anchor depths and both losses within 1e-4
    of the scene's scale. The torch median would take the lower middle value.

    Not every problem agrees this closely: Adam's first step moves every
    log-size by +-lr to within a rounding, and the scene's scale is 1 /
    min(sizes); where two sizes tie at the minimum in one package and
    differ by an ulp in the other (seed 9, "mul"), the min's gradient splits
    differently and the runs part by a tenth of the scene."""
    kw, _ = _ga_problem(seed=3)
    cfg = jco.SparseGAConfig(niter1=12, niter2=8)
    anchor_xy, core0, corres, scores = tco.build_correspondences(kw["canonical_depths"], kw["pair_matches"],
                                                                 kw["subsample"])
    assert core0.shape[1] % 2 == 0
    root, edges = jco.compute_min_spanning_tree(scores)
    ref = jco.sparse_scene_optimizer(
        jnp.asarray(kw["imsizes"], jnp.float32), jnp.asarray(kw["pps"], jnp.float32),
        jnp.asarray(kw["base_focals"], jnp.float32), jnp.asarray(core0), jnp.asarray(anchor_xy),
        jco.Correspondences(**{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                               for k, v in corres.items()}),
        mst_root=root, mst_edges=edges, cfg=cfg, depth_mode=depth_mode)
    tcfg = tco.SparseGAConfig(niter1=12, niter2=8)
    ours = tco.sparse_scene_optimizer(
        _t(kw["imsizes"]), _t(kw["pps"]), _t(kw["base_focals"]), torch.as_tensor(core0),
        torch.as_tensor(anchor_xy), tco.correspondences_to_device(corres, "cpu"),
        mst_root=root, mst_edges=edges, cfg=tcfg, depth_mode=depth_mode)
    scale = float(np.abs(np.asarray(ref.pts3d)).max())
    for name in ("cam2w", "anchor_depths", "pts3d"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-4 * scale, err_msg=name)
    np.testing.assert_allclose(ours.intrinsics.numpy(), np.asarray(ref.intrinsics), rtol=1e-4)
    for name in ("loss1", "loss2"):
        np.testing.assert_allclose(float(getattr(ours, name)), float(getattr(ref, name)), rtol=1e-4)
    # the median: the mean of the two middle values, not the lower one
    med = tco._median(torch.as_tensor(core0), 1).numpy()
    np.testing.assert_array_equal(med, np.asarray(jnp.median(jnp.asarray(core0), axis=1)))
    assert (torch.as_tensor(core0).median(dim=1).values.numpy() != med).any()
