"""lvdgs_torch.slam and lvdgs_torch.data against lvdgs_tpu on the CPU, plus
the port's own SLAM loop.

The reference runs its Pallas kernels in interpret mode here, as its own
tests do. Both packages start from the same state, carried over by
lvdgs_torch/convert.py, on a 64x48 frame with 16x16 tiles and 64 slots per
tile. Renders agree to float32 rounding, but optimisation loops amplify it:
Adam normalises each gradient, so tolerances on optimised state are stated
per test.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_tpu.core import lie as jlie
from lvdgs_tpu.core.camera import Camera as JCamera
from lvdgs_tpu.core.camera import Intrinsics as JIntrinsics
from lvdgs_tpu.data import datasets as jds
from lvdgs_tpu.gaussian import model as jgm
from lvdgs_tpu.ops import rasterizer as jr
from lvdgs_tpu.slam import depth_alignment as jda
from lvdgs_tpu.slam import keyframe as jkf
from lvdgs_tpu.slam import mapping as jmp
from lvdgs_tpu.slam import state as jst
from lvdgs_tpu.slam import tracking as jtk
from lvdgs_torch import convert
from lvdgs_torch.core import lie as tlie
from lvdgs_torch.core.camera import Intrinsics
from lvdgs_torch.core.config import load_config
from lvdgs_torch.data import datasets as tds
from lvdgs_torch.gaussian import model as tgm
from lvdgs_torch.ops import rasterizer as tr
from lvdgs_torch.slam import depth_alignment as tda
from lvdgs_torch.slam import keyframe as tkf
from lvdgs_torch.slam import mapping as tmp
from lvdgs_torch.slam import system as tsys
from lvdgs_torch.slam import tracking as ttk
from lvdgs_torch.slam.system import SLAM
from torch_parity import assert_map_matches, camera_pair, leaves_np, map_to_torch, to_np

ROOT = os.path.join(os.path.dirname(__file__), "..")
BASE_CFG = os.path.join(ROOT, "configs", "mono", "synthetic", "base_config.yaml")
INTR_J = JIntrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
INTR = Intrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
CFG_J = jr.RenderConfig(tile_size=16, max_per_tile=64, gaussian_chunk=16, tile_chunk=16,
                        tile_group=4)
CFG = tr.RenderConfig(tile_size=16, max_per_tile=64, tile_chunk=16)
# keyframes along x; frame 0 is the map's origin
KF_X = [0.0, 0.05, 0.1, 0.15]


def _scene(n=400, seed=0):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(size=(n, 2)) * 1.2, rng.uniform(3.0, 7.0, size=(n, 1))], 1)
    p = {"means": means, "features_dc": rng.normal(size=(n, 3)),
         "log_scales": rng.uniform(-2.2, -1.4, size=(n, 3)), "quats": rng.normal(size=(n, 4)),
         "logit_opacities": rng.uniform(1.0, 3.0, size=(n,))}
    return {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}, jnp.ones((n,), bool)


@pytest.fixture(scope="module")
def world():
    """GT scene, a reference keyframe buffer of four rendered keyframes and a
    map seeded from keyframe 0."""
    params, active = _scene()
    buf = jst.create_keyframe_buffer(8, INTR_J.height, INTR_J.width)
    for i, dx in enumerate(KF_X):
        R, t = jnp.eye(3), jnp.array([dx, 0.0, 0.0], jnp.float32)
        out = jr.rasterize(params, active, R, t, INTR_J, CFG_J)
        depth = jnp.where(out.opacity[0] > 0.5, out.depth[0] / jnp.maximum(out.opacity[0], 1e-6), 0.0)
        cam = JCamera.create(i, out.image, INTR_J, mono_depth=depth).update_RT(R, t)
        if i:
            cam = cam.replace(exposure_a=jnp.float32(0.01 * i), exposure_b=jnp.float32(-0.005 * i))
        buf, _ = jst.add_keyframe(buf, cam)
    cam0 = jst.camera_from_slot(buf, jnp.asarray(0))
    gmap = jgm.seed_from_depth(jgm.create_map(2048), cam0, buf.mono_depth[0], INTR_J,
                               kf_id=0, downsample=4)
    return params, active, buf, gmap


def _kfbuf_to_torch(jbuf):
    return convert.keyframe_buffer_from_numpy(leaves_np(jbuf), "cpu")


# ---------------------------------------------------------------------------
# dataset


def _small_base_config(n_frames=3):
    cfg = load_config(BASE_CFG)
    cfg["Dataset"]["n_frames"] = n_frames
    cfg["Dataset"]["Calibration"].update({"fx": 60.0, "fy": 60.0, "width": 64, "height": 48,
                                          "cx": 32.0, "cy": 24.0})
    return cfg


def test_synthetic_frames_match_reference():
    cfg = _small_base_config()
    jd = jds.load_dataset(None, "", cfg)
    td = tds.load_dataset(None, "", cfg, "cpu")
    assert len(td) == len(jd) == 3
    for i in range(2):
        ji, jdep, jpose, jmono = jd[i]
        ti, tdep, tpose, tmono = td[i]
        np.testing.assert_array_equal(tpose, jpose)
        np.testing.assert_allclose(to_np(ti), np.asarray(ji), atol=3e-4)
        # depth is the alpha depth over opacity: 3e-3, as the reference's
        # own Pallas-vs-XLA depth tolerance, on pixels away from the 0.5 cut
        op_ok = (to_np(tdep) > 0) == (np.asarray(jdep) > 0)
        assert op_ok.mean() > 0.995
        np.testing.assert_allclose(to_np(tdep)[op_ok], np.asarray(jdep)[op_ok], rtol=3e-3, atol=3e-3)
        np.testing.assert_array_equal(to_np(tmono) > 0, to_np(tdep) > 0)


def test_street_scene_and_trajectory_match_reference():
    """The street world and its trajectory (frames are rendered lazily, so
    neither package renders here)."""
    cfg = load_config(os.path.join(ROOT, "configs", "mono", "synthetic", "street.yaml"))
    cfg["Dataset"]["n_frames"] = 12
    jd = jds.load_dataset(None, "", cfg)
    td = tds.load_dataset(None, "", cfg, "cpu")
    assert set(td._params) == set(jd._params)
    for k, v in jd._params.items():
        np.testing.assert_array_equal(to_np(td._params[k]), np.asarray(v), err_msg=k)
    for pt, pj in zip(td.poses, jd.poses, strict=True):
        np.testing.assert_array_equal(pt, pj)
    assert td.intrinsics.width == 1226 and td.intrinsics.height == 370


# ---------------------------------------------------------------------------
# keyframe fusion and policy


def test_process_depth_matches_reference():
    rng = np.random.default_rng(12)
    H, W = 48, 64
    render = rng.uniform(2.0, 8.0, size=(H, W)).astype(np.float32)
    render += np.linspace(0, 2, W, dtype=np.float32)[None]
    render[rng.uniform(size=(H, W)) < 0.05] = 0.0
    mono = (render * 0.8 * (1 + 0.03 * rng.normal(size=(H, W)))).astype(np.float32)
    mono[10:20, 10:30] *= 1.6  # a region the alignment must reject
    kw = dict(patch_size=10, mean_threshold=0.3, std_threshold=0.3, error_threshold=0.1,
              final_error_threshold=0.15, min_accurate_pixels_ratio=0.01)
    fj, sj, ej, nj = jda.process_depth(jnp.asarray(render), jnp.asarray(mono), **kw)
    ft, st, et, nt = tda.process_depth(torch.tensor(render), torch.tensor(mono), **kw)
    assert 1.1 < float(sj) < 1.4
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(to_np(et), np.asarray(ej))
    np.testing.assert_allclose(to_np(ft), np.asarray(fj), rtol=1e-5)
    # the scale remedy when too few pixels align
    kw["min_accurate_pixels_ratio"] = 0.99
    fj, sj, ej, _ = jda.process_depth(jnp.asarray(render), jnp.asarray(mono), remedy_fn=lambda: 1.3, **kw)
    ft, st, et, _ = tda.process_depth(torch.tensor(render), torch.tensor(mono), remedy_fn=lambda: 1.3, **kw)
    assert float(st) == float(sj) == pytest.approx(1.3)
    np.testing.assert_array_equal(to_np(et), np.asarray(ej))
    np.testing.assert_allclose(to_np(ft), np.asarray(fj), rtol=1e-6)


def test_keyframe_policy_matches_reference():
    rng = np.random.default_rng(13)
    C = 500
    poses = {}
    for k in range(9):
        R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.05, jnp.float32)))
        poses[k] = (R, np.array([0.02 * k, 0.0, 0.3 * k], np.float32) + rng.normal(size=3).astype(np.float32) * 0.01)
    vis = {k: rng.uniform(size=C) < 0.3 + 0.05 * k for k in poses}
    curr = vis[8]
    for median_depth in (0.5, 4.0, 40.0):
        for last in (0, 6, 7):
            kw = dict(curr_R=poses[8][0], curr_T=poses[8][1], last_kf_R=poses[last][0],
                      last_kf_T=poses[last][1], median_depth=median_depth, kf_translation=0.08,
                      kf_min_translation=0.05, kf_overlap=0.9)
            stats_t = tkf.visibility_pair_stats(torch.tensor(curr), torch.tensor(vis[last]))
            stats_j = jkf.visibility_pair_stats(jnp.asarray(curr), jnp.asarray(vis[last]))
            np.testing.assert_array_equal(to_np(stats_t), np.asarray(stats_j))
            for stats in (None, to_np(stats_t)):
                assert tkf.is_keyframe(curr_visibility=torch.tensor(curr),
                                       last_kf_visibility=torch.tensor(vis[last]),
                                       overlap_stats=stats, **kw) == jkf.is_keyframe(
                    curr_visibility=jnp.asarray(curr), last_kf_visibility=jnp.asarray(vis[last]),
                    overlap_stats=stats, **kw)
    occ = np.stack([vis[k] for k in range(7, -1, -1)])
    np.testing.assert_array_equal(
        to_np(tkf.visibility_window_stats(torch.tensor(curr), torch.tensor(occ))),
        np.asarray(jkf.visibility_window_stats(jnp.asarray(curr), jnp.asarray(occ))))
    for initialized in (False, True):
        for window_size in (4, 8):
            window = list(range(7, -1, -1))[:window_size]
            kw = dict(cur_frame_idx=8, window=window, poses=poses, window_size=window_size,
                      kf_cutoff=0.3, initialized=initialized)
            wt = tkf.add_to_window(curr_visibility=torch.tensor(curr),
                                   occ_visibility={k: torch.tensor(v) for k, v in vis.items()}, **kw)
            wj = jkf.add_to_window(curr_visibility=jnp.asarray(curr),
                                   occ_visibility={k: jnp.asarray(v) for k, v in vis.items()}, **kw)
            assert wt == wj


# ---------------------------------------------------------------------------
# tracking


@pytest.fixture(scope="module")
def tracked(world):
    params, active, _, _ = world
    gt = jr.rasterize(params, active, jnp.eye(3), jnp.zeros(3), INTR_J, CFG_J)
    tau = jnp.array([0.02, -0.015, 0.03, 0.008, -0.006, 0.01])
    Rp, tp = jlie.apply_delta(jnp.eye(3), jnp.zeros(3), tau)
    cam = JCamera.create(5, gt.image, INTR_J).update_RT(Rp, tp)
    tcfg_kw = dict(max_iters=60)
    res_j = jtk.track_camera(params, active, cam, INTR_J, CFG_J, jtk.TrackingConfig(**tcfg_kw))
    pt = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    res_t = ttk.track_camera(pt, torch.tensor(np.asarray(active)), camera_pair(cam)[1], INTR, CFG,
                             ttk.TrackingConfig(**tcfg_kw))
    return res_j, res_t, (np.asarray(Rp), np.asarray(tp))


def test_tracking_recovers_perturbed_pose(tracked):
    _, res_t, (Rp, tp) = tracked
    rot_err = float(np.linalg.norm(to_np(tlie.so3_log(res_t.R))))
    rot_err0 = float(np.linalg.norm(to_np(tlie.so3_log(torch.tensor(Rp)))))
    assert rot_err < 0.02, rot_err
    assert rot_err < 0.5 * rot_err0
    assert float(np.linalg.norm(to_np(res_t.T))) < 0.35 * float(np.linalg.norm(tp))
    assert res_t.iterations > 3 and float(res_t.median_depth) > 0


def test_tracking_matches_reference(tracked):
    res_j, res_t, _ = tracked
    # 60 Adam steps on a pose: rounding differences between the two
    # renderers move the result by well under a millimetre and a milliradian
    assert res_t.iterations == int(res_j.iterations)
    np.testing.assert_allclose(to_np(res_t.T), np.asarray(res_j.T), atol=1e-3)
    rel = to_np(res_t.R) @ np.asarray(res_j.R).T
    assert float(np.linalg.norm(to_np(tlie.so3_log(torch.tensor(rel))))) < 1e-3
    np.testing.assert_allclose(float(res_t.exposure_a), float(res_j.exposure_a), atol=1e-3)
    np.testing.assert_allclose(float(res_t.exposure_b), float(res_j.exposure_b), atol=1e-3)
    np.testing.assert_allclose(float(res_t.median_depth), float(res_j.median_depth), rtol=1e-3)
    nt_t, nt_j = to_np(res_t.n_touched) > 0, np.asarray(res_j.n_touched) > 0
    assert (nt_t == nt_j).mean() > 0.99


# ---------------------------------------------------------------------------
# mapping


def _assert_optimised_map_close(tmap, jmap, n_steps, opt, kfbuf):
    """Maps after `n_steps` Adam steps in each package. Means, colours and
    opacities agree to 1e-4 for 99% of components. Log-scales and rotations
    of (near-)isotropic Gaussians have gradients at rounding level (the
    isotropic regulariser at exact isotropy, the rotation of a sphere), which
    Adam normalises to steps of +-lr in either direction: those agree to
    2 lr per step. What the maps render agrees to 1e-3."""
    lrs = opt.lrs(0)
    for f in tgm.PARAM_FIELDS:
        d = np.abs(to_np(getattr(tmap, f)) - np.asarray(getattr(jmap, f)))
        if f in ("log_scales", "quats"):
            assert d.max() <= 2.0 * lrs[f] * n_steps, f
        else:
            assert np.quantile(d, 0.99) < 1e-4, f
            assert d.max() < 1e-2, f
    np.testing.assert_array_equal(to_np(tmap.active), np.asarray(jmap.active))
    jm = map_to_torch(jmap)
    for slot in range(kfbuf.count):
        a, b = (tr.rasterize(m.params(), m.active, kfbuf.R[slot], kfbuf.T[slot], INTR, CFG).image
                for m in (tmap, jm))
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-3)


def _mcfg(mod, **kw):
    base = dict(window_size=3, n_random=2, gaussian_update_every=100000, gaussian_reset=100000,
                rebin_every=5)
    return mod.MappingConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def mapped(world):
    """Ten window iterations in both packages: keyframes 3 and 2 in a window
    of 3 (one padded slot), so exactly keyframes 0 and 1 are eligible for
    replay and both are drawn whatever the random draw."""
    _, _, jbuf, jmap0 = world
    opt_j, opt_t = jgm.MapOptimizer(spatial_scale=2.0), tgm.MapOptimizer(spatial_scale=2.0)
    jopt0 = opt_j.init(jmap0)
    tmap, topt = map_to_torch(jmap0, jopt0)
    tbuf = _kfbuf_to_torch(jbuf)
    start = (tmap.clone(), topt.clone())
    slots = [3, 2, -1]
    jmap_in = jax.tree_util.tree_map(lambda a: a.copy(), jmap0)  # mapping_run donates
    res_j = jmp.mapping_run(jmap_in, jopt0, jbuf, jnp.asarray(slots, jnp.int32), jax.random.PRNGKey(0),
                            jnp.asarray(100, jnp.int32), jnp.asarray(10, jnp.int32),
                            intr=INTR_J, rcfg=CFG_J, opt=opt_j, mcfg=_mcfg(jmp))
    res_t = tmp.mapping_run(tmap, topt, tbuf, slots, torch.Generator().manual_seed(0), 100, 10,
                            intr=INTR, rcfg=CFG, opt=opt_t, mcfg=_mcfg(tmp))
    return res_j, res_t, tmap, topt, tbuf, start, opt_t


def test_mapping_run_matches_reference(mapped):
    res_j, res_t, tmap, topt, tbuf, _, opt_t = mapped
    assert res_t.iteration_count == int(res_j.iteration_count) == 110
    np.testing.assert_allclose(float(res_t.last_loss), float(res_j.last_loss), rtol=1e-4)
    np.testing.assert_array_equal(to_np(res_t.occ_visibility), np.asarray(res_j.occ_visibility))
    _assert_optimised_map_close(tmap, res_j.gmap, 10, opt_t, tbuf)
    # sums of screen-space gradient norms over ten steps of two maps that
    # drift apart at rounding level
    np.testing.assert_allclose(to_np(tmap.grad_accum), np.asarray(res_j.gmap.grad_accum), rtol=1e-2,
                               atol=1e-7)
    np.testing.assert_array_equal(to_np(tmap.grad_denom), np.asarray(res_j.gmap.grad_denom))
    np.testing.assert_array_equal(to_np(tmap.max_radii2d), np.asarray(res_j.gmap.max_radii2d))
    # refined keyframe poses and exposures; frame 0 and the padded slot stay
    for f in ("R", "T", "exposure_ab"):
        np.testing.assert_allclose(to_np(getattr(tbuf, f)), np.asarray(getattr(res_j.kfbuf, f)), atol=2e-5)
    np.testing.assert_array_equal(to_np(tbuf.T[0]), np.zeros(3, np.float32))


def test_covisibility_prune_matches_reference(mapped):
    """Prune of the same map in both packages. Visibility is n_touched > 0 of
    a fresh render, and a Gaussian whose only pixel sits on the 1/255 alpha
    cut may read visible in one and not the other; fed the same visibility,
    the prune decisions are identical."""
    res_j, _, _, _, _, _, _ = mapped
    slots = [3, 2, -1]
    tbuf = _kfbuf_to_torch(res_j.kfbuf)
    for full in (False, True):
        ws = 2 if full else 3
        g_j, occ_j, init_j = jmp.covisibility_prune(
            res_j.gmap, res_j.kfbuf, jnp.asarray(slots, jnp.int32), jnp.asarray(False),
            intr=INTR_J, rcfg=CFG_J, prune_num=1, window_size=ws)
        t = map_to_torch(res_j.gmap)
        occ_t, init_t = tmp.covisibility_prune(t, tbuf, slots, False, intr=INTR, rcfg=CFG,
                                               prune_num=1, window_size=ws)
        assert init_t == bool(init_j) == full
        assert (to_np(occ_t) == np.asarray(occ_j)).mean() > 0.995
        assert (to_np(t.active) == np.asarray(g_j.active)).mean() > 0.995
        assert int(np.asarray(occ_j)[2].sum()) == 0  # the padded slot sees nothing
        t = map_to_torch(res_j.gmap)
        occ_t2, init_t2 = tmp.covisibility_prune_from_occ(
            t, tbuf, slots, torch.tensor(np.asarray(occ_j)), False, prune_num=1, window_size=ws)
        assert init_t2 == full
        if full:
            assert int(g_j.num_active) < int(res_j.gmap.num_active)
        g_j2, occ_j2, _ = jmp.covisibility_prune_from_occ(
            res_j.gmap, res_j.kfbuf, jnp.asarray(slots, jnp.int32), occ_j, jnp.asarray(False),
            prune_num=1, window_size=ws)
        np.testing.assert_array_equal(to_np(occ_t2), np.asarray(occ_j2))
        assert_map_matches(t, g_j2)


def test_init_mapping_and_color_refine_match_reference(world):
    """Initialisation-mode mapping and colour refinement. Densify runs at the
    first iteration; its extent (percent_dense x init extent = 1.8) exceeds
    every seeded scale, so it clones and prunes but never splits, and no
    split noise is drawn. Colour refinement runs on a one-keyframe buffer,
    so the random keyframe draw always picks it."""
    _, _, jbuf, jmap0 = world
    jbuf1 = jbuf.replace(count=jnp.asarray(1, jnp.int32))
    opt_j, opt_t = jgm.MapOptimizer(spatial_scale=2.0), tgm.MapOptimizer(spatial_scale=2.0)
    jopt0 = opt_j.init(jmap0)
    tmap, topt = map_to_torch(jmap0, jopt0)
    tbuf = _kfbuf_to_torch(jbuf1)
    kw = dict(window_size=1, n_random=0, initialization=True, rebin_every=2, bin_margin=8.0,
              init_gaussian_th=0.3)
    jmap_in = jax.tree_util.tree_map(lambda a: a.copy(), jmap0)
    res_j = jmp.mapping_run(jmap_in, jopt0, jbuf1, jnp.asarray([0], jnp.int32), jax.random.PRNGKey(0),
                            jnp.asarray(0, jnp.int32), jnp.asarray(6, jnp.int32),
                            intr=INTR_J, rcfg=CFG_J, opt=opt_j, mcfg=jmp.MappingConfig(**kw))
    res_t = tmp.mapping_run(tmap, topt, tbuf, [0], torch.Generator().manual_seed(0), 0, 6,
                            intr=INTR, rcfg=CFG, opt=opt_t, mcfg=tmp.MappingConfig(**kw))
    np.testing.assert_allclose(float(res_t.last_loss), float(res_j.last_loss), rtol=1e-4)
    assert int(res_j.gmap.num_active) != int(jmap0.num_active)  # densify ran
    _assert_optimised_map_close(tmap, res_j.gmap, 6, opt_t, tbuf)

    tmap_c, topt_c = map_to_torch(res_j.gmap, res_j.opt_state)  # color_refine_run donates
    jmap2, _ = jmp.color_refine_run(res_j.gmap, res_j.opt_state, jbuf1, jax.random.PRNGKey(1),
                                    jnp.asarray(3, jnp.int32), intr=INTR_J, rcfg=CFG_J, opt=opt_j,
                                    mcfg=jmp.MappingConfig())
    tmp.color_refine_run(tmap_c, topt_c, tbuf, torch.Generator().manual_seed(1), 3, intr=INTR, rcfg=CFG,
                         opt=opt_t, mcfg=tmp.MappingConfig())
    _assert_optimised_map_close(tmap_c, jmap2, 3, opt_t, tbuf)


# ---------------------------------------------------------------------------
# mapping probes (port only)


def test_mapping_probes(world):
    """n_iters=0 passes the state through bitwise; an empty window fits
    nothing but the isotropic regulariser; one run of 2k iterations equals
    two chained runs of k (initialisation mode, whose keyframe has no pose
    or exposure refinement to restart)."""
    _, _, jbuf, jmap0 = world
    opt = tgm.MapOptimizer(spatial_scale=2.0)
    base_map = map_to_torch(jmap0)
    buf = _kfbuf_to_torch(jbuf)

    g, s = base_map.clone(), opt.init(base_map)
    res = tmp.mapping_run(g, s, buf, [3, 2, -1], torch.Generator().manual_seed(0), 7, 0,
                          intr=INTR, rcfg=CFG, opt=opt, mcfg=_mcfg(tmp))
    assert res.iteration_count == 7 and s.count == 0
    assert_map_matches(g, jmap0, atol=0)

    g, s = base_map.clone(), opt.init(base_map)
    res = tmp.mapping_run(g, s, buf, [-1, -1, -1], torch.Generator().manual_seed(0), 0, 3,
                          intr=INTR, rcfg=CFG, opt=opt, mcfg=_mcfg(tmp))
    iso = float(10.0 * tmp.isotropic_reg(torch.exp(g.log_scales), g.active))
    assert np.isfinite(float(res.last_loss)) and not bool(res.occ_visibility.any())
    assert abs(float(res.last_loss) - iso) < 0.05 * iso + 1e-6
    np.testing.assert_array_equal(to_np(g.means), np.asarray(jmap0.means))

    kw = dict(window_size=1, n_random=0, initialization=True, rebin_every=2, bin_margin=8.0)
    runs = []
    for split in ((8,), (4, 4)):
        g, s = base_map.clone(), opt.init(base_map)
        gen, it, local = torch.Generator().manual_seed(3), 0, 0
        for n in split:
            res = tmp.mapping_run(g, s, buf, [0], gen, it, n, local, intr=INTR, rcfg=CFG, opt=opt,
                                  mcfg=tmp.MappingConfig(**kw))
            it, local = res.iteration_count, local + n
        runs.append((g, res))
    (g1, r1), (g2, r2) = runs
    assert r1.iteration_count == r2.iteration_count == 8
    for f in ("means", "features_dc", "log_scales", "quats", "logit_opacities", "active"):
        assert torch.equal(getattr(g1, f), getattr(g2, f)), f
    assert torch.equal(r1.occ_visibility, r2.occ_visibility)


# ---------------------------------------------------------------------------
# the SLAM loop


def _small_slam_config(n_frames):
    cfg = _small_base_config(n_frames)
    cfg["Training"].update({"init_itr_num": 60, "mapping_itr_num": 10, "tracking_itr_num": 10,
                            "kf_interval": 2, "mono_scale_servo": False})
    cfg["Results"].update({"save_results": False, "eval_rendering": True, "color_refinement": True,
                           "color_refinement_iters": 5})
    cfg["Performance"].update({"max_per_tile": 64, "tile_chunk": 16, "map_capacity": 8192,
                               "kf_capacity": 16})
    return cfg


def test_slam_loop_runs_on_cpu():
    slam = SLAM(_small_slam_config(7), save_dir=None, device="cpu")
    res = slam.run(progress=False)
    assert res["n_frames"] == 7
    assert res["n_keyframes"] >= 2
    assert np.isfinite(res["mean_psnr"])
    for f in slam.frames.values():
        assert np.isfinite(f["R"]).all() and np.isfinite(f["T"]).all()
    for k, v in slam.gmap.params().items():
        assert bool(torch.isfinite(v[slam.gmap.active]).all()), k
    assert slam.gmap.num_active > 0


def test_slam_defaults_to_cuda_and_refuses_unported_paths():
    cfg = _small_slam_config(3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SLAM(copy.deepcopy(cfg))
    asks = [("Performance", "bin_active_bucket", True, "C4"),
            ("Results", "global_BA", True, "A7"),
            ("dynamic_filtering", "enabled", True, "A11"),
            ("mast3r", "checkpoint", "weights.pth", "A12"),
            ("Results", "save_depth_comparison", True, "A14"),
            ("Results", "viz_every", 1, "A14")]
    for section, key, value, item in asks:
        c = copy.deepcopy(cfg)
        c.setdefault(section, {})[key] = value
        with pytest.raises(NotImplementedError, match=item):
            SLAM(c, device="cpu")
    # an explicit viz_every of 0 asks for no panels
    c = copy.deepcopy(cfg)
    c["Results"]["viz_every"] = 0
    SLAM(c, device="cpu")
    # the bf16 packed blend is carried: it reaches the two optimiser-facing
    # render configs (packed here), not the exact renders' config
    c = copy.deepcopy(cfg)
    c["Performance"].update({"blend_bf16": True, "packed_tracking_budget": 48,
                             "packed_mapping_budget": 64})
    slam = SLAM(c, device="cpu")
    assert slam.rcfg_track.blend_bf16 and slam.rcfg_map.blend_bf16
    assert slam.rcfg_track.use_packed and slam.rcfg_map.use_packed
    assert not slam.rcfg.blend_bf16 and not slam.rcfg.use_packed


def test_nan_scan_logs_a_planted_nan_with_its_phase(monkeypatch):
    """LVDGS_NAN_SCAN=1 (the reference's _nan_scan): after each phase, the
    map parameters' non-finite rows, active and inactive apart, and the
    phase output's non-finite values are logged with the phase's name."""
    logs = []
    monkeypatch.setattr(tsys, "Log", lambda *a, **kw: logs.append((" ".join(map(str, a)), kw.get("tag"))))
    monkeypatch.setenv("LVDGS_NAN_SCAN", "1")
    slam = SLAM(_small_slam_config(3), save_dir=None, device="cpu")
    slam.process_frame(0)
    assert not [m for m, _ in logs if "NANSCAN" in m]  # a healthy map logs nothing
    # a NaN in an inactive row (not rendered): tracking runs on, and the scan
    # after it names the row's parameter and the phase
    inactive = int(torch.nonzero(~slam.gmap.active)[0])
    slam.gmap.log_scales[inactive, 1] = float("nan")
    slam.process_frame(1)
    scans = [(m, tag) for m, tag in logs if "NANSCAN" in m]
    assert scans[0] == ("NANSCAN[track[1]]: log_scales(act=0,inact=1)", "Debug")
    slam._nan_scan("probe", torch.tensor([float("inf"), 1.0, float("nan")]))
    assert logs[-1][0] == "NANSCAN[probe]: log_scales(act=0,inact=1) phase_out(2)"
    monkeypatch.delenv("LVDGS_NAN_SCAN")
    quiet = SLAM(_small_slam_config(3), save_dir=None, device="cpu")
    quiet.gmap.log_scales[0, 0] = float("nan")
    n = len(logs)
    quiet._nan_scan("probe")
    assert len(logs) == n  # off unless asked for


def test_profile_dir_writes_a_trace(tmp_path):
    """Results.profile_dir: a torch.profiler trace of the loop from frame
    profile_after; the 3-frame run ends before profile_frames more frames,
    so the trace is stopped and written when the loop ends."""
    cfg = _small_slam_config(3)
    cfg["Results"].update({"profile_dir": str(tmp_path), "profile_after": 1, "profile_frames": 10,
                           "color_refinement": False, "eval_rendering": False})
    slam = SLAM(cfg, save_dir=None, device="cpu")
    slam.run(progress=False)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    trace = traces[0].read_text()
    assert '"traceEvents"' in trace and "aten::" in trace


def test_pace_kf_hz_sleeps_after_keyframes(monkeypatch):
    """Training.pace_kf_hz: after a frame that made a keyframe, sleep what is
    left of 1 / pace_kf_hz; never after other frames."""
    sleeps = []
    monkeypatch.setattr(tsys.time, "sleep", sleeps.append)
    cfg = _small_slam_config(3)
    cfg["Training"]["pace_kf_hz"] = 0.001  # one keyframe per 1000 s
    cfg["Results"].update({"color_refinement": False, "eval_rendering": False})
    slam = SLAM(cfg, save_dir=None, device="cpu")
    slam.run(progress=False)
    assert len(sleeps) == len(slam.kf_indices) >= 1
    assert all(900.0 < s < 1000.0 for s in sleeps)
