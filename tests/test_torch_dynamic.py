"""The dynamic-scene path of the port against lvdgs_tpu on the CPU: the
synthetic street's moving objects and GT static masks, the masked mapping
loss inside mapping_run, keyframe fusion with a mask, the static-region
metrics, the loss-mask coverage report, and a small masked SLAM run.

Tolerances are ROADMAP's: images 3e-4, normalised gradients 2e-3, the
metrics 1e-4 on equal renders. GT masks are compared for equality away
from the 0.5 thresholds of the marker render: a pixel whose dynamic
coverage or opacity lies within 1e-5 of 0.5 in either package may flip
between renderers that differ at rounding level.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_tpu.core import losses as jl
from lvdgs_tpu.core.camera import Camera as JCamera
from lvdgs_tpu.core.camera import Intrinsics as JIntrinsics
from lvdgs_tpu.core.config import load_config as jload_config
from lvdgs_tpu.data import datasets as jds
from lvdgs_tpu.eval import rendering as jev
from lvdgs_tpu.gaussian import model as jgm
from lvdgs_tpu.ops import rasterizer as jr
from lvdgs_tpu.slam import mapping as jmp
from lvdgs_tpu.slam import state as jst
from lvdgs_tpu.slam import system as jsys
from lvdgs_torch import convert
from lvdgs_torch.core import losses as tl
from lvdgs_torch.core.camera import Intrinsics
from lvdgs_torch.core.config import load_config
from lvdgs_torch.data import datasets as tds
from lvdgs_torch.eval import rendering as tev
from lvdgs_torch.eval.ate import eval_ate
from lvdgs_torch.gaussian import model as tgm
from lvdgs_torch.ops import rasterizer as tr
from lvdgs_torch.perception.oracle import OracleLadderMasker, OracleMasker
from lvdgs_torch.slam import mapping as tmp
from lvdgs_torch.slam import system as tsys
from lvdgs_torch.slam.system import SLAM
from torch_parity import camera_pair, leaves_np, map_to_torch, normalized_close, to_np

ROOT = os.path.join(os.path.dirname(__file__), "..")
BASE_CFG = os.path.join(ROOT, "configs", "mono", "synthetic", "base_config.yaml")
EDGE = 1e-5
INTR_J = JIntrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
INTR = Intrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
CFG_J = jr.RenderConfig(tile_size=16, max_per_tile=64, gaussian_chunk=16, tile_chunk=16, tile_group=4)
CFG = tr.RenderConfig(tile_size=16, max_per_tile=64, tile_chunk=16)


def _dyn_config(load=load_config, n_frames=18):
    """The reference's dynamic street test config (tests/test_e2e_dynamic.py):
    160x48, two staged movers (a leading car and an oncoming truck)."""
    config = load(BASE_CFG)
    config["Dataset"].update({
        "scene": "street", "n_frames": n_frames, "step": 0.5, "accel_frames": 4,
        "street_half_width": 8.0, "street_spacing": 0.5, "photo_gain_jitter": 0.0,
        "photo_bias_jitter": 0.0, "photo_noise": 0.0, "mono_scale_error": 1.0, "mono_noise": 0.0,
        "pcd_downsample": 16, "pcd_downsample_init": 8, "dynamic_objects": 2,
        "dynamic_archetypes": [[+1.3, 6.0, +1.0, +0.28, 0.15, 0.25, 0.70],
                               [-1.9, 12.0, -1.0, -0.55, 0.75, 0.15, 0.12, 7.0, 2.3, 2.6]],
    })
    config["Dataset"]["Calibration"].update({"width": 160, "height": 48, "fx": 95.0, "fy": 95.0,
                                             "cx": 80.0, "cy": 24.0})
    config["Training"].update({"pose_seed": "constant_velocity", "mask_dilation": 3, "init_itr_num": 300,
                               "mapping_itr_num": 30, "mapping_itr_nosingle": 10, "tracking_itr_num": 40,
                               "kf_interval": 3, "window_size": 6, "single_thread": False})
    config["Results"].update({"save_results": False, "eval_rendering": False, "color_refinement": False})
    config["Performance"] = {"tile_size": 16, "max_per_tile": 128, "gaussian_chunk": 16, "tile_chunk": 32,
                             "map_capacity": 16384, "kf_capacity": 32}
    return config


# ---------------------------------------------------------------------------
# the dataset


@pytest.fixture(scope="module")
def datasets():
    return jds.load_dataset(None, "", _dyn_config(jload_config)), tds.load_dataset(None, "", _dyn_config(), "cpu")


def _jax_coverage(jd, idx):
    """The reference's marker render of frame idx (its __getitem__'s)."""
    pose = jd.poses[idx]
    params = dict(jd._params)
    moved = jd._dyn_base_means + float(idx) * jd._dyn_vel
    params["means"] = jnp.concatenate([jd._params["means"][: jd._n_static], moved])
    mout = jd._rasterize({**params, "features_dc": jd._marker_dc}, jd._active, jnp.asarray(pose[:3, :3]),
                         jnp.asarray(pose[:3, 3]), jd.intrinsics, jd._rcfg)
    op = np.asarray(mout.opacity[0])
    return np.asarray(mout.image[0]) / np.maximum(op, 1e-6), op


@pytest.mark.parametrize("idx", [0, 11, 17])
def test_dynamic_frames_and_masks_match_reference(datasets, idx):
    jd, td = datasets
    if idx == 0:
        # the same world: static scene, the movers, their velocities and markers
        assert td._n_static == jd._n_static and len(td._dynamic) == len(jd._dynamic) == 2
        for k, v in jd._params.items():
            np.testing.assert_array_equal(to_np(td._params[k]), np.asarray(v), err_msg=k)
        for a, b in ((td._dyn_base_means, jd._dyn_base_means), (td._dyn_vel, jd._dyn_vel),
                     (td._marker_dc, jd._marker_dc)):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
    ji, jdep, jpose, _ = jd[idx]
    ti, tdep, tpose, _ = td[idx]
    np.testing.assert_array_equal(tpose, jpose)
    np.testing.assert_allclose(to_np(ti), np.asarray(ji), atol=3e-4)
    mj, mt = np.asarray(jd.get_gt_static_mask(idx)), to_np(td.get_gt_static_mask(idx))
    cov_t, op_t = (to_np(x) for x in td.static_mask_coverage(idx))
    cov_j, op_j = _jax_coverage(jd, idx)
    np.testing.assert_array_equal((cov_j < 0.5) | (op_j < 0.5), mj)
    np.testing.assert_array_equal((cov_t < 0.5) | (op_t < 0.5), mt)
    near = np.zeros_like(mt)
    for x in (cov_t, op_t, cov_j, op_j):
        near |= np.abs(x - 0.5) <= EDGE
    np.testing.assert_array_equal(mt[~near], mj[~near])
    assert (~mt).mean() > 0.005  # the movers are in view (the truck fills most of frame 11)


def test_oracle_ladder_mask_quality(datasets):
    """Port copy of tests/test_e2e_dynamic.py::test_oracle_ladder_mask_quality:
    the ladder on GT boxes and masks recovers the GT dynamic region."""
    _, td = datasets
    masker = OracleLadderMasker(td)
    img, _, _, _ = td[8]
    static = masker.get_static_mask(to_np(img), frame_idx=8)
    gt_static = to_np(td.get_gt_static_mask(8))
    pred_dyn, gt_dyn = ~np.asarray(static), ~gt_static
    inter, union = float((pred_dyn & gt_dyn).sum()), float((pred_dyn | gt_dyn).sum())
    assert gt_dyn.sum() > 0
    assert inter / max(union, 1.0) > 0.5, inter / max(union, 1.0)


# ---------------------------------------------------------------------------
# the masked mapping loss


def _scene(n=400, seed=0):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(size=(n, 2)) * 1.2, rng.uniform(3.0, 7.0, size=(n, 1))], 1)
    p = {"means": means, "features_dc": rng.normal(size=(n, 3)),
         "log_scales": rng.uniform(-2.2, -1.4, size=(n, 3)), "quats": rng.normal(size=(n, 4)),
         "logit_opacities": rng.uniform(1.0, 3.0, size=(n,))}
    return {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}, jnp.ones((n,), bool)


def _static_mask(i):
    m = np.ones((48, 64), bool)
    m[8 + 4 * i:26 + 4 * i, 10 + 6 * i:30 + 6 * i] = False
    return m


@pytest.fixture(scope="module")
def masked_world():
    """Four rendered keyframes along x; keyframes 1 and 3 carry a static
    mask (an object rectangle), 2 does not; the map seeded from 0."""
    params, active = _scene()
    buf = jst.create_keyframe_buffer(8, 48, 64)
    for i, dx in enumerate([0.0, 0.05, 0.1, 0.15]):
        R, t = jnp.eye(3), jnp.array([dx, 0.0, 0.0], jnp.float32)
        out = jr.rasterize(params, active, R, t, INTR_J, CFG_J)
        depth = jnp.where(out.opacity[0] > 0.5, out.depth[0] / jnp.maximum(out.opacity[0], 1e-6), 0.0)
        cam = JCamera.create(i, out.image, INTR_J, mono_depth=depth).update_RT(R, t)
        if i:
            cam = cam.replace(exposure_a=jnp.float32(0.01 * i), exposure_b=jnp.float32(-0.005 * i))
        if i in (1, 3):
            cam = cam.replace(static_mask=jnp.asarray(_static_mask(i)), has_static_mask=jnp.asarray(True))
        buf, _ = jst.add_keyframe(buf, cam)
    cam0 = jst.camera_from_slot(buf, jnp.asarray(0))
    gmap = jgm.seed_from_depth(jgm.create_map(2048), cam0, buf.mono_depth[0], INTR_J, kf_id=0, downsample=4)
    return params, active, buf, gmap


def _jax_masked_loss(p, active, R, T, cam, mcfg):
    """The reference's masked branch (lvdgs_tpu/slam/mapping.py:196-207)."""
    out = jr.rasterize(p, active, R, T, INTR_J, CFG_J)
    bg = jnp.zeros((3,), jnp.float32)
    static = cam.static_mask[None]
    mi = jnp.where(static, out.image, bg[:, None, None])
    mg = jnp.where(static, cam.image, bg[:, None, None])
    loss = (1.0 - mcfg.lambda_dssim) * jl.l1_loss(mi, mg) + mcfg.lambda_dssim * (1.0 - jl.ssim(mi, mg))
    d = out.depth[0]
    dm = cam.static_mask & (cam.mono_depth > 0) & (d > 0)
    dl = jl.masked_mean(jnp.abs(d - cam.mono_depth), dm)
    return loss + mcfg.depth_lambda * jnp.where(dm.any(), dl, 0.0)


def test_masked_loss_and_gradients_match_reference(masked_world):
    """The masked branch's loss and its gradients with respect to the map
    on keyframe 1 (masked), from a pose off the keyframe's."""
    _, _, jbuf, jmap = masked_world
    jcam = jst.camera_from_slot(jbuf, jnp.asarray(1))
    _, tcam = camera_pair(jcam)
    R, T = jnp.eye(3), jnp.array([0.06, 0.01, 0.0], jnp.float32)
    jp = jmap.params()
    mcfg_j = jmp.MappingConfig(use_masked_loss=True)
    lj, gj = jax.value_and_grad(_jax_masked_loss)(jp, jmap.active, R, T, jcam, mcfg_j)
    tmap = map_to_torch(jmap)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in tmap.params().items()}
    out = tr.rasterize(p, tmap.active, torch.eye(3), torch.tensor([0.06, 0.01, 0.0]), INTR, CFG)
    lt = tl.loss_mapping_masked(out.image, out.depth, tcam, torch.zeros(3), lambda_dssim=0.2,
                                depth_lambda=0.1)
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-3)
    for k in ("means", "features_dc", "log_scales", "logit_opacities"):
        normalized_close(gj[k], p[k].grad, 2e-3)


@pytest.fixture(scope="module")
def masked_mapped(masked_world):
    """Three masked-loss iterations in both packages: window keyframes 3
    (masked) and 2 (no mask), keyframe 1 (masked) as the only replay."""
    _, _, jbuf, jmap0 = masked_world
    kw = dict(window_size=3, n_random=2, gaussian_update_every=100000, gaussian_reset=100000,
              rebin_every=5, use_masked_loss=True)
    opt_j, opt_t = jgm.MapOptimizer(spatial_scale=2.0), tgm.MapOptimizer(spatial_scale=2.0)
    jopt0 = opt_j.init(jmap0)
    tmap, topt = map_to_torch(jmap0, jopt0)
    tbuf = convert.keyframe_buffer_from_numpy(leaves_np(jbuf), "cpu")
    # keyframe 0 is in the window too, so keyframe 1 is the only replay
    slots = [3, 2, 0]
    jmap_in = jax.tree_util.tree_map(lambda a: a.copy(), jmap0)
    res_j = jmp.mapping_run(jmap_in, jopt0, jbuf, jnp.asarray(slots, jnp.int32), jax.random.PRNGKey(0),
                            jnp.asarray(100, jnp.int32), jnp.asarray(3, jnp.int32),
                            intr=INTR_J, rcfg=CFG_J, opt=opt_j, mcfg=jmp.MappingConfig(**kw))
    res_t = tmp.mapping_run(tmap, topt, tbuf, slots, torch.Generator().manual_seed(0), 100, 3,
                            intr=INTR, rcfg=CFG, opt=opt_t, mcfg=tmp.MappingConfig(**kw))
    return res_j, res_t, tmap, tbuf


def test_masked_mapping_run_matches_reference(masked_mapped):
    """The loss of the last iteration, the map, and the window exposures:
    the masked window camera's exposure gets no gradient, so it stays where
    it was in both packages, while the unmasked one moves."""
    res_j, res_t, tmap, tbuf = masked_mapped
    assert res_t.iteration_count == int(res_j.iteration_count) == 103
    np.testing.assert_allclose(float(res_t.last_loss), float(res_j.last_loss), rtol=2e-3)
    for f in ("means", "features_dc", "logit_opacities"):
        d = np.abs(to_np(getattr(tmap, f)) - np.asarray(getattr(res_j.gmap, f)))
        assert np.quantile(d, 0.99) < 1e-4 and d.max() < 1e-2, f
    ab_t, ab_j = to_np(tbuf.exposure_ab), np.asarray(res_j.kfbuf.exposure_ab)
    np.testing.assert_allclose(ab_t, ab_j, atol=2e-5)
    np.testing.assert_array_equal(ab_t[3], np.asarray([0.03, -0.015], np.float32))  # masked: no step
    assert np.abs(ab_t[2] - np.asarray([0.02, -0.01], np.float32)).max() > 1e-3  # unmasked: steps
    for f in ("R", "T"):
        np.testing.assert_allclose(to_np(getattr(tbuf, f)), np.asarray(getattr(res_j.kfbuf, f)), atol=2e-5)


# ---------------------------------------------------------------------------
# keyframe fusion, the metrics, the coverage report


@pytest.mark.parametrize("kernel", [3, 4, 5, 9])
def test_dilate_mask_matches_reference(kernel):
    m = np.random.default_rng(kernel).uniform(size=(30, 41)) > 0.97
    a = np.asarray(jsys._dilate_mask(jnp.asarray(m), kernel))
    b = to_np(tsys._dilate_mask(torch.as_tensor(m), kernel))
    np.testing.assert_array_equal(b, a)


def _small_masked_pair():
    """A reference and a port SLAM on a small config, each with a masker
    (so mapping takes the masked loss), and a frame-1 camera pair with a
    static mask."""
    def cfg(load):
        c = load(BASE_CFG)
        c["Dataset"]["n_frames"] = 3
        c["Dataset"]["Calibration"].update({"fx": 60.0, "fy": 60.0, "width": 64, "height": 48,
                                            "cx": 32.0, "cy": 24.0})
        c["Training"].update({"mask_dilation": 5, "mono_scale_anchor": False})
        return c

    js = jsys.SLAM(cfg(jload_config), save_dir=None, masker=object())
    ts = SLAM(cfg(load_config), save_dir=None, device="cpu", masker=object())
    return js, ts


@pytest.mark.parametrize("idx", [0, 1], ids=["init", "aligned"])
def test_fused_keyframe_depth_with_mask_matches_reference(idx):
    """Seeding depth with the dilated dynamic region cut out (kernel + 2 on
    frame 0), at init from mono depth and after from the patch alignment."""
    js, ts = _small_masked_pair()
    assert js.mcfg.use_masked_loss and ts.mcfg.use_masked_loss
    rng = np.random.default_rng(idx)
    H, W = 48, 64
    image = rng.uniform(0.05, 1.0, size=(3, H, W)).astype(np.float32)
    mono = rng.uniform(3.0, 6.0, size=(H, W)).astype(np.float32)
    render = (mono * 0.8 * (1 + 0.01 * rng.normal(size=(H, W)))).astype(np.float32)
    static = _static_mask(1)
    jcam = JCamera.create(idx, jnp.asarray(image), INTR_J, mono_depth=jnp.asarray(mono)).replace(
        static_mask=jnp.asarray(static), has_static_mask=jnp.asarray(True))
    _, tcam = camera_pair(jcam)
    init = idx == 0
    dj, cj = js._fused_keyframe_depth(idx, jcam, None if init else jnp.asarray(render), None, init=init)
    dt, ct = ts._fused_keyframe_depth(idx, tcam, None if init else torch.as_tensor(render), init=init)
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(ct.mono_depth), np.asarray(cj.mono_depth), rtol=1e-5)
    cut = to_np(tsys._dilate_mask(~torch.as_tensor(static), 7 if init else 5))
    assert (to_np(dt)[cut] == 0).all() and (to_np(dt)[~cut] > 0).mean() > 0.5


class _EvalData:
    """Frames rendered from a GT scene, with or without GT static masks,
    as each package's dataset hands them out."""

    def __init__(self, images, masks, tensor):
        self.images, self.masks, self.tensor = images, masks, tensor

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = torch.as_tensor(self.images[idx]) if self.tensor else jnp.asarray(self.images[idx])
        return img, None, np.eye(4, dtype=np.float32), None

    def get_gt_static_mask(self, idx):
        if self.masks is None:
            return None
        return torch.as_tensor(self.masks[idx]) if self.tensor else jnp.asarray(self.masks[idx])


@pytest.mark.parametrize("source", ["dataset GT mask", "frame mask"])
def test_static_region_metrics_match_reference(masked_world, source):
    """mean_psnr_static / mean_ssim_static over the static region, from the
    dataset's GT mask where it has one, else the frame record's, at 1e-4."""
    params, active, _, jmap = masked_world
    xs = [0.0, 0.03, 0.07, 0.12]
    images = [np.asarray(jr.rasterize(params, active, jnp.eye(3), jnp.array([x, 0.0, 0.0], jnp.float32),
                                      INTR_J, CFG_J).image) for x in xs]
    masks = [_static_mask(i) for i in range(len(xs))]
    frames = {i: {"R": np.eye(3, dtype=np.float32), "T": np.array([x, 0.0, 0.0], np.float32),
                  "static_mask": masks[i] if source == "frame mask" else None} for i, x in enumerate(xs)}
    gt = masks if source == "dataset GT mask" else None
    rj = jev.eval_rendering(jmap, frames, _EvalData(images, gt, False), INTR_J, CFG_J, kf_indices=[0])
    rt = tev.eval_rendering(map_to_torch(jmap), frames, _EvalData(images, gt, True), INTR, CFG,
                            kf_indices=[0])
    for k in ("mean_psnr", "mean_ssim", "mean_psnr_static", "mean_ssim_static"):
        np.testing.assert_allclose(rt[k], rj[k], atol=1e-4, err_msg=k)
    assert rt["n_eval_frames"] == rj["n_eval_frames"] == 3
    assert rt["mean_psnr_static"] != rt["mean_psnr"]


@pytest.mark.parametrize("masked", [False, True])
def test_debug_loss_mask_coverage_matches_reference(masked):
    rng = np.random.default_rng(4)
    image = rng.uniform(0.0, 0.02, size=(3, 48, 64)).astype(np.float32)
    image[:, 10:40] = rng.uniform(0.1, 1.0, size=(3, 30, 64))
    jcam = JCamera.create(0, jnp.asarray(image), INTR_J)
    jcam = jcam.replace(grad_mask=jl.compute_grad_mask(jcam.image, 1.1, "synthetic"))
    if masked:
        jcam = jcam.replace(static_mask=jnp.asarray(_static_mask(2)), has_static_mask=jnp.asarray(True))
    _, tcam = camera_pair(jcam)
    a, b = jl.debug_loss_mask_coverage(jcam, verbose=True), tl.debug_loss_mask_coverage(tcam, verbose=True)
    assert list(b) == list(a)
    for k in a:
        assert b[k] == a[k], k
    assert ("static" in b) == masked


# ---------------------------------------------------------------------------
# the SLAM loop with a masker


def test_masked_slam_run_on_cpu():
    """The port's SLAM on the dynamic street with the oracle masker given
    to its constructor: the masked mapping loss is on, every frame record
    carries its mask, no Gaussian is seeded on a moving object's pixels at
    init, and the run ends within the thresholds; a masker assigned after
    construction leaves the mapping loss plain, as in the reference."""
    n = 7
    config = _dyn_config(n_frames=n)
    config["Training"].update({"init_itr_num": 60, "mapping_itr_num": 10, "tracking_itr_num": 20,
                               "mono_scale_servo": False})
    config["Results"].update({"eval_rendering": True})
    late = SLAM(copy.deepcopy(config), save_dir=None, device="cpu")
    late.masker = OracleMasker(late.dataset)
    assert not late.mcfg.use_masked_loss
    slam = SLAM(copy.deepcopy(config), save_dir=None, device="cpu",
                masker=OracleMasker(tds.load_dataset(None, "", config, "cpu")))
    assert slam.mcfg.use_masked_loss and not slam.mcfg_init.use_masked_loss
    res = slam.run(progress=False)
    for i, f in slam.frames.items():
        np.testing.assert_array_equal(f["static_mask"], to_np(slam.dataset.get_gt_static_mask(i)))
    assert bool(slam.kfbuf.has_static[: slam.kfbuf.count].all())
    assert res["n_keyframes"] >= 2
    for k, v in slam.gmap.params().items():
        assert bool(torch.isfinite(v[slam.gmap.active]).all()), k
    # the reference's CPU calibration of this scene (tests/test_e2e_dynamic.py,
    # 18 frames): unmasked ATE 1.65 m and static PSNR 14.60 dB; masked 1.18 m
    # and 15.54 dB. The masked port run over its first frames stays inside
    # the unmasked figures.
    ate = eval_ate(slam.frames, slam.kf_indices, None, n, final=True, monocular=True)
    assert np.isfinite(ate) and ate < 1.65, ate
    assert res["mean_psnr_static"] > 14.60 and np.isfinite(res["mean_ssim_static"]), res
