"""Pyramid tracking (track_camera_pyramid, TrackingConfig.pyramid) of
lvdgs_torch against lvdgs_tpu on the CPU, and the port's SLAM loop with
Training.track_pyramid.

The same NumPy inputs go through both packages: the half-resolution
helpers at an even and an odd frame size, and whole pyramid calls, dense
and packed (the reference's packed Pallas kernels in interpret mode), from
the perturbed pose of tests/test_torch_packed_slam.py on
tests/test_torch_slam.py's 400-Gaussian scene at 64x48, held to that
file's tracking tolerances.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_tpu.core import lie as jlie
from lvdgs_tpu.core.camera import Camera as JCamera
from lvdgs_tpu.core.camera import Intrinsics as JIntrinsics
from lvdgs_tpu.ops import rasterizer as jr
from lvdgs_tpu.slam import tracking as jtk
from lvdgs_torch.core import lie as tlie
from lvdgs_torch.core.camera import Camera, Intrinsics
from lvdgs_torch.ops import rasterizer as tr
from lvdgs_torch.slam import system as tsys
from lvdgs_torch.slam import tracking as ttk
from lvdgs_torch.slam.system import SLAM
from test_torch_slam import CFG, CFG_J, INTR, INTR_J, _scene, _small_slam_config
from torch_parity import camera_pair, to_np

SIZES = [(64, 48), (65, 49)]
TAU = [0.02, -0.015, 0.03, 0.008, -0.006, 0.01]
PYRAMID = dict(max_iters=60, pyramid=True, coarse_iters=40)


# ---------------------------------------------------------------------------
# the half-resolution helpers


@pytest.mark.parametrize("W,H", SIZES)
def test_downsample_image_matches_reference(W, H):
    img = np.random.default_rng(W + H).uniform(size=(3, H, W)).astype(np.float32)
    ref = np.asarray(jtk._downsample2_image(jnp.asarray(img)))
    out = to_np(ttk._downsample2_image(torch.tensor(img)))
    assert out.shape == ref.shape == (3, H // 2, W // 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize("W,H", SIZES)
def test_downsample_masks_match_reference(W, H):
    """The grad mask's any-pool and the static mask's all-pool
    (~any-pool(~mask)), equal."""
    mask = np.random.default_rng(W * H).uniform(size=(H, W)) < 0.3
    any_j = np.asarray(jtk._downsample2_mask(jnp.asarray(mask)))
    all_j = np.asarray(~jtk._downsample2_mask(~jnp.asarray(mask)))
    any_t = to_np(ttk._downsample2_mask(torch.tensor(mask)))
    all_t = to_np(~ttk._downsample2_mask(~torch.tensor(mask)))
    assert any_t.shape == (H // 2, W // 2)
    np.testing.assert_array_equal(any_t, any_j)
    np.testing.assert_array_equal(all_t, all_j)
    assert any_t.sum() > all_t.sum() > 0  # the two pools differ on this mask


@pytest.mark.parametrize("W,H", SIZES)
def test_half_res_intrinsics_matches_reference(W, H):
    kw = dict(fx=80.0, fy=70.0, cx=W / 2 + 0.3, cy=H / 2 - 0.2, width=W, height=H, znear=0.05, zfar=50.0)
    ref = jtk.half_res_intrinsics(JIntrinsics(**kw))
    out = ttk.half_res_intrinsics(Intrinsics(**kw))
    for f in dataclasses.fields(Intrinsics):
        assert getattr(out, f.name) == getattr(ref, f.name), f.name
    # the principal point moves by half a pixel: not Intrinsics.scaled
    assert out != Intrinsics(**kw).scaled(W // 2, H // 2)


# ---------------------------------------------------------------------------
# whole pyramid calls


def test_tracking_pyramid_recovers_pose():
    """Port copy of tests/test_slam_steps.py::test_tracking_pyramid_recovers_pose:
    the half-resolution stage and a short full-resolution polish recover a
    perturbed pose."""
    params, active = _scene()
    p = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    act = torch.tensor(np.asarray(active))
    cfg = tr.RenderConfig(tile_size=16, max_per_tile=128, tile_chunk=16)
    R0, t0 = torch.eye(3), torch.zeros(3)
    gt = tr.rasterize(p, act, R0, t0, INTR, cfg)
    Rp, tp = tlie.apply_delta(R0, t0, torch.tensor(TAU))
    cam = Camera.create(5, gt.image, INTR).update_RT(Rp, tp)
    res = ttk.track_camera_pyramid(p, act, cam, INTR, cfg, ttk.TrackingConfig(**PYRAMID))

    def err(R, T):
        return float(torch.linalg.norm(T - t0)) + float(torch.linalg.norm(tlie.so3_log(R @ R0.T)))

    err0, err1 = err(Rp, tp), err(res.R, res.T)
    assert err1 < 0.35 * err0, f"pose error {err0} -> {err1}"
    assert res.iterations > 3
    assert float(res.median_depth) > 0
    # the fine stage's full-resolution bookkeeping
    assert res.image.shape == (3, INTR.height, INTR.width)
    assert int((res.n_touched > 0).sum()) > 0


def _perturbed():
    """The scene, and a camera at the perturbed pose of
    tests/test_torch_packed_slam.py seeing its ground truth (reference)."""
    params, active = _scene()
    gt = jr.rasterize(params, active, jnp.eye(3), jnp.zeros(3), INTR_J, CFG_J)
    Rp, tp = jlie.apply_delta(jnp.eye(3), jnp.zeros(3), jnp.array(TAU))
    return params, active, JCamera.create(5, gt.image, INTR_J).update_RT(Rp, tp)


def _track_both(cfg_j, cfg_t):
    params, active, cam = _perturbed()
    res_j = jtk.track_camera_pyramid(params, active, cam, INTR_J, cfg_j, jtk.TrackingConfig(**PYRAMID))
    pt = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    res_t = ttk.track_camera_pyramid(pt, torch.tensor(np.asarray(active)), camera_pair(cam)[1], INTR,
                                     cfg_t, ttk.TrackingConfig(**PYRAMID))
    return res_t, res_j


def _assert_track_close(res_t, res_j):
    """tests/test_torch_packed_slam.py's tracking tolerances: equal
    iterations (both stages), T within 1e-3, R within 1e-3 rad, exposure
    within 1e-3, median depth within rtol 1e-3; the dense bookkeeping render
    touches the same Gaussians."""
    assert isinstance(res_t.iterations, int)
    assert res_t.iterations == int(res_j.iterations)
    np.testing.assert_allclose(to_np(res_t.T), np.asarray(res_j.T), atol=1e-3)
    rel = to_np(res_t.R) @ np.asarray(res_j.R).T
    assert float(np.linalg.norm(to_np(tlie.so3_log(torch.tensor(rel))))) < 1e-3
    np.testing.assert_allclose(float(res_t.exposure_a), float(res_j.exposure_a), atol=1e-3)
    np.testing.assert_allclose(float(res_t.exposure_b), float(res_j.exposure_b), atol=1e-3)
    np.testing.assert_allclose(float(res_t.median_depth), float(res_j.median_depth), rtol=1e-3)
    nt_t, nt_j = to_np(res_t.n_touched) > 0, np.asarray(res_j.n_touched) > 0
    assert (nt_t == nt_j).mean() > 0.99


def test_dense_pyramid_matches_reference():
    res_t, res_j = _track_both(CFG_J, CFG)
    _assert_track_close(res_t, res_j)
    assert float(np.linalg.norm(to_np(tlie.so3_log(res_t.R)))) < 0.02  # the pose is recovered


# packed at 32 slots per tile with saturation feedback, 4 tiles per group:
# the coarse stage packs at min(max_per_tile 64, 2 x 32) = 64
PACKED = dict(use_packed=True, saturation_feedback=True, slot_budget_per_tile=32)


def test_packed_pyramid_matches_reference():
    """One packed pyramid call in both packages: the fine stage at NB 3 (3
    groups x 32 slots), the coarse stage at NB 2 (1 group x 64 slots), the
    chunk counts of the reference's two interpret-mode compiles."""
    cfg_t = dataclasses.replace(CFG, tile_group=4, **PACKED)
    cfg_j = dataclasses.replace(CFG_J, **PACKED)
    # The fine budget binds: before any cap, a group's deepest tile at the
    # start pose needs more chunks than the 3 of NB. The coarse one cannot:
    # it equals max_per_tile, the dense lists' own depth.
    params, active, cam = _perturbed()
    p = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    act = torch.tensor(np.asarray(active))
    tcam = camera_pair(cam)[1]
    proj = tr.project_gaussians(p["means"], p["quats"], p["log_scales"], act, tcam.R, tcam.T, INTR)
    ntx, nty = cfg_t.grid(INTR)
    _, slot_valid = tr._bin_for(proj, cfg_t, ntx, nty)
    counts = torch.nn.functional.pad(slot_valid.sum(dim=1), (0, -ntx * nty % 4)).reshape(-1, 4)
    need = int((-(-counts.amax(dim=1) // 32)).clamp(min=1).sum())  # chunks of 32 slots
    assert need > counts.shape[0] * 32 // 32, need  # NB: groups x budget / 32
    res_t, res_j = _track_both(cfg_j, cfg_t)
    _assert_track_close(res_t, res_j)


# ---------------------------------------------------------------------------
# the SLAM loop


def test_slam_loop_tracks_with_the_pyramid_on_cpu(monkeypatch):
    """Training.track_pyramid and the three iteration keys reach the
    TrackingConfig, and every tracked frame goes through the pyramid."""
    cfg = _small_slam_config(5)
    cfg["Training"].update({"track_pyramid": True, "track_coarse_iters": 8, "track_coarse_min_iters": 4,
                            "track_fine_min_iters": 6})
    slam = SLAM(cfg, save_dir=None, device="cpu")
    t = slam.tcfg
    assert (t.pyramid, t.coarse_iters, t.coarse_min_iters, t.fine_min_iters) == (True, 8, 4, 6)
    calls = []

    def counting(*args, **kwargs):
        res = ttk.track_camera_pyramid(*args, **kwargs)
        calls.append(res.iterations)
        return res

    monkeypatch.setattr(tsys, "track_camera_pyramid", counting)
    res = slam.run(progress=False)
    assert res["n_frames"] == 5 and len(calls) == 4  # frame 0 initialises the map
    assert all(n > 0 for n in calls)
    assert np.isfinite(res["mean_psnr"])
    for f in slam.frames.values():
        assert np.isfinite(f["R"]).all() and np.isfinite(f["T"]).all()
    for k, v in slam.gmap.params().items():
        assert bool(torch.isfinite(v[slam.gmap.active]).all()), k
    # without the key, no pyramid
    assert not SLAM(_small_slam_config(3), save_dir=None, device="cpu").tcfg.pyramid
