"""The active-prefix binning bucket of lvdgs_torch (RenderConfig.bin_bucket,
SLAM._update_bin_bucket) against lvdgs_tpu on the CPU.

The bucket slices the depth-sorted candidates before the tile top-k
selections. While it covers the valid Gaussians the bins are bit for bit
those of full-capacity binning; where it binds, only the farthest valid
Gaussians drop out. The SLAM host re-buckets before each seeding and after
each prune: a run with the bucket engaged must end bit for bit where the
same run without it ends, and the host's bucket sequence must be the
reference's for the same active counts.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_tpu.core.camera import Intrinsics as JIntrinsics
from lvdgs_tpu.gaussian import model as jgm
from lvdgs_tpu.ops import rasterizer as jr
from lvdgs_tpu.slam import system as jsys
from lvdgs_torch.ops import rasterizer as tr
from lvdgs_torch.slam.system import SLAM
from test_torch_slam import _small_slam_config
from torch_parity import to_np

INTR_J = JIntrinsics(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240)
KW = dict(ntx=20, nty=15, tile_size=16, max_per_tile=256, tile_chunk=64, coarse_factor=4,
          max_per_coarse=1024)


def _projected(n, seed, every_third_inactive=False):
    """tests/test_binning.py's scene, projected by the reference: the same
    (mean2d, radius, depth, valid) arrays go to both packages."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(size=(n, 2)) * 2.0, rng.uniform(2.0, 10.0, size=(n, 1))], axis=1)
    params = {
        "means": jnp.asarray(means, jnp.float32),
        "features_dc": jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        "log_scales": jnp.asarray(rng.uniform(-3.0, -1.8, size=(n, 3)), jnp.float32),
        "quats": jnp.asarray(rng.normal(size=(n, 4)), jnp.float32),
        "logit_opacities": jnp.asarray(rng.uniform(0.0, 2.0, size=(n,)), jnp.float32),
    }
    act = np.ones(n, bool)
    if every_third_inactive:
        act[::3] = False  # a fragmented free list
    proj = jr.project_gaussians(params["means"], params["quats"], params["log_scales"], jnp.asarray(act),
                                jnp.eye(3), jnp.zeros(3), INTR_J)
    return {k: np.asarray(proj[k]) for k in ("mean2d", "radius", "depth", "valid")}


def _bins_t(p, margin, **kw):
    idx, valid = tr.bin_gaussians(torch.tensor(p["mean2d"]), torch.tensor(p["radius"]), torch.tensor(p["depth"]),
                                  torch.tensor(p["valid"]), margin, **KW, **kw)
    return to_np(idx), to_np(valid)


def _bins_j(p, margin, **kw):
    idx, v = jr.bin_gaussians(jnp.asarray(p["mean2d"]), jnp.asarray(p["radius"]), jnp.asarray(p["depth"]),
                              jnp.asarray(p["valid"]), margin, **KW, **kw)
    return np.asarray(idx), np.asarray(v)


def test_bin_bucket_exact_when_not_binding():
    """Port copy of tests/test_binning.py::test_bin_bucket_exact_when_not_binding,
    with a margin so that margin-only candidates rank too: the bucketed bins
    equal full binning bit for bit, and the reference's bucketed bins."""
    p = _projected(6000, seed=2, every_third_inactive=True)
    n_valid = int(p["valid"].sum())
    bucket = -(-n_valid // 512) * 512  # the smallest 512-multiple covering the valid
    assert bucket < 6000
    full_idx, full_valid = _bins_t(p, 2.0)
    b_idx, b_valid = _bins_t(p, 2.0, bin_bucket=bucket)
    np.testing.assert_array_equal(full_valid, b_valid)
    np.testing.assert_array_equal(full_idx, b_idx)
    j_idx, j_valid = _bins_j(p, 2.0, bin_bucket=bucket)
    np.testing.assert_array_equal(b_valid, j_valid)
    np.testing.assert_array_equal(b_idx, j_idx)


def test_bin_bucket_binding_drops_farthest_only():
    """Port copy of tests/test_binning.py::test_bin_bucket_binding_drops_farthest_only:
    where the bucket binds, the bins equal binning the nearest `bucket`
    valid Gaussians, and the reference's bucketed bins."""
    p = _projected(4000, seed=3)
    bucket = 2048
    b_idx, b_valid = _bins_t(p, 0.0, bin_bucket=bucket)
    order = np.argsort(np.where(p["valid"], p["depth"], np.inf), kind="stable")
    keep = np.zeros(4000, bool)
    keep[order[:bucket]] = True
    nearest = dict(p, valid=p["valid"] & keep)
    assert int(p["valid"].sum()) > bucket  # the bucket binds
    ref_idx, ref_valid = _bins_t(nearest, 0.0)
    np.testing.assert_array_equal(ref_valid, b_valid)
    np.testing.assert_array_equal(ref_idx, b_idx)
    j_idx, j_valid = _bins_j(p, 0.0, bin_bucket=bucket)
    np.testing.assert_array_equal(b_valid, j_valid)
    np.testing.assert_array_equal(b_idx, j_idx)


STEP = 512  # a bucket step that this small run's few thousand Gaussians engage


def _bucketed_run(bucket: bool):
    """The port's small CPU SLAM run (7 frames at 64x48) with the bucket on
    or off at STEP, each call of _update_bin_bucket logged with its inputs
    and the bucket it left."""
    cfg = _small_slam_config(7)
    cfg["Performance"]["bin_active_bucket"] = bucket
    slam = SLAM(cfg, save_dir=None, device="cpu")
    slam._bin_bucket_step = STEP
    calls = []
    update = slam._update_bin_bucket

    def logged(lower_bound=0):
        before = slam.rcfg_map.bin_bucket
        update(lower_bound)
        calls.append(dict(lower_bound=lower_bound, n_active=slam._num_active_cached(),
                          capacity=slam.gmap.capacity, before=before, after=slam.rcfg_map.bin_bucket,
                          track=slam.rcfg_track.bin_bucket, exact=slam.rcfg.bin_bucket))
    slam._update_bin_bucket = logged
    res = slam.run(progress=False)
    return slam, res, calls


@pytest.fixture(scope="module")
def bucketed_runs():
    return _bucketed_run(True), _bucketed_run(False)


def test_slam_bucket_engages_and_changes_nothing(bucketed_runs):
    """With the bucket engaged, the run ends bit for bit where the bucket-off
    run ends: map, Adam state, keyframe poses, frame poses and metrics."""
    (on, res_on, calls), (off, res_off, calls_off) = bucketed_runs
    seq = [c["after"] for c in calls]
    assert any(seq) and len(set(seq)) > 2, seq  # engaged, and re-bucketed as the map grew
    assert all(c["track"] == c["after"] and c["exact"] == 0 for c in calls)
    assert not any(c["after"] for c in calls_off)
    for f in ("means", "features_dc", "log_scales", "quats", "logit_opacities", "active"):
        assert torch.equal(getattr(on.gmap, f), getattr(off.gmap, f)), f
    for k in on.opt_state.m:
        assert torch.equal(on.opt_state.m[k], off.opt_state.m[k]), k
        assert torch.equal(on.opt_state.v[k], off.opt_state.v[k]), k
    assert torch.equal(on.kfbuf.R, off.kfbuf.R) and torch.equal(on.kfbuf.T, off.kfbuf.T)
    assert on.kf_indices == off.kf_indices
    for i in on.frames:
        np.testing.assert_array_equal(on.frames[i]["R"], off.frames[i]["R"])
        np.testing.assert_array_equal(on.frames[i]["T"], off.frames[i]["T"])
    assert res_on["mean_psnr"] == res_off["mean_psnr"]


def test_slam_bucket_sequence_matches_reference(bucketed_runs):
    """The reference's _update_bin_bucket, fed each call's active count,
    lower bound and capacity as the port's run met them, leaves the bucket
    the port's left, call by call; the freeze holds it."""
    (_, _, calls), _ = bucketed_runs
    cfg = _small_slam_config(7)
    cfg["Performance"]["bin_active_bucket"] = True
    js = jsys.SLAM(copy.deepcopy(cfg), save_dir=None)
    js._bin_bucket_step = STEP
    for c in calls:
        if js.gmap.capacity != c["capacity"]:
            js.gmap = jgm.create_map(c["capacity"])
        assert js.rcfg_map.bin_bucket == c["before"]
        js._cached_num_active = c["n_active"]
        js._update_bin_bucket(lower_bound=c["lower_bound"])
        assert js.rcfg_map.bin_bucket == js.rcfg_track.bin_bucket == c["after"], c
    # at capacity 8192: growth at once, shrinking only with two steps of
    # slack, the freeze, and 0 where the bucket would save nothing
    slam = SLAM(cfg, save_dir=None, device="cpu")
    assert slam.gmap.capacity == 8192
    slam._bin_bucket_step = STEP
    for n_active, lower_bound, freeze, bucket in (
            (3000, 0, False, 4096),  # 1.25 x 3000 -> 4096
            (2500, 0, False, 4096),  # 3584 is one step below: kept
            (1000, 0, False, 1536),  # two steps below: shrunk
            (5000, 0, True, 1536),  # frozen
            (5000, 0, False, 6656),
            (5000, 6400, False, 0)):  # 8192 would save nothing: full capacity
        slam._cached_num_active = n_active
        slam._bin_bucket_freeze = freeze
        slam._update_bin_bucket(lower_bound=lower_bound)
        assert slam.rcfg_map.bin_bucket == slam.rcfg_track.bin_bucket == bucket, (n_active, lower_bound)


def test_bucket_defaults_off_on_the_cpu():
    """As in the reference, the bucket is on by default off the CPU (the
    card's default is held by chip_smoke.py) and off on it; the exact
    renders never bucket."""
    cfg = _small_slam_config(3)
    slam = SLAM(copy.deepcopy(cfg), save_dir=None, device="cpu")
    js = jsys.SLAM(copy.deepcopy(cfg), save_dir=None)
    assert slam._bin_bucket_enable is False and js._bin_bucket_enable is False
    assert slam._bin_bucket_step == js._bin_bucket_step == 16384
    slam._update_bin_bucket(lower_bound=10**6)
    assert slam.rcfg_map.bin_bucket == slam.rcfg_track.bin_bucket == slam.rcfg.bin_bucket == 0
