"""Global bundle adjustment of lvdgs_torch (mapping.global_ba_run,
SLAM.global_ba, Results.global_BA) against lvdgs_tpu on the CPU.

Both packages start from tests/test_torch_slam.py's world (a map seeded
from keyframe 0 of a 400-Gaussian scene, 64x48, dense renders). With one
keyframe in the buffer the random keyframe draw always picks it, so both
packages run the same iterations; its frame_idx is set to 5, so its pose
moves (frame 0 is pinned).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_tpu.gaussian import model as jgm
from lvdgs_tpu.slam import mapping as jmp
from lvdgs_torch.core.config import load_config
from lvdgs_torch.gaussian import model as tgm
from lvdgs_torch.slam import mapping as tmp
from lvdgs_torch.slam.system import SLAM
from test_torch_slam import (  # noqa: F401  (world is a fixture)
    CFG, CFG_J, INTR, INTR_J, _assert_optimised_map_close, _kfbuf_to_torch, _small_slam_config, world,
)
from torch_parity import map_to_torch, to_np

ROOT = os.path.join(os.path.dirname(__file__), "..")
N_ITERS = 4


def _one_keyframe(jbuf, frame_idx):
    return jbuf.replace(count=jnp.asarray(1, jnp.int32), frame_idx=jbuf.frame_idx.at[0].set(frame_idx))


def test_global_ba_run_matches_reference(world):
    """N_ITERS iterations of global BA in both packages: the map within the
    mapping tests' tolerances, the keyframe's pose to 2e-5 (it moves by
    steps of lr x gradient), and moved."""
    _, _, jbuf, jmap0 = world
    jbuf1 = _one_keyframe(jbuf, 5)
    # a nudged keyframe pose, so that the photometric gradient is not at
    # rounding level
    jbuf1 = jbuf1.replace(T=jbuf1.T.at[0].set(jnp.array([0.03, -0.02, 0.01], jnp.float32)))
    opt_j, opt_t = jgm.MapOptimizer(spatial_scale=2.0), tgm.MapOptimizer(spatial_scale=2.0)
    jopt0 = opt_j.init(jmap0)
    tmap, topt = map_to_torch(jmap0, jopt0)
    tbuf = _kfbuf_to_torch(jbuf1)
    mcfg_kw = dict(lr_rot=0.003, lr_trans=0.001)
    jmap_in = jax.tree_util.tree_map(lambda a: a.copy(), jmap0)  # global_ba_run donates
    jmap, _, jbuf_out = jmp.global_ba_run(jmap_in, jopt0, jbuf1, jax.random.PRNGKey(0),
                                          jnp.asarray(N_ITERS, jnp.int32), 0, intr=INTR_J, rcfg=CFG_J,
                                          opt=opt_j, mcfg=jmp.MappingConfig(**mcfg_kw))
    tmp.global_ba_run(tmap, topt, tbuf, torch.Generator().manual_seed(0), N_ITERS, 0, intr=INTR, rcfg=CFG,
                      opt=opt_t, mcfg=tmp.MappingConfig(**mcfg_kw))
    _assert_optimised_map_close(tmap, jmap, N_ITERS, opt_t, tbuf)
    assert topt.count == N_ITERS
    np.testing.assert_allclose(to_np(tbuf.R), np.asarray(jbuf_out.R), atol=2e-5)
    np.testing.assert_allclose(to_np(tbuf.T), np.asarray(jbuf_out.T), atol=2e-5)
    moved = np.abs(to_np(tbuf.T[0]) - np.asarray(jbuf1.T[0])).max()
    assert moved > 1e-5, moved
    # the slots past the buffer's count are untouched
    np.testing.assert_array_equal(to_np(tbuf.T[1:]), np.asarray(jbuf1.T[1:]))


def test_global_ba_pins_frame_zero(world):
    """The keyframe of frame 0 keeps its pose bit for bit while the map
    moves, in the port as in the reference."""
    _, _, jbuf, jmap0 = world
    jbuf1 = _one_keyframe(jbuf, 0)
    opt_t = tgm.MapOptimizer(spatial_scale=2.0)
    tmap = map_to_torch(jmap0)
    topt = opt_t.init(tmap)
    tbuf = _kfbuf_to_torch(jbuf1)
    R0, T0 = tbuf.R.clone(), tbuf.T.clone()
    means0 = tmap.means.clone()
    tmp.global_ba_run(tmap, topt, tbuf, torch.Generator().manual_seed(0), 2, 0, intr=INTR, rcfg=CFG,
                      opt=opt_t, mcfg=tmp.MappingConfig())
    assert torch.equal(tbuf.R, R0) and torch.equal(tbuf.T, T0)
    assert not torch.equal(tmap.means, means0)


def test_slam_runs_global_ba_before_color_refinement():
    """The port's small CPU run (7 frames at 64x48) with Results.global_BA:
    SLAM.run adjusts once, before colour refinement, and writes the
    keyframes' adjusted poses into the frame records; the run stays
    finite."""
    cfg = _small_slam_config(7)
    cfg["Results"]["global_BA"] = True
    cfg["Training"]["global_BA_itr_num"] = 10
    slam = SLAM(cfg, save_dir=None, device="cpu")
    assert slam.do_global_ba and slam.global_ba_iters == 10
    order = []
    for name in ("global_ba", "color_refinement"):
        step = getattr(slam, name)
        setattr(slam, name, lambda *a, step=step, name=name: (order.append(name), step(*a)))
    res = slam.run(progress=False)
    assert order == ["global_ba", "color_refinement"]
    assert np.isfinite(res["mean_psnr"])
    for kf, slot in slam.kf_slots.items():
        np.testing.assert_array_equal(slam.frames[kf]["T"], to_np(slam.kfbuf.T[slot]))
        np.testing.assert_array_equal(slam.frames[kf]["R"], to_np(slam.kfbuf.R[slot]))
    for k, v in slam.gmap.params().items():
        assert bool(torch.isfinite(v[slam.gmap.active]).all()), k
    assert not SLAM(_small_slam_config(3), save_dir=None, device="cpu").do_global_ba  # off by default


@pytest.mark.slow
def test_global_ba_runs(tmp_path):
    """Port copy of tests/test_e2e_synthetic.py::test_global_ba_runs (slow
    there too: the reference marks its whole e2e file): an 8-frame run of
    the base config with Results.global_BA."""
    config = load_config(os.path.join(ROOT, "configs", "mono", "synthetic", "base_config.yaml"))
    config["Dataset"]["n_frames"] = 8
    config["Training"]["init_itr_num"] = 150
    config["Training"]["mapping_itr_num"] = 15
    config["Training"]["tracking_itr_num"] = 15
    config["Training"]["global_BA_itr_num"] = 30
    config["Results"]["global_BA"] = True
    config["Results"]["color_refinement"] = False
    config["Results"]["eval_rendering"] = False
    slam = SLAM(config, save_dir=str(tmp_path), device="cpu")
    res = slam.run(progress=False)
    assert np.isfinite(res["ate_rmse"])
