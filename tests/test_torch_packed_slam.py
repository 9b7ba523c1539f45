"""Packed tracking and feedback mapping of lvdgs_torch against lvdgs_tpu on
the CPU, and the port's SLAM loop with the packed budgets forced on.

The reference runs its packed Pallas kernels in interpret mode. Both
packages start from the same state (tests/test_torch_slam.py's world: a
400-Gaussian scene, four rendered keyframes, a map seeded from keyframe 0)
on a 64x48 frame with 4 tiles per group, and are held to the tolerances of
that file's dense copies.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lvdgs_tpu.core import lie as jlie
from lvdgs_tpu.core.camera import Camera as JCamera
from lvdgs_tpu.gaussian import model as jgm
from lvdgs_tpu.slam import mapping as jmp
from lvdgs_tpu.slam import tracking as jtk
from lvdgs_torch.core import lie as tlie
from lvdgs_torch.eval.ate import eval_ate
from lvdgs_torch.gaussian import model as tgm
from lvdgs_torch.ops import rasterizer_cuda as rc
from lvdgs_torch.slam import mapping as tmp
from lvdgs_torch.slam import tracking as ttk
from lvdgs_torch.slam.system import SLAM
from test_torch_slam import (  # noqa: F401  (world is a fixture)
    CFG, CFG_J, INTR, INTR_J, _assert_optimised_map_close, _kfbuf_to_torch, _small_slam_config,
    world,
)
from torch_parity import camera_pair, map_to_torch, to_np

# packed at 64 slots per tile with saturation feedback, 4 tiles per group.
# The budget does not bind on this scene: the ground truth is rendered at
# full depth, which a binding budget could not fit
PACKED = dict(use_packed=True, saturation_feedback=True, slot_budget_per_tile=64)
CFG_J_PK = dataclasses.replace(CFG_J, **PACKED)
CFG_PK = dataclasses.replace(CFG, tile_group=4, **PACKED)


def test_packed_tracking_matches_reference(world):
    """One period-linearised packed track_camera (saturation caps probed at
    the first rebin) in both packages, from the same perturbed pose."""
    params, active, _, _ = world
    from lvdgs_tpu.ops import rasterizer as jr

    gt = jr.rasterize(params, active, jnp.eye(3), jnp.zeros(3), INTR_J, CFG_J)
    tau = jnp.array([0.02, -0.015, 0.03, 0.008, -0.006, 0.01])
    Rp, tp = jlie.apply_delta(jnp.eye(3), jnp.zeros(3), tau)
    cam = JCamera.create(5, gt.image, INTR_J).update_RT(Rp, tp)
    res_j = jtk.track_camera(params, active, cam, INTR_J, CFG_J_PK, jtk.TrackingConfig(max_iters=60))
    pt = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    tcfg = ttk.TrackingConfig(max_iters=60)
    assert tcfg.lin_period
    res_t = ttk.track_camera(pt, torch.tensor(np.asarray(active)), camera_pair(cam)[1], INTR, CFG_PK,
                             tcfg)
    # the pose is recovered
    rot_err = float(np.linalg.norm(to_np(tlie.so3_log(res_t.R))))
    assert rot_err < 0.02, rot_err
    assert float(np.linalg.norm(to_np(res_t.T))) < 0.35 * float(np.linalg.norm(np.asarray(tp)))
    # and agrees with the reference's, as the dense copy does
    assert res_t.iterations == int(res_j.iterations)
    np.testing.assert_allclose(to_np(res_t.T), np.asarray(res_j.T), atol=1e-3)
    rel = to_np(res_t.R) @ np.asarray(res_j.R).T
    assert float(np.linalg.norm(to_np(tlie.so3_log(torch.tensor(rel))))) < 1e-3
    np.testing.assert_allclose(float(res_t.exposure_a), float(res_j.exposure_a), atol=1e-3)
    np.testing.assert_allclose(float(res_t.exposure_b), float(res_j.exposure_b), atol=1e-3)
    np.testing.assert_allclose(float(res_t.median_depth), float(res_j.median_depth), rtol=1e-3)
    # the final bookkeeping render is dense in both
    nt_t, nt_j = to_np(res_t.n_touched) > 0, np.asarray(res_j.n_touched) > 0
    assert (nt_t == nt_j).mean() > 0.99


def test_feedback_mapping_matches_reference(world):
    """Initialisation-mode mapping under saturation feedback: window bins
    and visibility from the full-depth probe each period, densify at the
    first iteration (clones and prunes, no split noise) carrying the probe
    visibility to the clones."""
    _, _, jbuf, jmap0 = world
    jbuf1 = jbuf.replace(count=jnp.asarray(1, jnp.int32))
    opt_j, opt_t = jgm.MapOptimizer(spatial_scale=2.0), tgm.MapOptimizer(spatial_scale=2.0)
    jopt0 = opt_j.init(jmap0)
    tmap, topt = map_to_torch(jmap0, jopt0)
    tbuf = _kfbuf_to_torch(jbuf1)
    kw = dict(window_size=1, n_random=0, initialization=True, rebin_every=2, bin_margin=8.0,
              init_gaussian_th=0.3)
    jmap_in = jax.tree_util.tree_map(lambda a: a.copy(), jmap0)  # mapping_run donates
    res_j = jmp.mapping_run(jmap_in, jopt0, jbuf1, jnp.asarray([0], jnp.int32), jax.random.PRNGKey(0),
                            jnp.asarray(0, jnp.int32), jnp.asarray(6, jnp.int32),
                            intr=INTR_J, rcfg=CFG_J_PK, opt=opt_j, mcfg=jmp.MappingConfig(**kw))
    res_t = tmp.mapping_run(tmap, topt, tbuf, [0], torch.Generator().manual_seed(0), 0, 6,
                            intr=INTR, rcfg=CFG_PK, opt=opt_t, mcfg=tmp.MappingConfig(**kw))
    np.testing.assert_allclose(float(res_t.last_loss), float(res_j.last_loss), rtol=1e-4)
    assert int(res_j.gmap.num_active) != int(jmap0.num_active)  # densify ran
    _assert_optimised_map_close(tmap, res_j.gmap, 6, opt_t, tbuf)
    # the probe's visibility, carried through densify to the clones
    occ_t, occ_j = to_np(res_t.occ_visibility), np.asarray(res_j.occ_visibility)
    grown = np.asarray(res_j.gmap.active) & ~np.asarray(jmap0.active)
    assert occ_j[0, grown].any()
    assert (occ_t == occ_j).mean() > 0.995


def test_packed_slam_loop_runs_on_cpu(monkeypatch):
    """The SLAM loop with both packed budgets forced on: every optimisation
    render goes through the packed blend (the dense backward never runs),
    the exact renders stay dense, and the run ends within the thresholds."""
    calls = {}

    def counting(name):
        fn = getattr(rc, name)

        def wrapped(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(rc, name, wrapped)

    for name in ("packed_blend_forward_plain", "packed_blend_backward_plain", "blend_forward_plain",
                 "blend_backward_plain", "median_depth_plain"):
        counting(name)
    cfg = _small_slam_config(7)
    assert not SLAM(cfg, save_dir=None, device="cpu").rcfg_track.use_packed  # dense on the CPU
    cfg["Performance"].update({"packed_tracking_budget": 48, "packed_mapping_budget": 64})
    slam = SLAM(cfg, save_dir=None, device="cpu")
    assert slam.rcfg_track.slot_budget_per_tile == 48 and slam.rcfg_map.slot_budget_per_tile == 64
    assert slam.rcfg_track.saturation_feedback and slam.rcfg_map.saturation_feedback
    assert not slam.rcfg.use_packed
    res = slam.run(progress=False)
    assert res["n_keyframes"] >= 2
    for f in slam.frames.values():
        assert np.isfinite(f["R"]).all() and np.isfinite(f["T"]).all()
    for k, v in slam.gmap.params().items():
        assert bool(torch.isfinite(v[slam.gmap.active]).all()), k
    ate = eval_ate(slam.frames, slam.kf_indices, None, 7, final=True, monocular=True)
    assert ate < 0.08, ate
    assert res["mean_psnr"] > 17.0, res["mean_psnr"]
    assert calls.get("packed_blend_forward_plain", 0) > 0
    assert calls.get("packed_blend_backward_plain", 0) > 0
    assert calls.get("blend_forward_plain", 0) > 0 and calls.get("median_depth_plain", 0) > 0
    assert calls.get("blend_backward_plain", 0) == 0
