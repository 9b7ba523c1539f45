"""The bf16 packed configuration of lvdgs_torch (Performance.blend_bf16)
against lvdgs_tpu on the CPU, past the kernels: the pose-linearised render,
one packed tracking call, and the port's SLAM loop with the packed budgets
forced on and blend_bf16 set.

The reference's programs are compiled with one rounding per bf16 operation
(tests/test_torch_bf16.py says why) and held to the tolerances of the
float32 copies in tests/test_torch_packed.py and
tests/test_torch_packed_slam.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from lvdgs_tpu.core import lie as jlie
from lvdgs_tpu.core.camera import Camera as JCamera
from lvdgs_tpu.ops import rasterizer as jr
from lvdgs_tpu.slam import tracking as jtk
from lvdgs_torch.core import lie as tlie
from lvdgs_torch.eval.ate import eval_ate
from lvdgs_torch.slam import tracking as ttk
from lvdgs_torch.slam.system import SLAM
from test_torch_bf16 import check_lin_render, count_plain_calls, strict
from test_torch_packed import lin_scene  # noqa: F401  (a fixture)
from test_torch_packed_slam import CFG_J_PK, CFG_PK
from test_torch_slam import CFG_J, INTR, INTR_J, _small_slam_config, world  # noqa: F401
from torch_parity import camera_pair, to_np


def test_rasterize_pose_lin_bf16_matches_reference(lin_scene, monkeypatch):
    check_lin_render(lin_scene, monkeypatch, pose=True)


def test_packed_bf16_tracking_matches_reference(world, monkeypatch):
    """One period-linearised packed track_camera with blend_bf16 in both
    packages, from the same perturbed pose (the float32 copy's test): the
    steps render through the bf16 kernels, the saturation probe in
    float32."""
    params, active, _, _ = world
    cfg_j = dataclasses.replace(CFG_J_PK, blend_bf16=True)
    cfg_t = dataclasses.replace(CFG_PK, blend_bf16=True)
    gt = jr.rasterize(params, active, jnp.eye(3), jnp.zeros(3), INTR_J, CFG_J)
    tau = jnp.array([0.02, -0.015, 0.03, 0.008, -0.006, 0.01])
    Rp, tp = jlie.apply_delta(jnp.eye(3), jnp.zeros(3), tau)
    cam = JCamera.create(5, gt.image, INTR_J).update_RT(Rp, tp)
    res_j = strict(lambda p, a, c: jtk.track_camera(p, a, c, INTR_J, cfg_j, jtk.TrackingConfig(max_iters=60)),
                   params, active, cam)
    pt = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    calls = {}
    count_plain_calls(monkeypatch, calls)
    res_t = ttk.track_camera(pt, torch.tensor(np.asarray(active)), camera_pair(cam)[1], INTR, cfg_t,
                             ttk.TrackingConfig(max_iters=60))
    rot_err = float(np.linalg.norm(to_np(tlie.so3_log(res_t.R))))
    assert rot_err < 0.02, rot_err
    assert float(np.linalg.norm(to_np(res_t.T))) < 0.35 * float(np.linalg.norm(np.asarray(tp)))
    assert res_t.iterations == int(res_j.iterations)
    np.testing.assert_allclose(to_np(res_t.T), np.asarray(res_j.T), atol=1e-3)
    rel = to_np(res_t.R) @ np.asarray(res_j.R).T
    assert float(np.linalg.norm(to_np(tlie.so3_log(torch.tensor(rel))))) < 1e-3
    np.testing.assert_allclose(float(res_t.exposure_a), float(res_j.exposure_a), atol=1e-3)
    np.testing.assert_allclose(float(res_t.exposure_b), float(res_j.exposure_b), atol=1e-3)
    np.testing.assert_allclose(float(res_t.median_depth), float(res_j.median_depth), rtol=1e-3)
    steps = res_t.iterations
    assert calls[("packed_blend_forward_plain", True, False)] == steps
    assert calls[("packed_blend_backward_plain", True, False)] == steps
    assert calls[("packed_blend_forward_plain", False, True)] >= 1  # the probe
    assert set(calls) == {("packed_blend_forward_plain", True, False),
                          ("packed_blend_backward_plain", True, False),
                          ("packed_blend_forward_plain", False, True)}


def test_bf16_slam_loop_runs_on_cpu(monkeypatch):
    """SLAM with blend_bf16 and both packed budgets forced on: tracking and
    mapping render through the bf16 packed blend, the probe and the exact
    renders in float32, and the run ends within the float32 copy's
    thresholds."""
    cfg = _small_slam_config(7)
    cfg["Performance"].update({"packed_tracking_budget": 48, "packed_mapping_budget": 64,
                               "blend_bf16": True})
    slam = SLAM(cfg, save_dir=None, device="cpu")
    assert slam.rcfg_track.blend_bf16 and slam.rcfg_map.blend_bf16 and not slam.rcfg.blend_bf16
    calls = {}
    count_plain_calls(monkeypatch, calls)
    res = slam.run(progress=False)
    assert res["n_keyframes"] >= 2
    for f in slam.frames.values():
        assert np.isfinite(f["R"]).all() and np.isfinite(f["T"]).all()
    for k, v in slam.gmap.params().items():
        assert bool(torch.isfinite(v[slam.gmap.active]).all()), k
    ate = eval_ate(slam.frames, slam.kf_indices, None, 7, final=True, monocular=True)
    assert ate < 0.08, ate
    assert res["mean_psnr"] > 17.0, res["mean_psnr"]
    assert calls.get(("packed_blend_forward_plain", True, False), 0) > 0
    assert calls.get(("packed_blend_backward_plain", True, False), 0) > 0
    assert calls.get(("packed_blend_forward_plain", False, True), 0) > 0  # the probe, in float32
    assert set(calls) <= {("packed_blend_forward_plain", True, False),
                          ("packed_blend_backward_plain", True, False),
                          ("packed_blend_forward_plain", False, True)}
