"""lvdgs_torch's tile-sharded tracker (track_camera_sharded) against the
reference's on 4 virtual devices, and against the port's own single-device
tracker, on the CPU.

The port's 4 ranks are gloo processes (launch.spawn; the workers are in
tests/torch_parallel_workers.py). The scene is the reference's
(tests/test_parallel.py:137-185): 64x48, 16x16 tiles in groups of 4,
packed at a budget of 64 slots per tile, which does not bind; each of the
4 ranks takes one tile row of the padded 4x4 grid (the last only padding),
so ranks 1-3 blend at a non-zero tile offset through the packed kernels'
plain versions. Only the reference's sharded tracker is compiled (its
packed kernels in interpret mode); the port's single-device tracker is
held against the reference's in test_torch_packed.py.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_workers as workers
from lvdgs_tpu.core.camera import Camera as JCamera
from lvdgs_tpu.core.camera import Intrinsics as JIntrinsics
from lvdgs_tpu.ops.rasterizer import RenderConfig as JRenderConfig
from lvdgs_tpu.slam import tracking as jtk
from lvdgs_torch import convert
from lvdgs_torch.core import lie
from lvdgs_torch.core.camera import Camera, Intrinsics
from lvdgs_torch.ops import rasterizer as tr
from lvdgs_torch.parallel.launch import spawn
from lvdgs_torch.slam import tracking as ttk
from torch_parity import PARAM_FIELDS, leaves_np, to_np

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
TIMEOUT = 120.0


def test_tile_sharded_tracking_matches_reference_and_single_device():
    """R 2e-4, T 5e-4, loss rtol 5e-3, image 1e-3 (tests/test_parallel.py:
    179-185), for the reference's sharded tracker and the port's
    single-device one (lin_period off: the sharded trackers render each
    step exactly); every rank's result bit for bit rank 0's."""
    intr = Intrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
    rcfg = tr.RenderConfig(tile_size=16, max_per_tile=64, tile_chunk=16, tile_group=4, use_packed=True,
                           slot_budget_per_tile=64)
    rng = np.random.default_rng(7)
    n = 120
    means = np.concatenate([rng.normal(size=(n, 2)) * 1.2, rng.uniform(2.0, 6.0, size=(n, 1))], 1)
    scene = {
        "means": means.astype(np.float32),
        "features_dc": (rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
        "log_scales": rng.uniform(-2.5, -1.0, size=(n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.uniform(0.0, 2.5, size=(n,)).astype(np.float32),
        "active": np.ones((n,), bool),
    }
    params = {f: torch.tensor(scene[f]) for f in PARAM_FIELDS}
    active = torch.tensor(scene["active"])
    gt = tr.rasterize(params, active, torch.eye(3), torch.zeros(3), intr, rcfg).image.detach()
    tau = torch.tensor([0.02, -0.015, 0.01, 0.004, -0.003, 0.002])
    Rp, Tp = lie.apply_delta(torch.eye(3), torch.zeros(3), tau)
    cam = Camera.create(0, gt, intr).update_RT(Rp, Tp)
    tcfg = ttk.TrackingConfig(max_iters=30, rebin_every=5, lin_period=False)

    intr_j = JIntrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
    rcfg_j = JRenderConfig(tile_size=16, max_per_tile=64, gaussian_chunk=8, tile_chunk=16, tile_group=4,
                           use_packed=True, slot_budget_per_tile=64)
    cam_np = convert.camera_to_numpy(cam)
    jcam = JCamera.create(0, cam_np["image"], intr_j).update_RT(cam_np["R"], cam_np["T"])
    ref = jtk.track_camera_sharded({f: scene[f] for f in PARAM_FIELDS}, scene["active"], jcam, intr_j, rcfg_j,
                                   jtk.TrackingConfig(max_iters=30, rebin_every=5, lin_period=False),
                                   mesh=Mesh(np.array(jax.devices()[:4]), ("data",)))

    outs = spawn(workers.track_sharded, 4, backend="gloo", device="cpu",
                 args=(scene, cam_np, intr, rcfg, tcfg), timeout=TIMEOUT, join_timeout=TIMEOUT)
    for r, o in enumerate(outs[1:], 1):
        for k, v in o.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(outs[0][k]), err_msg=f"rank {r} {k}")
    out = outs[0]
    single = ttk.track_camera(params, active, cam, intr, rcfg, tcfg)
    assert out["iterations"] > 0
    for name, other in (("reference", {k: np.asarray(v) for k, v in ref._asdict().items()}),
                        ("single-device port", {k: to_np(v) if isinstance(v, torch.Tensor) else v
                                                for k, v in single._asdict().items()})):
        np.testing.assert_allclose(out["R"], other["R"], atol=2e-4, err_msg=name)
        np.testing.assert_allclose(out["T"], other["T"], atol=5e-4, err_msg=name)
        np.testing.assert_allclose(out["loss"], other["loss"], rtol=5e-3, err_msg=name)
        np.testing.assert_allclose(out["image"], other["image"], atol=1e-3, err_msg=name)
    assert int((out["n_touched"] > 0).sum()) > 0
    # the touch counts of the final packed render: the reference's, where
    # both trackers stopped at one pose
    assert (out["n_touched"] > 0).tolist() == (np.asarray(ref.n_touched) > 0).tolist()
    assert out["median_depth"].shape == np.asarray(ref.median_depth).shape
    assert abs(float(out["median_depth"]) - float(ref.median_depth)) < 1e-3 * float(ref.median_depth)
