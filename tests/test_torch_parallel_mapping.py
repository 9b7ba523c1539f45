"""lvdgs_torch.parallel's sharded mapping step and camera-data-parallel
mapping_run against the reference's (lvdgs_tpu.parallel.dp_mapping and
mapping_run(mesh=...)) on the CPU.

The port's ranks are gloo processes on the CPU (launch.spawn; the workers
are in tests/torch_parallel_workers.py), as many as the reference's
virtual devices, so the map and camera splits are the same. Rank 0's
result is held against the reference's at the tolerances of
tests/test_parallel.py, and every rank's against rank 0's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import __graft_entry__ as ge
import torch_parallel_workers as workers
from lvdgs_tpu.core.camera import Camera as JCamera
from lvdgs_tpu.core.camera import Intrinsics as JIntrinsics
from lvdgs_tpu.gaussian import model as jgm
from lvdgs_tpu.ops.rasterizer import RenderConfig as JRenderConfig
from lvdgs_tpu.parallel.dp_mapping import make_sharded_mapping_step
from lvdgs_tpu.parallel.mesh import make_mesh as jmake_mesh
from lvdgs_tpu.slam import mapping as jmp
from lvdgs_tpu.slam import state as jst
from lvdgs_torch import convert
from lvdgs_torch.core.camera import Intrinsics
from lvdgs_torch.gaussian import model as tgm
from lvdgs_torch.ops.rasterizer import RenderConfig
from lvdgs_torch.parallel.launch import spawn
from lvdgs_torch.slam import mapping as tmp
from torch_parity import PARAM_FIELDS, leaves_np, to_np

pytestmark = pytest.mark.skipif(len(jax.devices()) < 5, reason="needs 5 virtual devices")
# process-group and join timeouts of every spawned world (s)
TIMEOUT = 120.0


def _ranks(fn, n, *args):
    return spawn(fn, n, backend="gloo", device="cpu", args=args, timeout=TIMEOUT, join_timeout=TIMEOUT)


def _assert_ranks_equal(outs, keys):
    """Every rank's result equals rank 0's bit for bit (nested dicts of
    arrays and numbers)."""
    def walk(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)

    for r, out in enumerate(outs[1:], 1):
        for k in keys:
            walk(outs[0][k], out[k], f"rank {r} {k}")


def test_sharded_step_matches_reference():
    """One step of the (data 2, gauss 2) sharded mapping step on the tiny
    scene against the reference's on a 2x2 mesh. The reference's Adam at
    step 1 is a sign-sized update, so reduction-order noise on near-zero
    gradients flips a handful of entries by ~lr (tests/test_parallel.py:
    losses tight, parameters within one update). The reference's gradients
    and Adam moments carry a factor of n_gauss (the reduce-scatter adds the
    gauss row's equal camera gradients; ROADMAP C18), the port's do not, so
    the port's moments are held to the reference's over n_gauss and
    n_gauss squared."""
    params, active, intr_j, rcfg_j = ge._tiny_scene(n=256, h=32, w=32)
    intr = Intrinsics(fx=intr_j.fx, fy=intr_j.fy, cx=intr_j.cx, cy=intr_j.cy, width=32, height=32)
    rcfg = RenderConfig(tile_size=16, max_per_tile=128, tile_chunk=16)
    rng = np.random.default_rng(0)
    B = 4
    batch = {
        "images": rng.uniform(0, 1, size=(B, 3, 32, 32)).astype(np.float32),
        "mono_depths": rng.uniform(2, 6, size=(B, 32, 32)).astype(np.float32),
        "Rs": np.tile(np.eye(3, dtype=np.float32)[None], (B, 1, 1)),
        "Ts": np.zeros((B, 3), np.float32),
        "taus": np.zeros((B, 6), np.float32),
    }
    mesh = jmake_mesh(n_data=2, n_gauss=2, devices=jax.devices()[:4])
    step, shard_fn = make_sharded_mapping_step(mesh, intr_j, rcfg_j)
    zeros = {f: jnp.zeros_like(params[f]) for f in PARAM_FIELDS}
    p, a, m, v, cb = shard_fn(params, active, zeros, zeros, {k: jnp.asarray(x) for k, x in batch.items()})
    ref = step(p, a, m, v, jnp.zeros((), jnp.int32), cb["images"], cb["mono_depths"], cb["Rs"], cb["Ts"],
               cb["taus"])

    scene = {**{f: np.asarray(params[f]) for f in PARAM_FIELDS}, "active": np.asarray(active)}
    outs = _ranks(workers.sharded_step, 4, 2, 2, scene, batch, intr, rcfg)
    # ranks (data, gauss) = (0, 0), (0, 1), (1, 0), (1, 1): each gauss
    # column's rows are the same on both data rows
    assert [(o["data"], o["gauss"]) for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in (2, 3):
        for k in ("params", "m", "v", "loss", "count"):
            _assert_ranks_equal([outs[r - 2], outs[r]], [k])
    full = {k: {f: np.concatenate([outs[0][k][f], outs[1][k][f]]) for f in PARAM_FIELDS}
            for k in ("params", "m", "v")}
    assert outs[0]["count"] == 1 and outs[0]["loss"] == outs[1]["loss"]
    np.testing.assert_allclose(outs[0]["loss"], float(ref[4]), rtol=1e-5)
    for f in PARAM_FIELDS:
        a, b = full["params"][f], np.asarray(ref[0][f])
        np.testing.assert_allclose(a, b, atol=6e-3, err_msg=f)
        frac_equal = np.mean(np.abs(a - b) < 1e-6)
        assert frac_equal > 0.95, f"{f}: only {frac_equal:.2%} bitwise-close"
        for k, i, scale in (("m", 1, 2.0), ("v", 2, 4.0)):
            ref_k = np.asarray(ref[i][f]) / scale
            np.testing.assert_allclose(full[k][f], ref_k, atol=1e-3 * np.abs(ref_k).max(), err_msg=f"{k} {f}")



@pytest.mark.parametrize("n_data,n_gauss", [(1, 2), (2, 1)])
def test_sharded_step_is_mesh_invariant(n_data, n_gauss):
    """The port's step on (1, 2) and (2, 1) against its (1, 1) step (a
    world of one in this process), on the tiny scene: the loss within
    1e-6. Across "gauss" the map's gradients are the (1, 1) ones bit for
    bit (the row's copies sum to exactly twice half of it; C18), and so are
    the new parameters and first moments; across "data" the cameras'
    gradients are summed in another order: the parameters are held as the
    reference holds its meshes (6e-3, 95% within 1e-6), the moments to
    1e-4 of their largest."""
    from lvdgs_torch.parallel.launch import world_of_one

    params, active, intr_j, _ = ge._tiny_scene(n=256, h=32, w=32)
    intr = Intrinsics(fx=intr_j.fx, fy=intr_j.fy, cx=intr_j.cx, cy=intr_j.cy, width=32, height=32)
    rcfg = RenderConfig(tile_size=16, max_per_tile=128, tile_chunk=16)
    rng = np.random.default_rng(1)
    batch = {"images": rng.uniform(0, 1, size=(2, 3, 32, 32)).astype(np.float32),
             "mono_depths": rng.uniform(2, 6, size=(2, 32, 32)).astype(np.float32),
             "Rs": np.tile(np.eye(3, dtype=np.float32)[None], (2, 1, 1)),
             "Ts": np.zeros((2, 3), np.float32), "taus": np.zeros((2, 6), np.float32)}
    scene = {**{f: np.asarray(params[f]) for f in PARAM_FIELDS}, "active": np.asarray(active)}
    with world_of_one("gloo"):
        one = workers.sharded_step(0, 1, 1, scene, batch, intr, rcfg)
    outs = _ranks(workers.sharded_step, 2, n_data, n_gauss, scene, batch, intr, rcfg)
    rows = [o for o in outs if o["data"] == 0]
    full = {k: {f: np.concatenate([o[k][f] for o in rows]) for f in PARAM_FIELDS} for k in ("params", "m")}
    np.testing.assert_allclose(outs[0]["loss"], one["loss"], rtol=1e-6)
    for f in PARAM_FIELDS:
        a, b, m = full["params"][f], one["params"][f], one["m"][f]
        if n_gauss > 1:
            np.testing.assert_array_equal(a, b, err_msg=f)
            np.testing.assert_array_equal(full["m"][f], m, err_msg=f"m {f}")
        else:
            np.testing.assert_allclose(a, b, atol=6e-3, err_msg=f)
            assert np.mean(np.abs(a - b) < 1e-6) > 0.95, f
            np.testing.assert_allclose(full["m"][f], m, atol=1e-4 * np.abs(m).max(), err_msg=f"m {f}")

def _dp_world(seed, masked):
    """The reference's camera-DP mapping scene (tests/test_parallel.py:
    plain :63-134, with static masks :188-260): 128 Gaussians in a map of
    256, three keyframes in a window of four, one replay slot."""
    H, W = 32, 32
    intr_j = JIntrinsics(fx=40.0, fy=40.0, cx=16.0, cy=12.0, width=W, height=H)
    rng = np.random.default_rng(seed)
    gmap = jgm.create_map(256)
    n = 128
    means = np.concatenate([rng.normal(size=(n, 2)) * 1.0, rng.uniform(2.0, 6.0, size=(n, 1))], 1)
    gmap = gmap.replace(
        means=gmap.means.at[:n].set(jnp.asarray(means, jnp.float32)),
        features_dc=gmap.features_dc.at[:n].set(jnp.asarray(rng.normal(size=(n, 3)) * 0.3, jnp.float32)),
        log_scales=gmap.log_scales.at[:n].set(jnp.asarray(rng.uniform(-2.5, -1.5, size=(n, 3)), jnp.float32)),
        quats=gmap.quats.at[:n].set(jnp.asarray(rng.normal(size=(n, 4)), jnp.float32)),
        logit_opacities=gmap.logit_opacities.at[:n].set(jnp.asarray(rng.uniform(0.0, 2.0, size=(n,)),
                                                                    jnp.float32)),
        active=gmap.active.at[:n].set(True),
    )
    kfbuf = jst.create_keyframe_buffer(8, H, W)
    for i in range(3):
        img = jnp.asarray(rng.uniform(0, 1, size=(3, H, W)), jnp.float32)
        static = jnp.asarray(rng.random((H, W)) > 0.25) if masked else None
        cam = JCamera.create(i, img, intr_j, mono_depth=jnp.asarray(rng.uniform(2, 6, size=(H, W)),
                                                                    jnp.float32))
        if masked:
            cam = cam.replace(static_mask=static, has_static_mask=jnp.asarray(True))
        cam = cam.update_RT(jnp.eye(3), jnp.asarray([0.02 * i, 0.0, 0.0], jnp.float32))
        kfbuf, _ = jst.add_keyframe(kfbuf, cam)
    return intr_j, gmap, kfbuf


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "static_masks"])
def test_camera_dp_mapping_run_matches_reference(masked):
    """Four iterations of camera-DP mapping_run on 5 ranks against the
    reference's mapping_run(mesh=Mesh(5 devices)), and against the port's
    single-device run: loss rtol 1e-5, map parameters 5e-3, window poses
    1e-5 (tests/test_parallel.py:127-134). With static masks the window
    cameras take the masked loss by their per-camera flags."""
    intr_j, jmap, jbuf = _dp_world(9 if masked else 3, masked)
    rcfg_j = JRenderConfig(tile_size=16, max_per_tile=64, gaussian_chunk=8, tile_chunk=16, use_pallas=False)
    kw = dict(window_size=4, n_random=1, up_pose=True, use_masked_loss=masked,
              gaussian_update_every=10**6, gaussian_reset=10**6, rebin_every=2)
    window = [0, 1, 2, -1]
    opt_j = jgm.MapOptimizer()
    ref = jmp.mapping_run(
        jax.tree.map(lambda a: a.copy(), jmap), opt_j.init(jmap), jbuf, jnp.asarray(window, jnp.int32),
        jax.random.PRNGKey(0), jnp.zeros((), jnp.int32), jnp.asarray(4, jnp.int32), 0,
        intr=intr_j, rcfg=rcfg_j, opt=opt_j, mcfg=jmp.MappingConfig(**kw),
        mesh=Mesh(np.array(jax.devices()[:5]), ("data",)))

    intr = Intrinsics(fx=40.0, fy=40.0, cx=16.0, cy=12.0, width=32, height=32)
    rcfg = RenderConfig(tile_size=16, max_per_tile=64, tile_chunk=16)
    opt, mcfg = tgm.MapOptimizer(), tmp.MappingConfig(**kw)
    gmap_np, buf_np = leaves_np(jmap), leaves_np(jbuf)
    outs = _ranks(workers.camera_dp_mapping, 5, gmap_np, buf_np, window, 0, 4, intr, rcfg, opt, mcfg, 0)
    _assert_ranks_equal(outs, ["gmap", "opt", "kfbuf", "last_loss", "occ_visibility", "iteration_count"])

    g = convert.gaussian_map_from_numpy(gmap_np, "cpu")
    buf = convert.keyframe_buffer_from_numpy(buf_np, "cpu")
    single = tmp.mapping_run(g, opt.init(g), buf, window, torch.Generator().manual_seed(0), 0, 4,
                             intr=intr, rcfg=rcfg, opt=opt, mcfg=mcfg)
    out = outs[0]
    assert out["iteration_count"] == int(ref.iteration_count) == 4
    for name, loss, gm_f, R in (
            ("reference", float(ref.last_loss), lambda f: np.asarray(getattr(ref.gmap, f)), np.asarray(ref.kfbuf.R)),
            ("single-device port", float(single.last_loss), lambda f: to_np(getattr(g, f)), to_np(buf.R))):
        np.testing.assert_allclose(out["last_loss"], loss, rtol=1e-5, err_msg=name)
        for f in PARAM_FIELDS:
            np.testing.assert_allclose(out["gmap"][f], gm_f(f), atol=5e-3, err_msg=f"{name} {f}")
        np.testing.assert_allclose(out["kfbuf"]["R"], R, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(out["gmap"]["active"], np.asarray(ref.gmap.active))
