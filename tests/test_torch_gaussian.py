"""lvdgs_torch.gaussian.model against lvdgs_tpu.gaussian.model on the CPU.

Both packages start from the same state, carried over from the reference
by lvdgs_torch/convert.py, and are compared slot by slot on the same
fixed-capacity layout. The split noise of densification is the reference's
own (drawn from its key) and handed to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_tpu.core import lie as jlie
from lvdgs_tpu.core.camera import Camera as JCamera
from lvdgs_tpu.core.camera import Intrinsics as JIntrinsics
from lvdgs_tpu.gaussian import model as jgm
from lvdgs_torch import convert
from lvdgs_torch.core.camera import Intrinsics
from lvdgs_torch.gaussian import model as tgm
from torch_parity import assert_map_matches, camera_pair, map_to_torch, to_np

INTR_J = JIntrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
INTR = Intrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
CAP = 2048
# seeded log-scales come from |a|^2 - 2 a.b + |b|^2 distances, which cancel;
# the matrix product sums in another order than XLA's
SEED_ATOL = {"log_scales": 2e-4}


def _frame(seed):
    """A camera with an image, pose and a depth map with holes."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(3, 48, 64)).astype(np.float32)
    depth = rng.uniform(2.0, 6.0, size=(48, 64)).astype(np.float32)
    depth[rng.uniform(size=(48, 64)) < 0.15] = 0.0
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.1, jnp.float32)))
    T = rng.normal(size=3).astype(np.float32)
    cam = JCamera.create(seed, jnp.asarray(image), INTR_J).update_RT(jnp.asarray(R), jnp.asarray(T))
    return cam, depth


def _random_adam(gmap, seed):
    rng = np.random.default_rng(seed)
    m = {f: jnp.asarray(rng.normal(size=getattr(gmap, f).shape), jnp.float32) for f in jgm.PARAM_FIELDS}
    v = {f: jnp.asarray(rng.uniform(size=getattr(gmap, f).shape), jnp.float32) for f in jgm.PARAM_FIELDS}
    return jgm.AdamState(m=m, v=v, count=jnp.asarray(7, jnp.int32))


@pytest.fixture(scope="module")
def holey_map():
    """A reference map seeded from one frame, with a random third of its
    slots pruned, and random Adam moments."""
    cam, depth = _frame(0)
    gmap = jgm.seed_from_depth(jgm.create_map(CAP), cam, jnp.asarray(depth), INTR_J,
                               kf_id=0, downsample=4)
    rng = np.random.default_rng(1)
    gmap = jgm.prune_points(gmap, jnp.asarray(rng.uniform(size=CAP) < 0.33))
    # densification statistics, so densify has work
    gmap = gmap.replace(
        grad_accum=jnp.asarray(rng.uniform(0, 4e-4, CAP) * 3, jnp.float32),
        grad_denom=jnp.asarray(rng.integers(0, 4, CAP), jnp.float32),
        max_radii2d=jnp.asarray(rng.uniform(0, 30, CAP), jnp.float32),
    )
    return gmap, _random_adam(gmap, 2)


def test_seed_from_depth_matches(holey_map):
    jmap, jopt = holey_map
    tmap, topt = map_to_torch(jmap, jopt)
    cam, depth = _frame(3)
    jmap2, jopt2 = jgm.seed_from_depth(jmap, cam, jnp.asarray(depth), INTR_J, kf_id=3,
                                       downsample=4, point_size=0.05, opt_state=jopt)
    tgm.seed_from_depth(tmap, camera_pair(cam)[1], torch.tensor(depth), INTR, kf_id=3,
                        downsample=4, point_size=0.05, opt_state=topt)
    assert int(jmap2.num_active) > int(jmap.num_active)
    assert_map_matches(tmap, jmap2, atol=1e-5, topt=topt, jopt=jopt2, field_atol=SEED_ATOL)


def test_seed_at_capacity_fills_to_capacity():
    cam, depth = _frame(4)
    jmap = jgm.seed_from_depth(jgm.create_map(300), cam, jnp.asarray(depth), INTR_J,
                               kf_id=0, downsample=1)
    tmap = tgm.create_map(300, "cpu")
    tgm.seed_from_depth(tmap, camera_pair(cam)[1], torch.tensor(depth), INTR, kf_id=0, downsample=1)
    assert tmap.num_active == 300
    assert_map_matches(tmap, jmap, atol=1e-5, field_atol=SEED_ATOL)


@pytest.mark.parametrize("P", [700, 2500])
def test_knn_scale_matches_reference(P):
    """The 3-NN mean squared distance, including the reference's blocking of
    its last block (ROADMAP C5): for P above one block and not a multiple of
    it, the last block is read and written at P - block while its
    self-exclusion rows are not shifted, so those points keep their own zero
    distance among their 3 nearest."""
    rng = np.random.default_rng(P)
    pts = rng.normal(size=(P, 3)).astype(np.float32)
    valid = rng.uniform(size=P) > 0.1
    ref = np.asarray(jgm._knn_mean_sq_dist(jnp.asarray(pts), jnp.asarray(valid)))
    out = to_np(tgm._knn_mean_sq_dist(torch.tensor(pts), torch.tensor(valid)))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)
    # exact 3-NN, for the rows the quirk does not touch
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    d2[np.arange(P), np.arange(P)] = np.inf
    d2[:, ~valid] = np.inf
    exact = np.where(valid, np.sort(d2, 1)[:, :3].mean(1), 1.0)
    start = P - 1024 if P > 1024 else P
    np.testing.assert_allclose(out[:start], exact[:start], rtol=1e-3, atol=1e-5)
    if P > 1024:
        assert (out[start:][valid[start:]] < exact[start:][valid[start:]]).mean() > 0.9


@pytest.mark.parametrize("capacity_left", ["room", "full"])
def test_densify_and_prune_matches(holey_map, capacity_left):
    jmap, jopt = holey_map
    if capacity_left == "full":
        # leave fewer free slots than clone + split candidates
        free = np.flatnonzero(~np.asarray(jmap.active))
        fill = np.zeros(CAP, bool)
        fill[free[:-40]] = True
        jmap = jmap.replace(active=jmap.active | jnp.asarray(fill))
    tmap, topt = map_to_torch(jmap, jopt)
    key = jax.random.PRNGKey(11)
    split_eps = np.stack([np.asarray(jax.random.normal(k, (CAP, 3))) for k in jax.random.split(key)])
    kw = dict(grad_threshold=2e-4, min_opacity=0.45, extent=6.0, max_screen_size=20.0,
              percent_dense=0.01)
    jmap2, jopt2 = jgm.densify_and_prune(jmap, key, opt_state=jopt, **kw)
    tgm.densify_and_prune(tmap, torch.tensor(split_eps), opt_state=topt, **kw)
    assert int(jmap2.num_active) != int(jmap.num_active)
    assert_map_matches(tmap, jmap2, atol=1e-5, topt=topt, jopt=jopt2)


def test_opacity_resets_match(holey_map):
    jmap, jopt = holey_map
    tmap, topt = map_to_torch(jmap, jopt)
    jmap2, jopt2 = jgm.reset_opacity(jmap, opt_state=jopt)
    tgm.reset_opacity(tmap, topt)
    assert_map_matches(tmap, jmap2, topt=topt, jopt=jopt2)

    vis = np.random.default_rng(5).uniform(size=CAP) < 0.5
    tmap, topt = map_to_torch(jmap, jopt)
    jmap3, jopt3 = jgm.reset_opacity_nonvisible(jmap, jnp.asarray(vis), opt_state=jopt)
    tgm.reset_opacity_nonvisible(tmap, torch.tensor(vis), topt)
    assert_map_matches(tmap, jmap3, topt=topt, jopt=jopt3)


@pytest.mark.parametrize("lr_step", [0, 1234])
def test_adam_step_matches(holey_map, lr_step):
    jmap, jopt = holey_map
    tmap, topt = map_to_torch(jmap, jopt)
    rng = np.random.default_rng(9)
    grads = {f: rng.normal(size=getattr(jmap, f).shape).astype(np.float32) * 1e-3
             for f in jgm.PARAM_FIELDS}
    grads["means"][3, 1] = np.nan  # the non-finite guard zeroes one component
    grads["logit_opacities"][5] = np.inf
    opt_j = jgm.MapOptimizer(spatial_scale=6.0)
    opt_t = tgm.MapOptimizer(spatial_scale=6.0)
    jmap2, jopt2 = opt_j.step(jmap, {k: jnp.asarray(v) for k, v in grads.items()}, jopt,
                              jnp.asarray(lr_step))
    opt_t.step(tmap, {k: torch.tensor(v) for k, v in grads.items()}, topt, lr_step)
    assert_map_matches(tmap, jmap2, atol=1e-6, topt=topt, jopt=jopt2)
    assert opt_t.lrs(lr_step)["means"] == pytest.approx(float(opt_j.lrs(jnp.asarray(lr_step))["means"]),
                                                        rel=1e-6)


def test_capacity_changes_match(holey_map):
    jmap, jopt = holey_map
    tmap, topt = map_to_torch(jmap, jopt)
    jmap2, jopt2 = jgm.grow_capacity(jmap, 4096, jopt)
    tmap2, topt2 = tgm.grow_capacity(tmap, 4096, topt)
    assert_map_matches(tmap2, jmap2, topt=topt2, jopt=jopt2)

    jmap3, jopt3, jtake = jgm.compact_and_resize(jmap2, 1024, jopt2)
    tmap3, topt3, ttake = tgm.compact_and_resize(tmap2, 1024, topt2)
    np.testing.assert_array_equal(to_np(ttake), np.asarray(jtake))
    assert_map_matches(tmap3, jmap3, topt=topt3, jopt=jopt3)

    jmap4, jopt4 = jgm.gauge_rescale(jmap3, jopt3, 1.07)
    tgm.gauge_rescale(tmap3, topt3, 1.07)
    assert_map_matches(tmap3, jmap4, topt=topt3, jopt=jopt4)


def test_convert_round_trip(holey_map):
    jmap, jopt = holey_map
    tmap, topt = map_to_torch(jmap, jopt)
    back = convert.gaussian_map_to_numpy(tmap)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jmap, k)))
        assert v.dtype == np.asarray(getattr(jmap, k)).dtype
    assert convert.adam_state_to_numpy(topt)["count"] == 7

    from lvdgs_tpu.slam import state as jst

    cam, depth = _frame(6)
    cam = cam.replace(mono_depth=jnp.asarray(depth), exposure_a=jnp.float32(0.2))
    jbuf, _ = jst.add_keyframe(jst.create_keyframe_buffer(4, 48, 64), cam)
    tbuf = convert.keyframe_buffer_from_numpy({k: np.asarray(v) for k, v in vars(jbuf).items()}, "cpu")
    assert tbuf.count == 1
    for k, v in convert.keyframe_buffer_to_numpy(tbuf).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jbuf, k)), err_msg=k)
    for k, v in convert.camera_to_numpy(camera_pair(cam)[1]).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(cam, k)), err_msg=k)
