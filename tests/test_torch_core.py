"""lvdgs_torch.core (lie, camera, losses) against lvdgs_tpu.core on the CPU.

Inputs are made from a NumPy seed and handed to both packages; values and
gradients must agree to float32 rounding (1e-5 relative unless stated).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_tpu.core import camera as jcam
from lvdgs_tpu.core import lie as jlie
from lvdgs_tpu.core import losses as jloss
from lvdgs_torch.core import camera as tcam
from lvdgs_torch.core import lie as tlie
from lvdgs_torch.core import losses as tloss
from torch_parity import camera_pair, normalized_close, to_np

RTOL, ATOL = 1e-5, 1e-6


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# lie

TAUS = {
    "zero": np.zeros(6, np.float32),
    "tiny": np.array([1e-4, -2e-4, 3e-4, 2e-6, -1e-6, 3e-6], np.float32),
    "small": np.array([0.02, -0.015, 0.03, 0.008, -0.006, 0.01], np.float32),
    "large": np.array([0.3, 0.1, -0.2, 0.9, -0.4, 1.3], np.float32),
}


@pytest.mark.parametrize("name", sorted(TAUS))
def test_exp_log_maps_match(name):
    tau = TAUS[name]
    close(tlie.so3_exp(torch.tensor(tau[3:])), jlie.so3_exp(jnp.asarray(tau[3:])))
    close(tlie.so3_left_jacobian(torch.tensor(tau[3:])), jlie.so3_left_jacobian(jnp.asarray(tau[3:])))
    close(tlie.se3_exp(torch.tensor(tau)), jlie.se3_exp(jnp.asarray(tau)))
    R = np.asarray(jlie.so3_exp(jnp.asarray(tau[3:])))
    close(tlie.so3_log(torch.tensor(R)), jlie.so3_log(jnp.asarray(R)), atol=1e-5)


@pytest.mark.parametrize("name", sorted(TAUS))
def test_apply_delta_value_and_gradient_match(name):
    rng = np.random.default_rng(3)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32))))
    t0 = rng.normal(size=3).astype(np.float32)
    wR = rng.normal(size=(3, 3)).astype(np.float32)
    wt = rng.normal(size=3).astype(np.float32)
    tau = TAUS[name]

    def f_j(x):
        R, t = jlie.apply_delta(jnp.asarray(R0), jnp.asarray(t0), x)
        return (R * wR).sum() + (t * wt).sum(), (R, t)

    (_, (Rj, tj)), gj = jax.value_and_grad(f_j, has_aux=True)(jnp.asarray(tau))
    x = torch.tensor(tau, requires_grad=True)
    Rt, tt = tlie.apply_delta(torch.tensor(R0), torch.tensor(t0), x)
    ((Rt * torch.tensor(wR)).sum() + (tt * torch.tensor(wt)).sum()).backward()
    close(Rt, Rj)
    close(tt, tj)
    assert np.isfinite(to_np(x.grad)).all()
    close(x.grad, gj, atol=1e-5)


def test_rigid_helpers_match():
    rng = np.random.default_rng(4)
    Ra = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32))))
    Rb = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32))))
    ta, tb = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    close(tlie.rt_to_mat(torch.tensor(Ra), torch.tensor(ta)), jlie.rt_to_mat(Ra, ta))
    for a, b in zip(tlie.invert_rt(torch.tensor(Ra), torch.tensor(ta)), jlie.invert_rt(Ra, ta)):
        close(a, b)
    close(tlie.relative_translation_norm(*map(torch.tensor, (Ra, ta, Rb, tb))),
          jlie.relative_translation_norm(Ra, ta, Rb, tb))
    close(tlie.hat(torch.tensor(ta)), jlie.hat(jnp.asarray(ta)))


# ---------------------------------------------------------------------------
# camera


def test_intrinsics_and_projection_match():
    kw = dict(fx=707.0912, fy=707.0912, cx=601.8873, cy=183.1104, width=1226, height=370)
    ji, ti = jcam.Intrinsics(**kw), tcam.Intrinsics(**kw)
    np.testing.assert_array_equal(tcam.projection_matrix(ti), jcam.projection_matrix(ji))
    np.testing.assert_array_equal(ti.K, ji.K)
    assert (ti.fovx, ti.fovy) == (ji.fovx, ji.fovy)
    assert dataclasses.asdict(ti.scaled(613, 185)) == dataclasses.asdict(ji.scaled(613, 185))
    assert tcam.fov2focal(ti.fovx, 1226) == jcam.fov2focal(ji.fovx, 1226)


def test_camera_state_matches():
    rng = np.random.default_rng(5)
    intr = jcam.Intrinsics(fx=40.0, fy=40.0, cx=16.0, cy=12.0, width=32, height=24)
    image = rng.uniform(size=(3, 24, 32)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32))))
    T = rng.normal(size=3).astype(np.float32)
    jc = jcam.Camera.create(7, jnp.asarray(image), intr, gt_R=R, gt_T=T).update_RT(R, T)
    jc = jc.replace(exposure_a=jnp.float32(0.1), exposure_b=jnp.float32(-0.05))
    _, tc = camera_pair(jc)
    tc_new = tcam.Camera.create(7, torch.tensor(image), tcam.Intrinsics(**dataclasses.asdict(intr)),
                                gt_R=torch.tensor(R), gt_T=torch.tensor(T))
    for f in ("image", "R_gt", "T_gt", "depth", "mono_depth", "grad_mask", "static_mask"):
        np.testing.assert_array_equal(to_np(getattr(tc_new, f)), np.asarray(getattr(jc, f)))
    close(tc.w2c, jc.w2c)
    close(tc.camera_center, jc.camera_center)
    close(tc.exposure_apply(torch.tensor(image)), jc.exposure_apply(jnp.asarray(image)))


# ---------------------------------------------------------------------------
# losses


@pytest.fixture(scope="module")
def frame():
    """An image with edges and flat regions, a rendered image/depth/opacity
    and a camera, at 48x64."""
    rng = np.random.default_rng(6)
    H, W = 48, 64
    yy, xx = np.mgrid[0:H, 0:W]
    base = 0.5 + 0.4 * np.sign(np.sin(xx / 5.0)) * np.cos(yy / 7.0)
    gt = np.clip(base[None] + 0.05 * rng.normal(size=(3, H, W)), 0, 1).astype(np.float32)
    gt[:, :6, :10] = 0.0  # below the rgb boundary threshold
    # not clipped: an exact tie render == gt has |x|' = +1 in JAX and 0 in
    # PyTorch, so the inputs avoid ties
    render = (gt + 0.1 * rng.normal(size=gt.shape)).astype(np.float32)
    depth = rng.uniform(1.0, 5.0, size=(1, H, W)).astype(np.float32)
    depth[0, 20:30, 30:40] = 0.0
    opacity = rng.uniform(0.5, 1.0, size=(1, H, W)).astype(np.float32)
    mono = (depth[0] * 1.1).astype(np.float32)
    mono[::7, ::5] = 0.0
    static = rng.uniform(size=(H, W)) > 0.2
    intr = jcam.Intrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=W, height=H)
    grad_mask = np.asarray(jloss.compute_grad_mask(jnp.asarray(gt), 1.1))
    jc = jcam.Camera.create(3, jnp.asarray(gt), intr, depth=depth[0] * 0.9, mono_depth=mono).replace(
        exposure_a=jnp.float32(0.05), exposure_b=jnp.float32(0.02),
        grad_mask=jnp.asarray(grad_mask), static_mask=jnp.asarray(static),
        has_static_mask=jnp.asarray(True))
    return dict(gt=gt, render=render, depth=depth, opacity=opacity, jc=jc, tc=camera_pair(jc)[1])


@pytest.mark.parametrize("dataset_type", ["KITTI", "replica"])
def test_grad_mask_matches(frame, dataset_type):
    gv_t, gh_t = tloss.image_gradient(torch.tensor(frame["gt"]))
    gv_j, gh_j = jloss.image_gradient(jnp.asarray(frame["gt"]))
    close(gv_t, gv_j)
    close(gh_t, gh_j)
    m_t = tloss.compute_grad_mask(torch.tensor(frame["gt"]), 1.1, dataset_type)
    m_j = jloss.compute_grad_mask(jnp.asarray(frame["gt"]), 1.1, dataset_type)
    assert 0 < int(np.asarray(m_j).sum()) < m_j.size
    np.testing.assert_array_equal(to_np(m_t), np.asarray(m_j))


def _value_and_grads(frame, fn_t, fn_j):
    """Loss value and gradients w.r.t. (image, depth, opacity) in both."""
    args = (frame["render"], frame["depth"], frame["opacity"])
    vj, gj = jax.value_and_grad(lambda *a: fn_j(*a, frame["jc"]), argnums=(0, 1, 2))(
        *map(jnp.asarray, args))
    xs = [torch.tensor(a, requires_grad=True) for a in args]
    vt = fn_t(*xs, frame["tc"])
    gt = torch.autograd.grad(vt, xs, allow_unused=True)
    close(vt, vj)
    for a, b in zip(gt, gj):
        close(torch.zeros(b.shape) if a is None else a, b, atol=1e-8)


LOSSES = {
    "tracking_mono": (
        lambda i, d, o, c: tloss.loss_tracking(i, d, o, c),
        lambda i, d, o, c: jloss.loss_tracking(i, d, o, c)),
    "tracking_rgbd": (
        lambda i, d, o, c: tloss.loss_tracking(i, d, o, c, monocular=False),
        lambda i, d, o, c: jloss.loss_tracking(i, d, o, c, monocular=False)),
    "tracking_rgb": (
        lambda i, d, o, c: tloss.loss_tracking_rgb(c.exposure_apply(i), c, 0.01),
        lambda i, d, o, c: jloss.loss_tracking_rgb(c.exposure_apply(i), c, 0.01)),
    "mapping_rgbd": (
        lambda i, d, o, c: tloss.loss_mapping(i, d, c),
        lambda i, d, o, c: jloss.loss_mapping(i, d, c)),
    "mapping_init": (
        lambda i, d, o, c: tloss.loss_mapping(i, d, c, initialization=True),
        lambda i, d, o, c: jloss.loss_mapping(i, d, c, initialization=True)),
    "mapping_rgb_only": (
        lambda i, d, o, c: tloss.loss_mapping(i, d, c, monodepth=False),
        lambda i, d, o, c: jloss.loss_mapping(i, d, c, monodepth=False)),
    "mapping_masked": (
        lambda i, d, o, c: tloss.loss_mapping_masked(i, d, c, torch.tensor([0.1, 0.2, 0.3])),
        lambda i, d, o, c: jloss.loss_mapping_masked(i, d, c, jnp.array([0.1, 0.2, 0.3]))),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_and_gradients_match(frame, name):
    _value_and_grads(frame, *LOSSES[name])


def test_image_statistics_match(frame):
    a, b = frame["render"], frame["gt"]
    vj, gj = jax.value_and_grad(jloss.ssim)(jnp.asarray(a), jnp.asarray(b))
    x = torch.tensor(a, requires_grad=True)
    vt = tloss.ssim(x, torch.tensor(b))
    vt.backward()
    close(vt, vj)
    # the 11x11 convolutions sum in another order than XLA's
    normalized_close(gj, x.grad, 1e-4)
    close(tloss.psnr(torch.tensor(a), torch.tensor(b)), jloss.psnr(a, b))
    mask = frame["jc"].static_mask
    close(tloss.psnr(torch.tensor(a), torch.tensor(b), torch.tensor(np.asarray(mask))),
          jloss.psnr(a, b, mask))
    close(tloss.l1_loss(torch.tensor(a), torch.tensor(b)), jloss.l1_loss(a, b))


def test_depth_statistics_match(frame):
    d, o = frame["depth"], frame["opacity"]
    m = np.asarray(frame["jc"].static_mask)
    for args in ((d,), (d, o), (d, o, m), (d, None, m)):
        t_args = [None if x is None else torch.tensor(x) for x in args]
        close(tloss.get_median_depth(*t_args), jloss.get_median_depth(*args))
    close(tloss.masked_median(torch.tensor(d), torch.tensor(d > 10.0)),
          jloss.masked_median(jnp.asarray(d), jnp.asarray(d > 10.0)))
    rng = np.random.default_rng(8)
    s = np.exp(rng.normal(size=(50, 3))).astype(np.float32)
    act = rng.uniform(size=50) > 0.3
    close(tloss.isotropic_reg(torch.tensor(s), torch.tensor(act)), jloss.isotropic_reg(s, act))
    close(tloss.masked_mean(torch.tensor(d), torch.tensor(d > 2)), jloss.masked_mean(d, d > 2))
