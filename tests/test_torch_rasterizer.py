"""lvdgs_torch rasterizer and blend kernels against lvdgs_tpu (CPU).

The plain PyTorch versions of the three blend kernels are held against the
Pallas kernels in interpret mode, and the port's `rasterize` (values and
gradients for every parameter and for the pose) against the reference's
Pallas path. Tolerances are those of tests/test_rasterizer_pallas.py:
image 3e-4, depth 3e-3, normalised gradients 2e-3; median depth 1e-5.
The kernels stop per tile where Pallas stops per group of tiles, which
changes only T_EPS-sized terms (see lvdgs_torch/ops/rasterizer_cuda.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_tpu.core import lie as jlie
from lvdgs_tpu.core.camera import Intrinsics as JIntrinsics
from lvdgs_tpu.ops import rasterizer as jr
from lvdgs_tpu.ops.rasterizer_pallas import pallas_blend, pallas_median_depth
from lvdgs_torch.core import lie as tlie
from lvdgs_torch.core.camera import Intrinsics
from lvdgs_torch.ops import rasterizer as tr
from lvdgs_torch.ops import rasterizer_cuda as rc
from reference_rasterizer import render_np
from torch_parity import make_scene_np, normalized_close, to_np, to_torch

INTR_J = JIntrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
INTR = Intrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
CFG_J = jr.RenderConfig(tile_size=16, max_per_tile=64, gaussian_chunk=8, tile_chunk=16,
                        use_pallas=True, tile_group=4, use_packed=False)
CFG = tr.RenderConfig(tile_size=16, max_per_tile=64, tile_chunk=16)
NTX, NTY = 4, 3


def _tile_block(params_np, with_colors=True):
    """(K, T, 10) tile params and counts from the reference's binning."""
    p = {k: jnp.asarray(v) for k, v in params_np.items()}
    n = p["means"].shape[0]
    active = jnp.ones((n,), bool)
    proj = jr.project_gaussians(p["means"], p["quats"], p["log_scales"], active,
                                jnp.eye(3), jnp.zeros(3), INTR_J)
    tile_idx, slot_valid = jr.bin_gaussians(
        proj["mean2d"], proj["radius"], proj["depth"], proj["valid"],
        ntx=NTX, nty=NTY, tile_size=16, max_per_tile=64, tile_chunk=16,
    )
    colors = jnp.clip(0.5 + jr_sh() * p["features_dc"], 0.0, 1.0)
    if not with_colors:
        colors = jnp.zeros_like(colors)
    opac = jax.nn.sigmoid(p["logit_opacities"])
    pad = lambda a: jnp.concatenate([a, jnp.zeros((1,) + a.shape[1:], a.dtype)], 0)  # noqa: E731
    fields = jnp.concatenate([pad(proj["mean2d"]), pad(proj["conic"]), pad(colors),
                              pad(proj["depth"][:, None]), pad(opac[:, None])], axis=1)
    tp = fields[jnp.minimum(tile_idx, n).T]
    counts = slot_valid.sum(axis=1).astype(jnp.int32)
    return tp, counts


def jr_sh():
    from lvdgs_tpu.gaussian.model import SH_C0
    return SH_C0


@pytest.fixture(scope="module")
def block():
    return _tile_block(make_scene_np(120, seed=1))


def test_plain_blend_forward_matches_pallas(block):
    tp, counts = block
    acc_j, trans_j, nt_j = pallas_blend(tp, counts, NTX, NTY, 16, 4, True)
    acc, trans, nt, _march = rc.blend_forward(torch.tensor(np.asarray(tp)), torch.tensor(np.asarray(counts)),
                                              NTX)
    np.testing.assert_allclose(to_np(acc)[:, :3], np.asarray(acc_j)[:, :3], atol=3e-4)
    np.testing.assert_allclose(to_np(acc)[:, 3], np.asarray(acc_j)[:, 3], atol=3e-3)
    np.testing.assert_allclose(to_np(trans), np.asarray(trans_j), atol=3e-4)
    np.testing.assert_array_equal(to_np(nt), np.asarray(nt_j))


def test_plain_blend_backward_matches_pallas_vjp(block):
    tp, counts = block
    rng = np.random.default_rng(7)
    T = tp.shape[1]
    dacc = rng.normal(size=(T, 4, 256)).astype(np.float32)
    dtrans = rng.normal(size=(T, 256)).astype(np.float32)
    (acc_j, trans_j, nt_j), vjp = jax.vjp(
        lambda x: pallas_blend(x, counts, NTX, NTY, 16, 4, True), tp
    )
    (dtp_j,) = vjp((jnp.asarray(dacc), jnp.asarray(dtrans), jnp.zeros_like(nt_j)))
    tpt, ct = torch.tensor(np.asarray(tp)), torch.tensor(np.asarray(counts))
    acc, trans, _, march = rc.blend_forward(tpt, ct, NTX)
    dtp = rc.blend_backward(tpt, ct, march, acc, trans, torch.tensor(dacc), torch.tensor(dtrans), NTX)
    for f in range(rc.NF):
        normalized_close(np.asarray(dtp_j)[..., f], dtp[..., f], 2e-3)


def test_plain_median_depth_matches_pallas():
    tp, counts = _tile_block(make_scene_np(120, seed=3), with_colors=False)
    dmed_j, opac_j = pallas_median_depth(tp, counts, ntx=NTX, nty=NTY, tile_size=16,
                                         tile_group=4, interpret=True)
    dmed, opac = rc.median_depth(torch.tensor(np.asarray(tp)), torch.tensor(np.asarray(counts)), NTX)
    np.testing.assert_allclose(to_np(dmed), np.asarray(dmed_j), atol=1e-5)
    never = np.asarray(dmed_j) == 0
    np.testing.assert_allclose(to_np(opac)[never], np.asarray(opac_j)[never], atol=1e-5)


@pytest.fixture(scope="module")
def renders():
    """Forward + gradients of one loss through both rasterizers."""
    scene = make_scene_np(100, seed=2)
    R_np = np.asarray(jlie.so3_exp(jnp.array([0.03, -0.02, 0.01])), np.float32)
    t_np = np.array([0.05, -0.02, 0.1], np.float32)

    def loss_j(p, tau):
        R, t = jlie.apply_delta(jnp.asarray(R_np), jnp.asarray(t_np), tau)
        out = jr.rasterize(p, jnp.ones((100,), bool), R, t, INTR_J, CFG_J)
        loss = ((out.image - 0.3) ** 2).mean() + 0.05 * (out.depth**2).mean() + 0.1 * out.opacity.mean()
        return loss, out

    pj = {k: jnp.asarray(v) for k, v in scene.items()}
    (lj, out_j), (gp_j, gtau_j) = jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(
        pj, jnp.zeros(6)
    )
    pt = to_torch(scene, requires_grad=True)
    tau = torch.zeros(6, requires_grad=True)
    R, t = tlie.apply_delta(torch.tensor(R_np), torch.tensor(t_np), tau)
    out_t = tr.rasterize(pt, torch.ones(100, dtype=torch.bool), R, t, INTR, CFG)
    lt = ((out_t.image - 0.3) ** 2).mean() + 0.05 * (out_t.depth**2).mean() + 0.1 * out_t.opacity.mean()
    lt.backward()
    return out_j, gp_j, gtau_j, out_t, pt, tau, scene, R_np, t_np


def test_rasterize_forward_matches_reference(renders):
    out_j, _, _, out_t, *_ = renders
    np.testing.assert_allclose(to_np(out_t.image), np.asarray(out_j.image), atol=3e-4)
    np.testing.assert_allclose(to_np(out_t.depth), np.asarray(out_j.depth), atol=3e-3)
    np.testing.assert_allclose(to_np(out_t.opacity), np.asarray(out_j.opacity), atol=3e-4)
    np.testing.assert_allclose(to_np(out_t.radii), np.asarray(out_j.radii), atol=0)
    np.testing.assert_array_equal(to_np(out_t.visibility_filter), np.asarray(out_j.visibility_filter))
    np.testing.assert_array_equal(to_np(out_t.n_touched), np.asarray(out_j.n_touched))


@pytest.mark.parametrize("field", ["means", "features_dc", "log_scales", "quats", "logit_opacities"])
def test_rasterize_param_gradients_match_reference(renders, field):
    _, gp_j, _, _, pt, *_ = renders
    normalized_close(np.asarray(gp_j[field]), pt[field].grad, 2e-3)


def test_rasterize_pose_gradient_matches_reference(renders):
    _, _, gtau_j, _, _, tau, *_ = renders
    assert np.linalg.norm(np.asarray(gtau_j)) > 1e-7
    normalized_close(np.asarray(gtau_j), tau.grad, 2e-3)


def test_rasterize_matches_numpy_oracle(renders):
    _, _, _, out_t, _, _, scene, R_np, t_np = renders
    ref = render_np(scene, np.ones(100, bool), R_np, t_np, INTR)
    # float32 vs float64 flips pixels sitting on the alpha thresholds
    np.testing.assert_allclose(to_np(out_t.image), ref["render"], atol=4e-3)
    np.testing.assert_allclose(to_np(out_t.depth), ref["depth"], atol=3e-2)
    np.testing.assert_allclose(to_np(out_t.opacity), ref["opacity"], atol=4e-3)
    nt, nt_ref = to_np(out_t.n_touched), ref["n_touched"]
    assert np.all(np.abs(nt - nt_ref) <= np.maximum(3, 0.05 * nt_ref))


def test_two_level_binning_matches_reference():
    """Coarse-tile binning (map larger than max_per_coarse, > 64 tiles) and
    margin admission select the same slots as the reference."""
    intr_j = JIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=64.0, width=160, height=128)
    scene = make_scene_np(400, seed=5, spread=2.0)
    pj = {k: jnp.asarray(v) for k, v in scene.items()}
    proj = jr.project_gaussians(pj["means"], pj["quats"], pj["log_scales"],
                                jnp.ones((400,), bool), jnp.eye(3), jnp.zeros(3), intr_j)
    kw = dict(ntx=10, nty=8, tile_size=16, max_per_tile=32, tile_chunk=16,
              coarse_factor=4, max_per_coarse=128)
    idx_j, sv_j = jr.bin_gaussians(proj["mean2d"], proj["radius"], proj["depth"], proj["valid"],
                                   4.0, use_approx_topk=False, **kw)
    idx_t, sv_t = tr.bin_gaussians(*(torch.tensor(np.asarray(proj[k])) for k in
                                     ("mean2d", "radius", "depth", "valid")), 4.0, **kw)
    np.testing.assert_array_equal(to_np(sv_t), np.asarray(sv_j))
    np.testing.assert_array_equal(to_np(idx_t), np.asarray(idx_j))


def test_median_depth_render_matches_reference():
    scene = make_scene_np(150, seed=4)
    pj = {k: jnp.asarray(v) for k, v in scene.items()}
    cfg_j = dataclasses.replace(CFG_J, use_pallas=False)  # the reference's CPU path
    d_j, o_j = jr.rasterize_median_depth(pj, jnp.ones((150,), bool), jnp.eye(3), jnp.zeros(3),
                                         INTR_J, cfg_j)
    d_t, o_t = tr.rasterize_median_depth(to_torch(scene), torch.ones(150, dtype=torch.bool),
                                         torch.eye(3), torch.zeros(3), INTR, CFG)
    np.testing.assert_allclose(to_np(d_t), np.asarray(d_j), atol=1e-5)
    never = np.asarray(d_j) == 0
    np.testing.assert_allclose(to_np(o_t)[never], np.asarray(o_j)[never], atol=1e-5)


def test_wrappers_refuse_bad_inputs():
    tp = torch.zeros((4, 2, rc.NF))
    with pytest.raises(ValueError):
        rc.blend_forward(tp, torch.zeros(2, dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        rc.blend_forward(tp.transpose(0, 1), torch.zeros(4, dtype=torch.int32), 2)


def test_render_entry_points_match_reference():
    """`render` with a pose delta and `render_with_custom_resolution`, on a
    map and camera carried over by convert.py."""
    from lvdgs_tpu.core.camera import Camera as JCamera
    from lvdgs_tpu.gaussian import model as jgm
    from torch_parity import camera_pair, map_to_torch

    scene = make_scene_np(90, seed=6)
    jmap = jgm.create_map(128)
    jmap = jmap.replace(**{k: getattr(jmap, k).at[:90].set(jnp.asarray(v)) for k, v in scene.items()},
                        active=jnp.arange(128) < 90)
    R = np.asarray(jlie.so3_exp(jnp.array([0.02, 0.01, -0.03])))
    jcam = JCamera.create(2, jnp.zeros((3, 48, 64)), INTR_J).update_RT(jnp.asarray(R),
                                                                     jnp.array([0.1, 0.0, 0.2]))
    tmap, (_, tcam) = map_to_torch(jmap), camera_pair(jcam)
    tau = np.array([0.01, -0.02, 0.03, 0.005, 0.0, -0.01], np.float32)
    out_j = jr.render(jmap, jcam, INTR_J, CFG_J, tau=jnp.asarray(tau))
    out_t = tr.render(tmap, tcam, INTR, CFG, tau=torch.tensor(tau))
    np.testing.assert_allclose(to_np(out_t.image), np.asarray(out_j.image), atol=3e-4)
    np.testing.assert_allclose(to_np(out_t.depth), np.asarray(out_j.depth), atol=3e-3)
    out_j = jr.render_with_custom_resolution(jmap, jcam, INTR_J, CFG_J, 32, 24)
    out_t = tr.render_with_custom_resolution(tmap, tcam, INTR, CFG, 32, 24)
    assert out_t.image.shape == (3, 24, 32)
    np.testing.assert_allclose(to_np(out_t.image), np.asarray(out_j.image), atol=3e-4)
    np.testing.assert_allclose(to_np(out_t.opacity), np.asarray(out_j.opacity), atol=3e-4)
