"""The packed (group-CSR) render path of lvdgs_torch against lvdgs_tpu on the
CPU: pack_bins and saturation_caps (integers equal), the plain versions of
the packed blend kernels against the Pallas kernels in interpret mode, the
packed rasterizer, the pose linearisation, densify's visibility carry,
packed tracking and feedback mapping, and a packed SLAM run.

64x48 frames, 16x16 tiles, 4 tiles per group, as
tests/test_rasterizer_pallas.py. Tolerances are that file's: image 3e-4,
depth 3e-3, normalised gradients 2e-3. The kernels stop per tile where
Pallas skips per group and chunk, which changes only T_EPS-sized terms
(see lvdgs_torch/ops/rasterizer_cuda.py).
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
from lvdgs_tpu.ops.rasterizer_pallas import _packed_bwd_call, _packed_fwd_call
from lvdgs_torch.core import lie as tlie
from lvdgs_torch.core.camera import Intrinsics
from lvdgs_torch.ops import rasterizer as tr
from lvdgs_torch.ops import rasterizer_cuda as rc
from torch_parity import make_scene_np, normalized_close, to_np, to_torch

INTR_J = JIntrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
INTR = Intrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
NTX, NTY, TG = 4, 3, 4
CFG_J = jr.RenderConfig(tile_size=16, max_per_tile=64, gaussian_chunk=8, tile_chunk=16,
                        use_pallas=True, tile_group=TG, use_packed=False)
CFG = tr.RenderConfig(tile_size=16, max_per_tile=64, tile_chunk=16, tile_group=TG)
# the reference's packed configurations (tests/test_rasterizer_pallas.py)
PACKED = {
    "packed": dict(use_packed=True, slot_budget_per_tile=64),
    "tight": dict(use_packed=True, slot_budget_per_tile=32),
    "feedback": dict(use_packed=True, slot_budget_per_tile=64, saturation_feedback=True),
}


def _cfgs(name, **kw):
    return (dataclasses.replace(CFG_J, **PACKED[name], **kw),
            dataclasses.replace(CFG, **PACKED[name], **kw))


def _dense_bins(scene, R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32), margin=0.0):
    """The reference's projection and dense bins of a NumPy scene."""
    p = {k: jnp.asarray(v) for k, v in scene.items()}
    n = p["means"].shape[0]
    active = jnp.ones((n,), bool)
    proj = jr.project_gaussians(p["means"], p["quats"], p["log_scales"], active, jnp.asarray(R),
                                jnp.asarray(t), INTR_J)
    tile_idx, slot_valid = jr.bin_gaussians(
        proj["mean2d"], proj["radius"], proj["depth"], proj["valid"], margin,
        ntx=NTX, nty=NTY, tile_size=16, max_per_tile=64, tile_chunk=16, use_approx_topk=False)
    return p, active, proj, tile_idx, slot_valid


def _pair_bins(jpb):
    """The reference's PackedBins as the port's."""
    return tr.PackedBins(gid=torch.tensor(np.asarray(jpb.gid)).long(),
                         **{f: torch.tensor(np.asarray(getattr(jpb, f)))
                            for f in ("cg", "k0", "kalloc", "tids", "inv")})


def _assert_bins_equal(tpb, jpb):
    for f in tr.PackedBins._fields:
        np.testing.assert_array_equal(to_np(getattr(tpb, f)), np.asarray(getattr(jpb, f)), err_msg=f)


def _two_cluster_np():
    """The reference's two-cluster scene (tests/test_rasterizer_pallas.py):
    an opaque wall with dead filler behind it in tile row 0, a translucent
    cluster in row 2."""
    rng = np.random.default_rng(11)

    def cluster(n, px0, px1, py0, py1, z, op, scale):
        px = rng.uniform(px0, px1, size=n)
        py = rng.uniform(py0, py1, size=n)
        zz = z + rng.uniform(0, 1.0, size=n)
        means = np.stack([(px - INTR.cx) / INTR.fx * zz, (py - INTR.cy) / INTR.fy * zz, zz], 1)
        return {"means": means, "features_dc": rng.normal(size=(n, 3)) * 0.5,
                "log_scales": np.full((n, 3), scale), "quats": rng.normal(size=(n, 4)),
                "logit_opacities": np.full((n,), op)}

    a_front = cluster(128, 10.0, 38.0, -8.0, 24.0, 4.0, 6.0, -1.9)
    a_back = cluster(136, 10.0, 38.0, -8.0, 24.0, 6.0, 3.5, -1.9)
    b = cluster(100, 10.0, 38.0, 26.0, 54.0, 4.0, -2.6, -2.3)
    return {k: np.concatenate([a_front[k], a_back[k], b[k]], 0).astype(np.float32) for k in a_front}


# ---------------------------------------------------------------------------
# pack_bins, saturation_caps


@pytest.mark.parametrize("budget,sort", [(32, False), (64, False), (48, True)],
                         ids=["binding", "non-binding", "sorted-with-caps"])
def test_pack_bins_matches_reference(budget, sort):
    scene = make_scene_np(150, seed=5)
    scene["means"][:, :2] *= 0.3  # deep central tiles, so a 32-slot budget binds
    _, _, _, tile_idx, slot_valid = _dense_bins(scene)
    C = scene["means"].shape[0]
    cap = None
    if sort:
        cap = np.random.default_rng(3).integers(-1, 70, NTX * NTY).astype(np.int32)
    jpb = jr.pack_bins(tile_idx, slot_valid, C, tile_group=TG, slot_budget_per_tile=budget,
                       tile_cap=None if cap is None else jnp.asarray(cap), sort_by_depth=sort)
    tpb = tr.pack_bins(torch.tensor(np.asarray(tile_idx)).long(), torch.tensor(np.asarray(slot_valid)),
                       C, tile_group=TG, slot_budget_per_tile=budget,
                       tile_cap=None if cap is None else torch.tensor(cap), sort_by_depth=sort)
    _assert_bins_equal(tpb, jpb)
    counts = np.asarray(slot_valid).sum(1)
    binds = (np.asarray(jpb.kalloc)[:NTX * NTY] < counts).any()
    assert binds == (budget == 32 or sort)


def test_saturation_caps_match_reference():
    scene = _two_cluster_np()
    _, _, _, tile_idx, slot_valid = _dense_bins(scene)
    C = scene["means"].shape[0]
    jpb = jr.pack_bins(tile_idx, slot_valid, C, tile_group=TG, slot_budget_per_tile=64)
    rng = np.random.default_rng(4)
    wmax = rng.integers(0, 400, size=np.asarray(jpb.gid).shape).astype(np.int32)
    wmax[rng.uniform(size=wmax.shape) < 0.5] = 0
    for tol in (1.0 / 255.0, 0.05):
        caps_j = jr.saturation_caps(jpb, jnp.asarray(wmax), NTX * NTY, tile_group=TG,
                                    max_per_tile=64, tol=tol)
        caps_t = tr.saturation_caps(_pair_bins(jpb), torch.tensor(wmax), NTX * NTY, tile_group=TG,
                                    max_per_tile=64, tol=tol)
        np.testing.assert_array_equal(to_np(caps_t), np.asarray(caps_j))
    assert (np.asarray(caps_j) < 64).any() and (np.asarray(caps_j) == 64).any()


# ---------------------------------------------------------------------------
# the plain packed kernels against Pallas


@pytest.fixture(scope="module")
def packed_block():
    """A depth-sorted, capped packed block of a real scene: (tp, bins) for
    both packages. Every packed block of this file has 6 chunks (the
    reference compiles its interpret-mode kernels once per shape)."""
    scene = make_scene_np(150, seed=7)
    scene["means"][:, :2] *= 0.5
    p, active, proj, tile_idx, slot_valid = _dense_bins(scene)
    C = scene["means"].shape[0]
    cap = np.random.default_rng(8).integers(20, 64, NTX * NTY).astype(np.int32)
    jpb = jr.pack_bins(tile_idx, slot_valid, C, tile_group=TG, slot_budget_per_tile=64,
                       tile_cap=jnp.asarray(cap), sort_by_depth=True)
    colors = jnp.clip(0.5 + 0.28209479177387814 * p["features_dc"], 0.0, 1.0)
    opac = jax.nn.sigmoid(p["logit_opacities"])
    pad = lambda a: jnp.concatenate([a, jnp.zeros((1,) + a.shape[1:], a.dtype)], 0)  # noqa: E731
    fields = jnp.concatenate([pad(proj["mean2d"]), pad(proj["conic"]), pad(colors),
                              pad(proj["depth"][:, None]), pad(opac[:, None])], axis=1)
    return fields[jpb.gid], jpb


def _jax_fwd(tp, jpb, **kw):
    if not kw.get("probe_wmax"):
        kw["bf16"] = False  # as pallas_blend_packed passes it, so the compile is shared
    return _packed_fwd_call(tp, jpb.cg, jpb.k0, jnp.zeros((1,), jnp.int32), jpb.tids, ntx=NTX,
                            nty=NTY, tile_size=16, tile_group=TG, n_groups=3, interpret=True, **kw)


def _torch_fwd(tp, jpb, **kw):
    tpb = _pair_bins(jpb)
    return rc.packed_blend_forward(torch.tensor(np.asarray(tp)), tpb.cg, tpb.k0,
                                   torch.zeros(1, dtype=torch.int32), tpb.tids, 3, NTX, **kw)


@pytest.mark.parametrize("flags", [dict(with_nt=True), dict(with_nt=False), dict(probe_wmax=True)],
                         ids=["with_nt", "no_nt", "probe_wmax"])
def test_plain_packed_forward_matches_pallas(packed_block, flags):
    tp, jpb = packed_block
    acc_j, trans_j, nt_j = _jax_fwd(tp, jpb, **flags)
    acc, trans, nt, march = _torch_fwd(tp, jpb, **flags)
    G = 3  # row G is unwritten by Pallas
    np.testing.assert_allclose(to_np(acc)[:G, :3], np.asarray(acc_j)[:G, :3], atol=3e-4)
    np.testing.assert_allclose(to_np(acc)[:G, 3], np.asarray(acc_j)[:G, 3], atol=3e-3)
    np.testing.assert_allclose(to_np(trans)[:G], np.asarray(trans_j)[:G], atol=3e-4)
    nt, nt_j = to_np(nt), np.asarray(nt_j)
    if flags.get("probe_wmax"):
        assert np.abs(nt - nt_j).max() <= 1 and (nt_j > 0).sum() > 100
    elif flags["with_nt"]:
        assert np.mean(nt == nt_j) >= 0.97 and (nt_j > 0).sum() > 100
    else:
        assert not nt.any()
    np.testing.assert_array_equal(to_np(acc)[G], 0.0)
    np.testing.assert_array_equal(to_np(trans)[G], 1.0)
    np.testing.assert_array_equal(to_np(march)[G], 0)


def test_plain_packed_backward_matches_pallas(packed_block):
    tp, jpb = packed_block
    acc_j, trans_j, _ = _jax_fwd(tp, jpb, with_nt=True)
    rng = np.random.default_rng(9)
    dacc = rng.normal(size=np.asarray(acc_j).shape).astype(np.float32)
    dtrans = rng.normal(size=np.asarray(trans_j).shape).astype(np.float32)
    dtp_j = _packed_bwd_call(tp, jpb.cg, jpb.k0, jnp.zeros((1,), jnp.int32), jpb.tids, acc_j,
                             trans_j, jnp.asarray(dacc), jnp.asarray(dtrans), ntx=NTX, nty=NTY,
                             tile_size=16, tile_group=TG, n_groups=3, interpret=True, bf16=False)
    tpb = _pair_bins(jpb)
    tpt = torch.tensor(np.asarray(tp))
    goff = torch.zeros(1, dtype=torch.int32)
    acc, trans, _, march = rc.packed_blend_forward(tpt, tpb.cg, tpb.k0, goff, tpb.tids, 3, NTX)
    dtp = rc.packed_blend_backward(tpt, tpb.cg, tpb.k0, goff, tpb.tids, march, acc, trans,
                                   torch.tensor(dacc), torch.tensor(dtrans), 3, NTX)
    for f in range(rc.NF):
        normalized_close(np.asarray(dtp_j)[..., f], dtp[..., f], 2e-3)


def test_packed_forward_equals_dense_when_budget_does_not_bind():
    """Unsorted grouping and a budget that does not bind: the packed blend
    holds the dense lists' slots in the same order, so its acc and trans
    equal the dense blend's bit for bit (the identity the reference states
    for its kernels)."""
    scene = make_scene_np(120, seed=1)
    p, active, proj, tile_idx, slot_valid = _dense_bins(scene)
    pt = to_torch(scene)
    proj_t = {k: torch.tensor(np.asarray(v)) for k, v in proj.items()}
    colors, opac = tr._blend_inputs(pt, torch.ones(120, dtype=torch.bool))
    fields = tr._fields(proj_t["mean2d"], proj_t["conic"], colors, opac, proj_t["depth"])
    tile_idx_t = torch.tensor(np.asarray(tile_idx)).long()
    slot_valid_t = torch.tensor(np.asarray(slot_valid))
    pb = tr.pack_bins(tile_idx_t, slot_valid_t, 120, tile_group=TG, slot_budget_per_tile=64)
    acc_p, trans_p, nt_p, _ = rc.packed_blend_forward(tr._gather_rows(fields, pb.gid), pb.cg,
                                                      pb.k0, torch.zeros(1, dtype=torch.int32),
                                                      pb.tids, 3, NTX)
    tp = tr._gather_rows(fields, tile_idx_t.clamp(max=120).T)
    acc_d, trans_d, nt_d, _ = rc.blend_forward(tp, slot_valid_t.sum(1, dtype=torch.int32), NTX)
    assert torch.equal(rc._from_group_major(acc_p, 3), acc_d)
    assert torch.equal(rc._from_group_major(trans_p, 3), trans_d)
    assert int(nt_p.sum()) == int(nt_d.sum()) > 0


# ---------------------------------------------------------------------------
# the packed rasterizer


@pytest.fixture(scope="module", params=["packed", "tight", "feedback"])
def packed_renders(request):
    """Forward and gradients of one loss through both rasterizers under the
    reference's packed configurations. "tight" packs 128-slot lists into a
    64-slot budget that binds on the central tiles."""
    kw = dict(max_per_tile=128) if request.param == "tight" else {}
    if request.param == "tight":
        cfg_j, cfg_t = _cfgs("packed", **kw)
    else:
        cfg_j, cfg_t = _cfgs(request.param)
    scene = make_scene_np(60, seed=2)
    if request.param == "tight":
        scene = make_scene_np(160, seed=5)
        scene["means"][:, :2] *= 0.15
    n = scene["means"].shape[0]

    def loss_j(p):
        out = jr.rasterize(p, jnp.ones((n,), bool), jnp.eye(3), jnp.zeros(3), INTR_J, cfg_j)
        return ((out.image - 0.3) ** 2).mean() + 0.05 * (out.depth**2).mean() + 0.1 * out.opacity.mean(), out

    (_, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)({k: jnp.asarray(v) for k, v in scene.items()})
    pt = to_torch(scene, requires_grad=True)
    out_t = tr.rasterize(pt, torch.ones(n, dtype=torch.bool), torch.eye(3), torch.zeros(3), INTR, cfg_t)
    (((out_t.image - 0.3) ** 2).mean() + 0.05 * (out_t.depth**2).mean() + 0.1 * out_t.opacity.mean()).backward()
    return request.param, cfg_t, out_j, g_j, out_t, pt, scene


def test_rasterize_packed_matches_reference(packed_renders):
    name, cfg_t, out_j, _, out_t, _, scene = packed_renders
    np.testing.assert_allclose(to_np(out_t.image), np.asarray(out_j.image), atol=3e-4)
    np.testing.assert_allclose(to_np(out_t.depth), np.asarray(out_j.depth), atol=3e-3)
    np.testing.assert_allclose(to_np(out_t.opacity), np.asarray(out_j.opacity), atol=3e-4)
    nt_t, nt_j = to_np(out_t.n_touched), np.asarray(out_j.n_touched)
    assert np.mean(nt_t == nt_j) > 0.97 and nt_j.sum() > 0
    if name == "tight":
        # the budget binds: the packed render differs from the exact one
        exact = tr.rasterize(to_torch(scene), torch.ones(160, dtype=torch.bool), torch.eye(3),
                             torch.zeros(3), INTR, dataclasses.replace(cfg_t, use_packed=False))
        err = float((exact.image - out_t.image.detach()).abs().mean())
        assert 0 < err < 0.02, err


@pytest.mark.parametrize("field", ["means", "log_scales", "logit_opacities", "features_dc"])
def test_rasterize_packed_gradients_match_reference(packed_renders, field):
    _, _, _, g_j, _, pt, _ = packed_renders
    normalized_close(np.asarray(g_j[field]), pt[field].grad, 2e-3)


def test_saturation_feedback_identity_when_unsaturated():
    """With nothing saturated the probe does not change what is blended:
    the feedback render equals the plain packed render bit for bit."""
    scene = make_scene_np(60, seed=6)
    pt, act = to_torch(scene), torch.ones(60, dtype=torch.bool)
    a = tr.rasterize(pt, act, torch.eye(3), torch.zeros(3), INTR, _cfgs("packed")[1])
    b = tr.rasterize(pt, act, torch.eye(3), torch.zeros(3), INTR, _cfgs("feedback")[1])
    assert torch.equal(a.image, b.image) and torch.equal(a.depth, b.depth)


def test_saturation_feedback_reclaims_dead_depth():
    """The probe caps the opaque-wall tiles well below their binned depth
    (the fillers behind the wall are dead), leaves the translucent tiles'
    allocation, and keeps the render essentially exact."""
    scene = _two_cluster_np()
    pt = to_torch(scene)
    act = torch.ones(scene["means"].shape[0], dtype=torch.bool)
    full = dataclasses.replace(CFG, max_per_tile=224, use_packed=True, slot_budget_per_tile=224)
    full_fb = dataclasses.replace(full, saturation_feedback=True)
    ka_u = to_np(tr.prepare_bins(pt, act, torch.eye(3), torch.zeros(3), INTR, full).kalloc)
    bf = tr.prepare_bins(pt, act, torch.eye(3), torch.zeros(3), INTR, full_fb)
    ka_f = to_np(bf.kalloc)
    assert ka_u[1] >= 180, ka_u
    assert ka_f[1] <= ka_u[1] - 64, (ka_u[1], ka_f[1])
    assert ka_f[9] >= ka_u[9] - 32, (ka_u[9], ka_f[9])
    exact = tr.rasterize(pt, act, torch.eye(3), torch.zeros(3), INTR,
                         dataclasses.replace(full, use_packed=False))
    fb = tr.rasterize(pt, act, torch.eye(3), torch.zeros(3), INTR, full_fb, bins=bf)
    assert bool(torch.isfinite(fb.image).all())
    assert float((fb.image - exact.image).abs().mean()) < 2e-3


# ---------------------------------------------------------------------------
# pose linearisation


@pytest.fixture(scope="module")
def lin_scene():
    scene = make_scene_np(120, seed=9)
    cfg_j, cfg_t = _cfgs("packed")
    R0 = np.asarray(jlie.so3_exp(jnp.array([0.02, -0.01, 0.015])), np.float32)
    t0 = np.array([0.03, -0.02, 0.05], np.float32)
    pj = {k: jnp.asarray(v) for k, v in scene.items()}
    bins_j = jr.prepare_bins(pj, jnp.ones((120,), bool), jnp.asarray(R0), jnp.asarray(t0), INTR_J,
                             cfg_j, margin=4.0)
    gt = np.asarray(jr.rasterize(pj, jnp.ones((120,), bool), jnp.asarray(R0), jnp.asarray(t0), INTR_J,
                                 cfg_j).image) * 0.8
    return scene, cfg_j, cfg_t, R0, t0, bins_j, gt


def test_pose_lin_matches_autodiff(lin_scene):
    """rasterize_pose_lin equals the plain packed render in value and in tau
    gradient (it only restructures the backward), at tau = 0 and away."""
    scene, _, cfg_t, R0, t0, bins_j, gt = lin_scene
    pt, act = to_torch(scene), torch.ones(120, dtype=torch.bool)
    bins = _pair_bins(bins_j)
    R0, t0, gt = torch.tensor(R0), torch.tensor(t0), torch.tensor(gt)

    def loss_ad(tau):
        R, t = tlie.apply_delta(R0, t0, tau)
        out = tr.rasterize(pt, act, R, t, INTR, cfg_t, bins=bins, need_n_touched=False)
        return (out.opacity * (out.image - gt).abs()).mean()

    def loss_lin(tau):
        out = tr.rasterize_pose_lin(pt, act, R0, t0, tau, INTR, cfg_t, bins)
        return (out.opacity * (out.image - gt).abs()).mean()

    for tau0 in (np.zeros(6), np.array([0.003, -0.002, 0.004, 0.001, -0.001, 0.002])):
        vals, grads = [], []
        for fn in (loss_ad, loss_lin):
            tau = torch.tensor(tau0, dtype=torch.float32, requires_grad=True)
            v = fn(tau)
            v.backward()
            vals.append(float(v))
            grads.append(tau.grad)
        np.testing.assert_allclose(vals[1], vals[0], rtol=1e-5)
        normalized_close(grads[0], grads[1], 5e-4)


def test_rasterize_lin_and_pose_lin_match_reference(lin_scene):
    """Value and tau gradient of the period-linearised render (at a drift
    away from the linearisation pose) and of rasterize_pose_lin, each
    against the reference's."""
    scene, cfg_j, cfg_t, R0, t0, bins_j, gt = lin_scene
    pj, actj = {k: jnp.asarray(v) for k, v in scene.items()}, jnp.ones((120,), bool)
    pt, act = to_torch(scene), torch.ones(120, dtype=torch.bool)
    bins = _pair_bins(bins_j)
    drift = np.array([0.002, -0.001, 0.003, 0.001, 0.0005, -0.001], np.float32)

    tpj_j, _ = jr.pose_lin_gather(pj, actj, jnp.asarray(R0), jnp.asarray(t0), INTR_J, cfg_j, bins_j)
    tpj_t, _ = tr.pose_lin_gather(pt, act, torch.tensor(R0), torch.tensor(t0), INTR, cfg_t, bins)
    np.testing.assert_allclose(to_np(tpj_t)[..., 0], np.asarray(tpj_j)[..., 0], rtol=1e-5, atol=1e-4)
    normalized_close(np.asarray(tpj_j)[..., 1:], tpj_t[..., 1:], 1e-4)

    def lj(tau):
        out = jr.rasterize_lin(tpj_j, jnp.asarray(drift) + tau, INTR_J, cfg_j, bins_j)
        return (out.opacity * jnp.abs(out.image - gt)).mean()

    def lj_pose(tau):
        out = jr.rasterize_pose_lin(pj, actj, jnp.asarray(R0), jnp.asarray(t0), tau, INTR_J, cfg_j, bins_j)
        return (out.opacity * jnp.abs(out.image - gt)).mean()

    gtt = torch.tensor(gt)
    for ref_fn, port_fn, tau0 in (
        (lj, lambda tau: tr.rasterize_lin(tpj_t, torch.tensor(drift) + tau, INTR, cfg_t, bins), np.zeros(6)),
        (lj_pose, lambda tau: tr.rasterize_pose_lin(pt, act, torch.tensor(R0), torch.tensor(t0), tau, INTR,
                                                    cfg_t, bins), drift),
    ):
        v_j, g_j = jax.value_and_grad(ref_fn)(jnp.asarray(tau0, jnp.float32))
        tau = torch.tensor(tau0, dtype=torch.float32, requires_grad=True)
        out = port_fn(tau)
        v_t = (out.opacity * (out.image - gtt).abs()).mean()
        v_t.backward()
        np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-4)
        normalized_close(np.asarray(g_j), tau.grad, 2e-3)


# ---------------------------------------------------------------------------
# densify's visibility carry


def test_densify_and_prune_carries_visibility():
    """aux_vis through clone, split and prune, against the reference: a
    child's column is its parent's, pruned slots are cleared."""
    from lvdgs_tpu.gaussian import model as jgm
    from lvdgs_torch.gaussian import model as tgm
    from torch_parity import assert_map_matches, map_to_torch

    cap, n = 512, 300
    rng = np.random.default_rng(21)
    scene = make_scene_np(n, seed=21)
    scene["log_scales"] = rng.uniform(-4.0, -1.0, size=(n, 3)).astype(np.float32)
    jmap = jgm.create_map(cap)
    jmap = jmap.replace(**{k: getattr(jmap, k).at[:n].set(jnp.asarray(v)) for k, v in scene.items()},
                        active=jnp.arange(cap) < n,
                        grad_accum=jnp.asarray(rng.uniform(0, 1.2e-3, cap), jnp.float32),
                        grad_denom=jnp.asarray(rng.integers(0, 4, cap), jnp.float32),
                        max_radii2d=jnp.asarray(rng.uniform(0, 30, cap), jnp.float32))
    vis = rng.uniform(size=(3, cap)) < 0.4
    key = jax.random.PRNGKey(5)
    split_eps = np.stack([np.asarray(jax.random.normal(k, (cap, 3))) for k in jax.random.split(key)])
    kw = dict(grad_threshold=2e-4, min_opacity=0.45, extent=6.0, max_screen_size=20.0,
              percent_dense=0.01)
    jmap2, vis_j = jgm.densify_and_prune(jmap, key, aux_vis=jnp.asarray(vis), **kw)
    tmap = map_to_torch(jmap)
    vis_in = torch.tensor(vis)
    vis_t = tgm.densify_and_prune(tmap, torch.tensor(split_eps), aux_vis=vis_in, **kw)
    assert_map_matches(tmap, jmap2, atol=1e-5)
    np.testing.assert_array_equal(to_np(vis_t), np.asarray(vis_j))
    assert torch.equal(vis_in, torch.tensor(vis))  # the argument is not changed
    grown = np.asarray(jmap2.active) & ~np.asarray(jmap.active)
    assert grown.any() and np.asarray(vis_j)[:, grown].any()
    assert tgm.densify_and_prune(map_to_torch(jmap), torch.tensor(split_eps), **kw) is None
