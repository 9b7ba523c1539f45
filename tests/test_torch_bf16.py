"""The bf16 packed blend of lvdgs_torch (RenderConfig.blend_bf16) against
lvdgs_tpu on the CPU: the plain versions of B4-bf16 and B5-bf16 against the
Pallas kernels with bf16=True in interpret mode, the port's copy of the
reference's bf16-against-f32 quality bar, and the period-linearised render
(tests/test_torch_bf16_slam.py has the pose-linearised render, tracking and
the SLAM loop).

The reference's bf16 programs are compiled with XLA's excess precision off
(`STRICT`): by default XLA on the CPU keeps float32 between the bf16
operations it fuses, so the interpret-mode kernel rounds at fewer points
than its source (and the TPU) does, and differs from it by about 1e-3 in
the image. With one rounding per bf16 operation, as written, the plain
versions agree with it to float32 rounding, and the tolerances are those of
tests/test_torch_packed.py: image 3e-4, depth 3e-3, normalised gradients
2e-3. Every packed block has 6 chunks, as there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_tpu.ops import rasterizer as jr
from lvdgs_tpu.ops.rasterizer_pallas import _packed_bwd_call, _packed_fwd_call
from lvdgs_torch.ops import rasterizer as tr
from lvdgs_torch.ops import rasterizer_cuda as rc
from test_torch_packed import (  # noqa: F401  (packed_block and lin_scene are fixtures)
    INTR, INTR_J, NTX, NTY, TG, _pair_bins, lin_scene, packed_block,
)
from torch_parity import make_scene_np, normalized_close, to_np, to_torch

STRICT = {"xla_allow_excess_precision": False}
# the reference's test_blend_bf16_close_to_f32 configuration: 64 slots per
# tile, packed at a budget that does not bind, 4 tiles per group
CFG_PACKED = tr.RenderConfig(max_per_tile=64, tile_chunk=16, tile_group=TG, use_packed=True,
                             slot_budget_per_tile=64)


def strict(fn, *args):
    """fn(*args) compiled with one rounding per bf16 operation."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _ref_fwd(tp, jpb, with_nt):
    return strict(lambda tp, cg, k0, goff, tids: _packed_fwd_call(
        tp, cg, k0, goff, tids, ntx=NTX, nty=NTY, tile_size=16, tile_group=TG, n_groups=3,
        interpret=True, with_nt=with_nt, bf16=True), tp, jpb.cg, jpb.k0, jnp.zeros((1,), jnp.int32),
        jpb.tids)


def _port_args(tp, jpb):
    tpb = _pair_bins(jpb)
    return torch.tensor(np.asarray(tp)), tpb.cg, tpb.k0, torch.zeros(1, dtype=torch.int32), tpb.tids


@pytest.mark.parametrize("with_nt", [True, False], ids=["with_nt", "no_nt"])
def test_plain_packed_bf16_forward_matches_pallas(packed_block, with_nt):
    tp, jpb = packed_block
    acc_j, trans_j, nt_j = _ref_fwd(tp, jpb, with_nt)
    acc, trans, nt, _march = rc.packed_blend_forward_bf16(*_port_args(tp, jpb), 3, NTX,
                                                          with_nt=with_nt)
    G = 3  # row G is unwritten by Pallas
    np.testing.assert_allclose(to_np(acc)[:G, :3], np.asarray(acc_j)[:G, :3], atol=3e-4)
    np.testing.assert_allclose(to_np(acc)[:G, 3], np.asarray(acc_j)[:G, 3], atol=3e-3)
    np.testing.assert_allclose(to_np(trans)[:G], np.asarray(trans_j)[:G], atol=3e-4)
    nt, nt_j = to_np(nt), np.asarray(nt_j)
    if with_nt:
        assert np.mean(nt == nt_j) >= 0.97 and (nt_j > 0).sum() > 100
    else:
        assert not nt.any()
    # the bf16 weights are not the float32 ones: this block tells them apart
    acc32 = rc.packed_blend_forward(*_port_args(tp, jpb), 3, NTX, with_nt=with_nt)[0]
    assert float((acc32 - acc)[:G, :3].abs().max()) > 10 * 3e-4


def test_plain_packed_bf16_backward_matches_pallas(packed_block):
    tp, jpb = packed_block
    acc_j, trans_j, _ = _ref_fwd(tp, jpb, False)
    rng = np.random.default_rng(9)
    dacc = rng.normal(size=np.asarray(acc_j).shape).astype(np.float32)
    dtrans = rng.normal(size=np.asarray(trans_j).shape).astype(np.float32)
    dtp_j = strict(lambda tp, cg, k0, goff, tids, acc, trans, dacc, dtrans: _packed_bwd_call(
        tp, cg, k0, goff, tids, acc, trans, dacc, dtrans, ntx=NTX, nty=NTY, tile_size=16,
        tile_group=TG, n_groups=3, interpret=True, bf16=True), tp, jpb.cg, jpb.k0,
        jnp.zeros((1,), jnp.int32), jpb.tids, acc_j, trans_j, jnp.asarray(dacc), jnp.asarray(dtrans))
    args = _port_args(tp, jpb)
    acc, trans, _, march = rc.packed_blend_forward_bf16(*args, 3, NTX, with_nt=False)
    dtp = rc.packed_blend_backward_bf16(*args, march, acc, trans, torch.tensor(dacc),
                                        torch.tensor(dtrans), 3, NTX)
    for f in range(rc.NF):
        normalized_close(np.asarray(dtp_j)[..., f], dtp[..., f], 2e-3)


def test_blend_bf16_close_to_f32():
    """The port's copy of tests/test_rasterizer_pallas.py's bar for bf16
    weight math: forward within bf16 noise of float32 (alpha relative error
    ~2^-8), gradients directionally equal."""
    cfg_bf = dataclasses.replace(CFG_PACKED, blend_bf16=True)
    scene = make_scene_np(120, seed=11)
    act, eye, zero = torch.ones(120, dtype=torch.bool), torch.eye(3), torch.zeros(3)
    pt = to_torch(scene)
    img_a = to_np(tr.rasterize(pt, act, eye, zero, INTR, CFG_PACKED).image)
    img_b = to_np(tr.rasterize(pt, act, eye, zero, INTR, cfg_bf).image)
    assert np.abs(img_a - img_b).max() < 0.02
    mse = np.mean((img_a - img_b) ** 2)
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 45.0
    assert mse > 0  # the bf16 path ran

    grads = []
    for cfg in (CFG_PACKED, cfg_bf):
        p = to_torch(scene, requires_grad=True)
        out = tr.rasterize(p, act, eye, zero, INTR, cfg, need_n_touched=False)
        (out.opacity * (out.image - 0.4).abs()).mean().backward()
        grads.append(p)
    for field in ["means", "log_scales", "logit_opacities", "features_dc"]:
        va, vb = (to_np(g[field].grad).ravel() for g in grads)
        cos = np.dot(va, vb) / (np.linalg.norm(va) * np.linalg.norm(vb) + 1e-12)
        assert cos > 0.999, f"{field}: grad cosine {cos}"


def count_plain_calls(monkeypatch, calls: dict) -> None:
    """Count the packed plain versions' calls in `calls`, keyed by (name,
    bf16, probe_wmax)."""
    for name in ("packed_blend_forward_plain", "packed_blend_backward_plain"):
        fn = getattr(rc, name)

        def wrapped(*a, fn=fn, name=name, **kw):
            key = (name, kw.get("bf16", False), kw.get("probe_wmax", False))
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(rc, name, wrapped)


def check_lin_render(lin_scene, monkeypatch, pose: bool) -> None:
    """Value and tau gradient with blend_bf16 of the period-linearised
    render at a drift away from the linearisation pose (or, with `pose`,
    of rasterize_pose_lin), against the reference's; both bf16 kernels run
    on the port's side."""
    scene, cfg_j, cfg_t, R0, t0, bins_j, gt = lin_scene
    cfg_j = dataclasses.replace(cfg_j, blend_bf16=True)
    cfg_t = dataclasses.replace(cfg_t, blend_bf16=True)
    pj, actj = {k: jnp.asarray(v) for k, v in scene.items()}, jnp.ones((120,), bool)
    pt, act = to_torch(scene), torch.ones(120, dtype=torch.bool)
    bins = _pair_bins(bins_j)
    drift = np.array([0.002, -0.001, 0.003, 0.001, 0.0005, -0.001], np.float32)
    if pose:
        def ref_fn(tau):
            out = jr.rasterize_pose_lin(pj, actj, jnp.asarray(R0), jnp.asarray(t0), tau, INTR_J, cfg_j,
                                        bins_j)
            return (out.opacity * jnp.abs(out.image - gt)).mean()

        def port_fn(tau):
            return tr.rasterize_pose_lin(pt, act, torch.tensor(R0), torch.tensor(t0), tau, INTR, cfg_t,
                                         bins)
        tau0 = drift
    else:
        tpj_j, _ = jr.pose_lin_gather(pj, actj, jnp.asarray(R0), jnp.asarray(t0), INTR_J, cfg_j, bins_j)
        tpj_t, _ = tr.pose_lin_gather(pt, act, torch.tensor(R0), torch.tensor(t0), INTR, cfg_t, bins)

        def ref_fn(tau):
            out = jr.rasterize_lin(tpj_j, jnp.asarray(drift) + tau, INTR_J, cfg_j, bins_j)
            return (out.opacity * jnp.abs(out.image - gt)).mean()

        def port_fn(tau):
            return tr.rasterize_lin(tpj_t, torch.tensor(drift) + tau, INTR, cfg_t, bins)
        tau0 = np.zeros(6)

    v_j, g_j = strict(jax.value_and_grad(ref_fn), jnp.asarray(tau0, jnp.float32))
    calls = {}
    count_plain_calls(monkeypatch, calls)
    tau = torch.tensor(tau0, dtype=torch.float32, requires_grad=True)
    out = port_fn(tau)
    v_t = (out.opacity * (out.image - torch.tensor(gt)).abs()).mean()
    v_t.backward()
    np.testing.assert_allclose(v_t.item(), float(v_j), rtol=1e-4)
    normalized_close(np.asarray(g_j), tau.grad, 2e-3)
    assert calls == {("packed_blend_forward_plain", True, False): 1,
                     ("packed_blend_backward_plain", True, False): 1}


def test_rasterize_lin_bf16_matches_reference(lin_scene, monkeypatch):
    check_lin_render(lin_scene, monkeypatch, pose=False)
