"""The CUDA kernels (the dense and packed blend, the packed blend's bf16
variants, the resident-table gather and scatter) against their plain
PyTorch versions.

The tests marked `cuda` need the card and skip without one. This file
imports neither JAX nor the reference package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: the forward and median kernels round every operation as the
plain versions do (nvcc -fmad=false) and agree to 1e-5; the backward sums
each slot's 256 pixel terms in another order and agrees to 1e-5 of each
field's largest gradient. The packed kernels are held to the same
tolerances, with their per-slot counts and probe weights equal; the bf16
forward rounds at the same points as its plain version (one rounding per
bf16 operation) and is held bit for bit. The rasterizer's gradients also
pass through the scatter-add of the slot gather, whose atomic adds run in
any order, and are held to 1e-3 of each field's largest gradient. The
resident gather adds in its plain version's order and is held bit for bit,
also at the edges of its launch shape (one lane or the most per group, one
slot, none, slot counts that end inside a chunk or past one staging pass);
the resident scatter adds with atomics, in any order, and is held to 1e-5
of the table's largest magnitude, also at the edges of its launch shape
(one row taking every slot, counts that end inside a thread's or a
block's share, no group).
"""
import numpy as np
import pytest
import torch

from lvdgs_torch.core.camera import Intrinsics
from lvdgs_torch.ops import rasterizer as tr
from lvdgs_torch.ops import rasterizer_cuda as rc
from lvdgs_torch.ops import resident_cuda as rs
from lvdgs_torch.tools import perf_resident as pr
from torch_parity import cuda_device, make_scene_np  # noqa: F401


def _random_block(K, T, seed, device, ntx=8):
    """Random depth-sorted slot lists with ragged counts (some empty, some
    full)."""
    g = np.random.default_rng(seed)
    tid = np.arange(T)
    cx = (tid % ntx) * 16 + 8.0
    cy = (tid // ntx) * 16 + 8.0
    tp = np.zeros((K, T, rc.NF), np.float32)
    tp[..., 0] = cx[None] + g.normal(0, 8, (K, T))
    tp[..., 1] = cy[None] + g.normal(0, 8, (K, T))
    s = g.uniform(0.02, 0.3, (K, T))
    tp[..., 2] = s
    tp[..., 3] = g.uniform(-0.5, 0.5, (K, T)) * s
    tp[..., 4] = s
    tp[..., 5:8] = g.uniform(0, 1, (K, T, 3))
    tp[..., 8] = np.sort(g.uniform(1, 10, (K, T)), axis=0)
    tp[..., 9] = g.uniform(0.05, 1.0, (K, T))  # some reach the 0.99 clamp
    counts = g.integers(0, K + 1, T).astype(np.int32)
    counts[:2] = (0, K)
    return torch.tensor(tp, device=device), torch.tensor(counts, device=device), ntx


def _rel_close(a, b, tol):
    scale = b.abs().amax(dim=tuple(range(b.dim() - 1)), keepdim=True) + 1e-12
    torch.testing.assert_close(a / scale, b / scale, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("K,T", [(64, 24), (256, 160)])
def test_kernels_match_plain(cuda_device, K, T):
    tp, counts, ntx = _random_block(K, T, K + T, cuda_device)
    acc, trans, nt, march = rc.blend_forward(tp, counts, ntx)
    acc_p, trans_p, nt_p, march_p = rc.blend_forward_plain(tp, counts, ntx)
    torch.testing.assert_close(acc, acc_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(trans, trans_p, atol=1e-5, rtol=0)
    assert torch.equal(nt, nt_p)
    assert torch.equal(march, march_p)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    dacc = torch.randn(acc.shape, device=cuda_device, generator=g)
    dtrans = torch.randn(trans.shape, device=cuda_device, generator=g)
    dtp = rc.blend_backward(tp, counts, march, acc, trans, dacc, dtrans, ntx)
    dtp_p = rc.blend_backward_plain(tp, counts, acc, trans, dacc, dtrans, ntx)
    _rel_close(dtp, dtp_p, 1e-5)
    # its per-slot sums run in a fixed order: launched again, the same bits
    assert torch.equal(rc.blend_backward(tp, counts, march, acc, trans, dacc, dtrans, ntx), dtp)
    dmed, opac = rc.median_depth(tp, counts, ntx)
    dmed_p, opac_p = rc.median_depth_plain(tp, counts, ntx)
    torch.testing.assert_close(dmed, dmed_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(opac, opac_p, atol=1e-5, rtol=0)
    torch.cuda.synchronize()


def _packed_block(T, ntx, budget, K, seed, device, sort_by_depth=True, TG=16):
    """A packed block made by pack_bins from a random dense block of depth-
    sorted slot lists (sorted grouping with random caps, or plain grouping)."""
    tp, counts, _ = _random_block(K, T, seed, "cpu", ntx)
    C = K * T
    tile_idx = torch.arange(C).reshape(T, K)  # row t * K + k of fields is tp[k, t]
    slot_valid = torch.arange(K)[None] < counts[:, None].long()
    tile_idx = torch.where(slot_valid, tile_idx, C)
    fields = torch.cat([tp.permute(1, 0, 2).reshape(C, rc.NF), torch.zeros(1, rc.NF)])
    cap = None
    if sort_by_depth:
        cap = torch.tensor(np.random.default_rng(seed).integers(0, K + 1, T), dtype=torch.int32)
    pb = tr.pack_bins(tile_idx, slot_valid, C, tile_group=TG, slot_budget_per_tile=budget,
                      tile_cap=cap, sort_by_depth=sort_by_depth)
    ptp = tr._gather_rows(fields, pb.gid).contiguous()
    G = -(-T // TG)
    return [x.to(device) for x in (ptp, pb.cg, pb.k0, torch.zeros(1, dtype=torch.int32), pb.tids)], G


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [dict(with_nt=True), dict(with_nt=False), dict(probe_wmax=True)],
                         ids=["with_nt", "no_nt", "probe_wmax"])
@pytest.mark.parametrize("T,ntx,budget,K", [(40, 8, 96, 128), (160, 16, 128, 256)])
def test_packed_kernels_match_plain(cuda_device, flags, T, ntx, budget, K):
    args, G = _packed_block(T, ntx, budget, K, T + K, cuda_device)
    acc, trans, nt, march = rc.packed_blend_forward(*args, G, ntx, **flags)
    acc_p, trans_p, nt_p, march_p = rc.packed_blend_forward_plain(*args, G, ntx, **flags)
    torch.testing.assert_close(acc, acc_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(trans, trans_p, atol=1e-5, rtol=0)
    assert torch.equal(nt, nt_p)
    assert torch.equal(march, march_p)
    assert bool(nt.any()) == (flags != dict(with_nt=False))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    dacc = torch.randn(acc.shape, device=cuda_device, generator=g)
    dtrans = torch.randn(trans.shape, device=cuda_device, generator=g)
    dtp = rc.packed_blend_backward(*args, march, acc, trans, dacc, dtrans, G, ntx)
    dtp_p = rc.packed_blend_backward_plain(*args, acc, trans, dacc, dtrans, G, ntx)
    _rel_close(dtp, dtp_p, 1e-5)
    # its per-slot sums run in a fixed order: launched again, the same bits
    assert torch.equal(rc.packed_blend_backward(*args, march, acc, trans, dacc, dtrans, G, ntx), dtp)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("with_nt", [True, False], ids=["with_nt", "no_nt"])
@pytest.mark.parametrize("T,ntx,budget,K", [(40, 8, 96, 128), (160, 16, 128, 256)])
def test_packed_bf16_kernels_match_plain(cuda_device, with_nt, T, ntx, budget, K):
    args, G = _packed_block(T, ntx, budget, K, T + K, cuda_device)
    acc, trans, nt, march = rc.packed_blend_forward_bf16(*args, G, ntx, with_nt=with_nt)
    acc_p, trans_p, nt_p, march_p = rc.packed_blend_forward_plain(*args, G, ntx, with_nt=with_nt,
                                                                  bf16=True)
    assert torch.equal(acc, acc_p) and torch.equal(trans, trans_p) and torch.equal(nt, nt_p)
    assert torch.equal(march, march_p)
    assert bool(nt.any()) == with_nt
    acc32 = rc.packed_blend_forward(*args, G, ntx, with_nt=with_nt)[0]
    assert not torch.equal(acc, acc32)  # the bf16 weights ran
    g = torch.Generator(device=cuda_device).manual_seed(1)
    dacc = torch.randn(acc.shape, device=cuda_device, generator=g)
    dtrans = torch.randn(trans.shape, device=cuda_device, generator=g)
    dtp = rc.packed_blend_backward_bf16(*args, march, acc, trans, dacc, dtrans, G, ntx)
    dtp_p = rc.packed_blend_backward_plain(*args, acc, trans, dacc, dtrans, G, ntx, bf16=True)
    _rel_close(dtp, dtp_p, 1e-5)
    assert torch.equal(rc.packed_blend_backward_bf16(*args, march, acc, trans, dacc, dtrans, G, ntx),
                       dtp)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("C,T,K,TG", [(4096, 64, 32, 8), (2**17, 1848, 256, 8)])
def test_resident_kernels_match_plain(cuda_device, C, T, K, TG):
    from lvdgs_torch.tools.perf_resident import make_inputs

    idx, fields, upd = make_inputs(C, T, K, TG, cuda_device)
    assert torch.equal(rs.resident_gather(idx, fields), rs.resident_gather_plain(idx, fields))
    out, ref = rs.resident_scatter(idx, upd, C + 1), rs.resident_scatter_plain(idx, upd, C + 1)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,G,K,TG", [
    (7, 5, 40, 1),  # one lane per group; 7 rows, so bags repeat rows; K not a multiple of 32
    (7, 3, 1, 64),  # the most lanes per group (MAX_TG); one slot
    (1000, 4, 33, 3),  # an odd lane count; one slot past a chunk of 32
    (50, 2, 1100, 2),  # more slots than one pass stages (512)
    (10, 0, 16, 8),  # no group: nothing launched
    (3, 6, 0, 4),  # no slot: zeros
])
def test_resident_gather_edge_shapes(cuda_device, rows, G, K, TG):
    """R1 at the edges of its launch shape, bit for bit its plain version's
    and its own when launched again."""
    g = np.random.default_rng(rows + G + K + TG)
    idx = torch.tensor(g.integers(0, rows, (G, K, TG)), dtype=torch.int32, device=cuda_device)
    fields = torch.tensor(g.normal(size=(rows, rs.NF)), dtype=torch.float32, device=cuda_device)
    before = rs.resident_gather.launches.count
    out = rs.resident_gather(idx, fields)
    assert out.shape == (G * TG, rs.NF)
    assert torch.equal(out, rs.resident_gather_plain(idx, fields))
    assert torch.equal(rs.resident_gather(idx, fields), out)
    assert rs.resident_gather.launches.count - before == (2 if G else 0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,G,K,TG", pr.SCATTER_EDGES)
def test_resident_scatter_edge_shapes(cuda_device, rows, G, K, TG):
    """R2 at the edges of its launch shape (one row taking every slot,
    counts that end inside a thread's or a block's share, no group), within
    1e-5 of the table's largest magnitude of its plain version, one launch
    each; chip_smoke.py runs the same shapes."""
    before = rs.resident_scatter.launches.count
    assert pr.scatter_edge_error(rows, G, K, TG, cuda_device) <= pr.SCATTER_TOL
    assert rs.resident_scatter.launches.count - before == 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_packed_forward_equals_dense_on_card(cuda_device):
    """Plain grouping and a budget that does not bind: the packed kernel's
    acc and trans equal the dense kernel's bit for bit on the same slots."""
    T, ntx, K = 64, 8, 128
    tp, counts, _ = _random_block(K, T, 9, cuda_device, ntx)
    args, G = _packed_block(T, ntx, K, K, 9, cuda_device, sort_by_depth=False)
    acc_p, trans_p, _, _ = rc.packed_blend_forward(*args, G, ntx)
    acc_d, trans_d, _, _ = rc.blend_forward(tp, counts, ntx)
    assert torch.equal(rc._from_group_major(acc_p, G), acc_d)
    assert torch.equal(rc._from_group_major(trans_p, G), trans_d)


@pytest.mark.cuda
def test_blend_autograd_on_card_matches_cpu(cuda_device):
    tp, counts, ntx = _random_block(64, 24, 5, "cpu")
    w = torch.randn(24, 4, rc.P, generator=torch.Generator().manual_seed(2))
    grads = {}
    for dev in ("cpu", cuda_device):
        x = tp.detach().to(dev).requires_grad_(True)
        acc, trans, _ = rc.blend(x, counts.to(dev), ntx)
        ((acc * w.to(dev)).sum() + trans.sum()).backward()
        grads[str(dev)] = x.grad.cpu()
    _rel_close(grads[str(cuda_device)], grads["cpu"], 1e-5)


@pytest.mark.cuda
def test_rasterize_on_card_matches_cpu(cuda_device):
    intr = Intrinsics(fx=80.0, fy=80.0, cx=32.0, cy=24.0, width=64, height=48)
    cfg = tr.RenderConfig(max_per_tile=64, tile_chunk=16)
    scene = make_scene_np(100, seed=2)
    outs = {}
    for dev in ("cpu", cuda_device):
        p = {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in scene.items()}
        active = torch.ones(100, dtype=torch.bool, device=dev)
        R, t = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        out = tr.rasterize(p, active, R, t, intr, cfg)
        ((out.image - 0.3) ** 2).mean().add(0.05 * (out.depth ** 2).mean()).backward()
        med = tr.rasterize_median_depth(p, active, R, t, intr, cfg)
        outs[str(dev)] = (out, {k: v.grad for k, v in p.items()}, med)
    (o_c, g_c, m_c), (o_g, g_g, m_g) = outs["cpu"], outs[str(cuda_device)]
    torch.testing.assert_close(o_g.image.cpu(), o_c.image, atol=1e-5, rtol=0)
    torch.testing.assert_close(o_g.depth.cpu(), o_c.depth, atol=1e-4, rtol=0)
    assert torch.equal(o_g.n_touched.cpu(), o_c.n_touched)
    for k in g_c:
        _rel_close(g_g[k].cpu(), g_c[k], 1e-3)
    torch.testing.assert_close(m_g[0].cpu(), m_c[0], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_wrappers_count_launches_and_refuse_bad_input_on_card(cuda_device):
    tp, counts, ntx = _random_block(32, 8, 3, cuda_device)
    before = [w.launches.count for w in rc.KERNEL_WRAPPERS]
    acc, trans, _, march = rc.blend_forward(tp, counts, ntx)
    rc.blend_backward(tp, counts, march, acc, trans, torch.ones_like(acc), torch.ones_like(trans), ntx)
    rc.median_depth(tp, counts, ntx)
    args, G = _packed_block(24, 8, 64, 64, 3, cuda_device)
    acc, trans, _, march = rc.packed_blend_forward(*args, G, 8)
    rc.packed_blend_backward(*args, march, acc, trans, torch.ones_like(acc), torch.ones_like(trans),
                             G, 8)
    acc, trans, _, march = rc.packed_blend_forward_bf16(*args, G, 8)
    rc.packed_blend_backward_bf16(*args, march, acc, trans, torch.ones_like(acc),
                                  torch.ones_like(trans), G, 8)
    assert [w.launches.count - b for w, b in zip(rc.KERNEL_WRAPPERS, before)] == [1] * 7
    before = [w.launches.count for w in rs.KERNEL_WRAPPERS]
    idx = torch.zeros((2, 4, 8), dtype=torch.int32, device=cuda_device)
    rs.resident_gather(idx, torch.ones((3, rs.NF), device=cuda_device))
    rs.resident_scatter(idx, torch.ones((2, 4, 8, rs.NF), device=cuda_device), 3)
    assert [w.launches.count - b for w, b in zip(rs.KERNEL_WRAPPERS, before)] == [1, 1]
    with pytest.raises(ValueError):
        rs.resident_gather(idx, torch.ones((3, rs.NF)))
    with pytest.raises(ValueError, match="indices must lie in"):
        rs.resident_gather(idx + 3, torch.ones((3, rs.NF), device=cuda_device))
    with pytest.raises(ValueError, match="indices must lie in"):
        rs.resident_scatter(idx - 1, torch.ones((2, 4, 8, rs.NF), device=cuda_device), 3)
    assert [w.launches.count - b for w, b in zip(rs.KERNEL_WRAPPERS, before)] == [1, 1]
    with pytest.raises(ValueError):
        rc.packed_blend_forward(args[0], args[1].long(), *args[2:], G, 8)
    with pytest.raises(ValueError):
        rc.blend_forward(tp, counts.long(), ntx)
    with pytest.raises(ValueError):
        rc.blend_forward(tp.double(), counts, ntx)
    with pytest.raises(ValueError):
        rc.blend_forward(tp, counts.cpu(), ntx)
    ones = (torch.ones_like(acc), torch.ones_like(trans))
    for bad in (march.long(), march[:-1], march.cpu()):
        with pytest.raises(ValueError, match="march|device"):
            rc.blend_backward(tp, counts, bad, acc, trans, *ones, ntx)


def test_cpu_tensors_take_the_plain_version_uncounted():
    tp, counts, ntx = _random_block(16, 8, 4, "cpu")
    before = [w.launches.count for w in rc.KERNEL_WRAPPERS]
    out = rc.blend_forward(tp, counts, ntx)
    assert all(torch.equal(o, p) for o, p in zip(out, rc.blend_forward_plain(tp, counts, ntx)))
    rc.median_depth(tp, counts, ntx)
    args, G = _packed_block(24, 8, 64, 64, 4, "cpu")
    out = rc.packed_blend_forward(*args, G, 8)
    assert all(torch.equal(o, p) for o, p in zip(out, rc.packed_blend_forward_plain(*args, G, 8)))
    assert [w.launches.count for w in rc.KERNEL_WRAPPERS] == before
    with pytest.raises(ValueError, match="device"):
        rc.blend_forward(tp.to("meta"), counts.to("meta"), ntx)
