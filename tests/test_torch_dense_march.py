"""March lengths of the dense blend: the number of slots each tile marches
under the stop rule, which the dense forward returns and the dense backward
kernel takes in place of its own vote.

On the CPU the plain versions run: the forward's march lengths must equal,
tile by tile, the slots that the plain backward marches by its own vote, and
on a block built to saturate one tile at a known slot inside its second
chunk of 32, that tile's march ends there while the other tiles march to
their counts. The `cuda` cases hold the kernels to the same (they skip
without a card).
"""
import numpy as np
import pytest
import torch

from lvdgs_torch.ops import rasterizer_cuda as rc
from torch_parity import cuda_device  # noqa: F401


def _random_block(K=80, T=24, ntx=6, seed=0, device="cpu"):
    """Random depth-sorted slot lists, 7-22 px wide (some tiles saturate
    before their last slot), opacities up to the 0.99 clamp, counts from 0 to
    K (both ends present)."""
    g = np.random.default_rng(seed)
    tid = np.arange(T)
    tp = np.zeros((K, T, rc.NF), np.float32)
    tp[..., 0] = ((tid % ntx) * 16 + 8.0)[None] + g.normal(0, 6, (K, T))
    tp[..., 1] = ((tid // ntx) * 16 + 8.0)[None] + g.normal(0, 6, (K, T))
    s = g.uniform(0.002, 0.02, (K, T))
    tp[..., 2] = s
    tp[..., 3] = g.uniform(-0.3, 0.3, (K, T)) * s
    tp[..., 4] = s
    tp[..., 5:8] = g.uniform(0, 1, (K, T, 3))
    tp[..., 8] = np.sort(g.uniform(1, 10, (K, T)), axis=0)
    tp[..., 9] = g.uniform(0.2, 1.0, (K, T))
    counts = g.integers(0, K + 1, T).astype(np.int32)
    counts[:2] = (0, K)
    return torch.tensor(tp, device=device), torch.tensor(counts, device=device), ntx


def _saturating_block(device="cpu"):
    """Four tiles (2x2) of K = 96 slots, counts 96, 96, 70 and 0. Every slot
    holds a faint wide Gaussian (alpha about 0.05 over the whole tile: no
    tile saturates in 96 slots), except slots 40 and 41 of tile 1: an opaque
    Gaussian wider than the tile (alpha 0.99 at every pixel). After slot 41
    every pixel of tile 1 is below T_EPS, so it stops before slot 42, slot
    10 of its second chunk."""
    K, T, ntx = 96, 4, 2
    tp = torch.zeros((K, T, rc.NF))
    for t in range(T):
        cx, cy = (t % ntx) * 16 + 7.5, (t // ntx) * 16 + 7.5
        tp[:, t] = torch.tensor([cx, cy, 1e-3, 0.0, 1e-3, 0.2, 0.5, 0.8, 3.0, 0.05])
    tp[40:42, 1] = torch.tensor([23.5, 7.5, 1e-6, 0.0, 1e-6, 1.0, 1.0, 1.0, 2.0, 1.0])
    counts = torch.tensor([96, 96, 70, 0], dtype=torch.int32)
    return tp.to(device), counts.to(device), ntx


def _plain_backward_march(monkeypatch, tp, counts, ntx):
    """(T,) slots that blend_backward_plain marches by its own vote, counted
    from the tiles alive at each slot it walks."""
    marched = torch.zeros(tp.shape[1], dtype=torch.int32)
    step = rc._slot_backward

    def counting(p, px, py, alive, *rest, **kw):
        marched.add_(alive.to(torch.int32))
        return step(p, px, py, alive, *rest, **kw)

    acc, trans, _, _ = rc.blend_forward_plain(tp, counts, ntx)
    monkeypatch.setattr(rc, "_slot_backward", counting)
    rc.blend_backward_plain(tp, counts, acc, trans, torch.ones_like(acc), torch.ones_like(trans), ntx)
    return marched


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_forward_march_equals_plain_backward_march(monkeypatch, seed):
    tp, counts, ntx = _random_block(seed=seed)
    march = rc.blend_forward_plain(tp, counts, ntx)[3]
    assert march.shape == counts.shape and march.dtype == torch.int32
    assert torch.equal(march, _plain_backward_march(monkeypatch, tp, counts, ntx))
    # some tiles stop early, inside a chunk of 32; none marches past its count
    assert bool((march <= counts).all()) and bool((march < counts).any())
    assert bool(((march % rc.KC) != 0).any()) and int(march[0]) == 0


def test_march_stops_at_the_saturating_slot(monkeypatch):
    tp, counts, ntx = _saturating_block()
    _acc, trans, nt, march = rc.blend_forward_plain(tp, counts, ntx)
    expect = torch.tensor([96, 42, 70, 0], dtype=torch.int32)
    assert torch.equal(march, expect)
    # tile 1 saturated, the others did not; no slot past a tile's march
    # touches a pixel
    assert bool((trans[1] <= rc.T_EPS).all())
    assert bool((trans[[0, 2]] > rc.T_EPS).all()) and bool((trans[3] == 1.0).all())
    assert not nt[1, 42:].any() and not nt[2, 70:].any() and not nt[3].any()
    assert bool((nt[1, :42] > 0).all())
    assert torch.equal(_plain_backward_march(monkeypatch, tp, counts, ntx), expect)


def test_dense_backward_wrapper_checks_march():
    tp, counts, ntx = _saturating_block()
    acc, trans, _, march = rc.blend_forward(tp, counts, ntx)
    ones = (torch.ones_like(acc), torch.ones_like(trans))
    dtp = rc.blend_backward(tp, counts, march, acc, trans, *ones, ntx)
    # past tile 1's stop its slots get no gradient; before it they do
    assert not dtp[42:, 1].any() and not dtp[70:, 2].any() and not dtp[:, 3].any()
    assert dtp[:42, 1].abs().sum() > 0 and dtp[:, 0].abs().sum() > 0
    with pytest.raises(ValueError, match="march"):
        rc.blend_backward(tp, counts, march.long(), acc, trans, *ones, ntx)
    with pytest.raises(ValueError, match="march"):
        rc.blend_backward(tp, counts, march[:3], acc, trans, *ones, ntx)
    with pytest.raises(ValueError, match="march"):
        rc.blend_backward(tp, counts, march[:, None], acc, trans, *ones, ntx)


def test_plain_backward_refuses_another_forwards_march():
    tp, counts, ntx = _saturating_block()
    acc, trans, _, march = rc.blend_forward(tp, counts, ntx)
    ones = (torch.ones_like(acc), torch.ones_like(trans))
    # right shape and dtype, but one tile marches one slot more or less
    for tile, step in ((1, 1), (0, -1)):
        other = march.clone()
        other[tile] += step
        with pytest.raises(ValueError, match="march"):
            rc.blend_backward(tp, counts, other, acc, trans, *ones, ntx)
    # another block's forward: its march lengths are all full
    _, _, _, march_full = rc.blend_forward(tp, torch.tensor([96, 0, 70, 0], dtype=torch.int32), ntx)
    with pytest.raises(ValueError, match="march"):
        rc.blend_backward(tp, counts, march_full, acc, trans, *ones, ntx)


@pytest.mark.cuda
def test_kernel_march_matches_plain_on_card(cuda_device):
    for tp, counts, ntx in (_saturating_block(cuda_device), _random_block(device=cuda_device),
                            _random_block(K=256, T=160, ntx=16, seed=5, device=cuda_device)):
        acc, trans, nt, march = rc.blend_forward(tp, counts, ntx)
        ref = rc.blend_forward_plain(tp, counts, ntx)
        assert torch.equal(march, ref[3]) and torch.equal(nt, ref[2])
        g = torch.Generator(device=cuda_device).manual_seed(2)
        dacc = torch.randn(acc.shape, generator=g, device=cuda_device)
        dtrans = torch.randn(trans.shape, generator=g, device=cuda_device)
        dtp = rc.blend_backward(tp, counts, march, acc, trans, dacc, dtrans, ntx)
        dtp_p = rc.blend_backward_plain(tp, counts, acc, trans, dacc, dtrans, ntx)
        scale = dtp_p.abs().amax(dim=(0, 1), keepdim=True) + 1e-12
        assert float(((dtp - dtp_p).abs() / scale).max()) <= 1e-5
        assert torch.equal(rc.blend_backward(tp, counts, march, acc, trans, dacc, dtrans, ntx), dtp)
    torch.cuda.synchronize()
