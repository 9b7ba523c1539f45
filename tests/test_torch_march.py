"""March lengths of the packed blend: the number of slots each tile marches
under the stop rule, which the packed forward returns and the packed
backward kernel takes in place of its own vote.

On the CPU the plain versions run: the forward's march lengths must equal,
tile by tile, the slots that the plain backward marches by its own vote, and
on a block built to saturate one tile at a known slot inside a chunk, that
tile's march ends there while its group's other tiles march every slot.
The `cuda` cases hold the kernels to the same (they skip without a card).
"""
import numpy as np
import pytest
import torch

from lvdgs_torch.ops import rasterizer as tr
from lvdgs_torch.ops import rasterizer_cuda as rc
from torch_parity import cuda_device  # noqa: F401

KC = rc.KC


def _random_packed(T=24, ntx=6, K=80, budget=80, TG=4, seed=0, sort_by_depth=True, device="cpu"):
    """Random depth-sorted slot lists packed by pack_bins (opacities up to
    the 0.99 clamp, so that some tiles saturate before their last slot)."""
    g = np.random.default_rng(seed)
    tid = np.arange(T)
    tp = np.zeros((K, T, rc.NF), np.float32)
    tp[..., 0] = ((tid % ntx) * 16 + 8.0)[None] + g.normal(0, 6, (K, T))
    tp[..., 1] = ((tid // ntx) * 16 + 8.0)[None] + g.normal(0, 6, (K, T))
    s = g.uniform(0.002, 0.02, (K, T))  # 7-22 px wide: some tiles saturate
    tp[..., 2] = s
    tp[..., 3] = g.uniform(-0.3, 0.3, (K, T)) * s
    tp[..., 4] = s
    tp[..., 5:8] = g.uniform(0, 1, (K, T, 3))
    tp[..., 8] = np.sort(g.uniform(1, 10, (K, T)), axis=0)
    tp[..., 9] = g.uniform(0.2, 1.0, (K, T))
    counts = torch.tensor(g.integers(0, K + 1, T), dtype=torch.int32)
    tp = torch.tensor(tp)
    C = K * T
    slot_valid = torch.arange(K)[None] < counts[:, None].long()
    tile_idx = torch.where(slot_valid, torch.arange(C).reshape(T, K), C)
    fields = torch.cat([tp.permute(1, 0, 2).reshape(C, rc.NF), torch.zeros(1, rc.NF)])
    cap = torch.tensor(g.integers(0, K + 1, T), dtype=torch.int32) if sort_by_depth else None
    pb = tr.pack_bins(tile_idx, slot_valid, C, tile_group=TG, slot_budget_per_tile=budget,
                      tile_cap=cap, sort_by_depth=sort_by_depth)
    args = [tr._gather_rows(fields, pb.gid).contiguous(), pb.cg, pb.k0,
            torch.zeros(1, dtype=torch.int32), pb.tids]
    return [x.to(device) for x in args], -(-T // TG), ntx


def _saturating_block(device="cpu"):
    """Two groups of TG = 4 tiles (group 0: 3 chunks, group 1: 2 chunks) and
    one padding chunk. Every slot holds a faint wide Gaussian (alpha about
    0.05 over the whole tile: no tile saturates in 96 slots), except slots
    40 and 41 of tile 1 (group 0, lane 1): an opaque Gaussian wider than the
    tile (alpha 0.99 at every pixel). After slot 41 every pixel of tile 1 is
    below T_EPS, so it stops before slot 42, slot 10 of its second chunk."""
    TG, ntx = 4, 4
    cg = torch.tensor([0, 0, 0, 1, 1, 2], dtype=torch.int32)
    k0 = torch.tensor([0, KC, 2 * KC, 0, KC, 0], dtype=torch.int32)
    tids = torch.tensor([[0, 1, 2, 3]] * 3 + [[4, 5, 6, 7]] * 2 + [[0, 0, 0, 0]], dtype=torch.int32)
    NB = cg.shape[0]
    tp = torch.zeros((NB, KC, TG, rc.NF))
    for b in range(NB - 1):
        for lane in range(TG):
            t = int(tids[b, lane])
            cx, cy = (t % ntx) * 16 + 7.5, (t // ntx) * 16 + 7.5
            tp[b, :, lane] = torch.tensor([cx, cy, 1e-3, 0.0, 1e-3, 0.2, 0.5, 0.8, 3.0, 0.05])
    tp[1, 8:10, 1] = torch.tensor([23.5, 7.5, 1e-6, 0.0, 1e-6, 1.0, 1.0, 1.0, 2.0, 1.0])
    args = [tp.contiguous(), cg, k0, torch.zeros(1, dtype=torch.int32), tids]
    return [x.to(device) for x in args], 2, ntx


def _plain_backward_march(monkeypatch, args, G, ntx, bf16):
    """(G + 1, TG) slots that packed_blend_backward_plain marches by its own
    vote, counted from the slot positions it walks."""
    TG = args[0].shape[2]
    marched = torch.zeros(G * TG, dtype=torch.int32)
    walk = rc._packed_slots

    def counting(*a, **kw):
        for alive, *rest in walk(*a, **kw):
            marched.add_(alive.to(torch.int32))
            yield (alive, *rest)

    acc, trans, _, _ = rc.packed_blend_forward_plain(*args, G, ntx, with_nt=False, bf16=bf16)
    monkeypatch.setattr(rc, "_packed_slots", counting)
    rc.packed_blend_backward_plain(*args, acc, trans, torch.ones_like(acc), torch.ones_like(trans), G,
                                   ntx, bf16=bf16)
    return torch.cat([marched.reshape(G, TG), torch.zeros((1, TG), dtype=torch.int32)])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("sort_by_depth", [True, False], ids=["sorted", "plain"])
def test_plain_forward_march_equals_plain_backward_march(monkeypatch, bf16, sort_by_depth):
    args, G, ntx = _random_packed(seed=3 if sort_by_depth else 4, sort_by_depth=sort_by_depth)
    NB, _, TG, _ = args[0].shape
    march = rc.packed_blend_forward_plain(*args, G, ntx, with_nt=False, bf16=bf16)[3]
    assert march.shape == (G + 1, TG) and march.dtype == torch.int32
    assert torch.equal(march, _plain_backward_march(monkeypatch, args, G, ntx, bf16))
    # some tiles stop early, inside a chunk, and none marches past its chunks
    _start, nch = rc._group_chunks(args[1], G)
    full = (nch * KC)[:, None].expand(G, TG)
    assert bool((march[:G] <= full).all()) and bool((march[:G] < full).any())
    assert bool(((march[:G] % KC) != 0).any())


@pytest.mark.parametrize("flags", [dict(with_nt=True), dict(with_nt=False), dict(probe_wmax=True)],
                         ids=["with_nt", "no_nt", "probe_wmax"])
def test_march_stops_at_the_saturating_slot(monkeypatch, flags):
    args, G, ntx = _saturating_block()
    _acc, trans, _nt, march = rc.packed_blend_forward_plain(*args, G, ntx, **flags)
    expect = torch.tensor([[96, 42, 96, 96], [64, 64, 64, 64], [0, 0, 0, 0]], dtype=torch.int32)
    assert torch.equal(march, expect)
    # tile 1 saturated; the others did not
    assert bool((trans[0, 1] <= rc.T_EPS).all())
    assert bool((trans[0, [0, 2, 3]] > rc.T_EPS).all()) and bool((trans[1] > rc.T_EPS).all())
    assert torch.equal(_plain_backward_march(monkeypatch, args, G, ntx, False), expect)


def test_packed_backward_wrapper_checks_march():
    args, G, ntx = _saturating_block()
    acc, trans, _, march = rc.packed_blend_forward(*args, G, ntx)
    ones = (torch.ones_like(acc), torch.ones_like(trans))
    dtp = rc.packed_blend_backward(*args, march, acc, trans, *ones, G, ntx)
    # past tile 1's stop its slots get no gradient; before it they do
    assert not dtp[1, 10:, 1].any() and not dtp[2, :, 1].any()
    assert dtp[1, :10, 1].abs().sum() > 0 and dtp[2, :, 0].abs().sum() > 0
    with pytest.raises(ValueError, match="march"):
        rc.packed_blend_backward(*args, march.long(), acc, trans, *ones, G, ntx)
    with pytest.raises(ValueError, match="march"):
        rc.packed_blend_backward(*args, march[:G], acc, trans, *ones, G, ntx)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_backward_refuses_another_forwards_march(bf16):
    args, G, ntx = _saturating_block()
    fwd = rc.packed_blend_forward_bf16 if bf16 else rc.packed_blend_forward
    bwd = rc.packed_blend_backward_bf16 if bf16 else rc.packed_blend_backward
    acc, trans, _, march = fwd(*args, G, ntx)
    ones = (torch.ones_like(acc), torch.ones_like(trans))
    # right shape and dtype, but one tile marches one slot more
    other = march.clone()
    other[0, 1] += 1
    with pytest.raises(ValueError, match="march"):
        bwd(*args, other, acc, trans, *ones, G, ntx)
    # the filler row marches nothing
    other = march.clone()
    other[G, 0] = 1
    with pytest.raises(ValueError, match="march"):
        bwd(*args, other, acc, trans, *ones, G, ntx)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_kernel_march_matches_plain_on_card(cuda_device, bf16):
    for args, G, ntx in (_saturating_block(cuda_device), _random_packed(device=cuda_device)):
        fwd = rc.packed_blend_forward_bf16 if bf16 else rc.packed_blend_forward
        bwd = rc.packed_blend_backward_bf16 if bf16 else rc.packed_blend_backward
        acc, trans, nt, march = fwd(*args, G, ntx)
        ref = rc.packed_blend_forward_plain(*args, G, ntx, bf16=bf16)
        assert torch.equal(march, ref[3]) and torch.equal(nt, ref[2])
        g = torch.Generator(device=cuda_device).manual_seed(2)
        dacc = torch.randn(acc.shape, generator=g, device=cuda_device)
        dtrans = torch.randn(trans.shape, generator=g, device=cuda_device)
        dtp = bwd(*args, march, acc, trans, dacc, dtrans, G, ntx)
        dtp_p = rc.packed_blend_backward_plain(*args, acc, trans, dacc, dtrans, G, ntx, bf16=bf16)
        scale = dtp_p.abs().amax(dim=(0, 1, 2), keepdim=True) + 1e-12
        assert float(((dtp - dtp_p).abs() / scale).max()) <= 1e-5
        assert torch.equal(bwd(*args, march, acc, trans, dacc, dtrans, G, ntx), dtp)
    torch.cuda.synchronize()
