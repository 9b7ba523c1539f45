"""The schedule of the median-depth kernel (B3, `median_depth_kernel` in
lvdgs_torch/csrc/blend.cu), written out in torch and held to the plain
version bit for bit.

The plain version (`median_depth_plain`) marches each tile's slots with a
tile-wide vote before every slot: the tile stops before the first slot at
which none of its 256 pixels has transmittance above 0.5. The kernel marches
each warp's 32 pixels on their own through chunks of 32 slots: a warp stops
at the first slot at which none of its pixels is above 0.5, and after each
chunk the tile's stop is the largest of its 8 warps' stops; a warp that
stopped earlier replays its transmittance up to the tile's stop without
testing for a crossing. `per_warp_median` below follows that schedule operation by
operation in float32, so equal bits here say the kernel's schedule computes
the plain version's dmed and opacity. The `cuda` cases hold the kernel itself
to the plain version at 1e-5 and to itself bit for bit (they skip without a
card).
"""
import pytest
import torch

from lvdgs_torch.ops import rasterizer_cuda as rc
from test_torch_dense_march import _random_block, _saturating_block
from torch_parity import cuda_device  # noqa: F401

KC, NWARP = rc.KC, rc.P // 32


def _one_warp_early_block(device="cpu"):
    """Six tiles (3x2) of K = 100 slots (not a multiple of 32), counts 100,
    100, 50, 0, 100 and 7. Every slot holds a faint Gaussian wider than the
    tile (alpha about 0.01: a pixel crosses 0.5 after ~69 slots, in the third
    chunk). In tiles 0 and 2, slot 3 also holds a Gaussian that reaches only
    the tile's top two pixel rows, warp 0's 32 pixels (alpha ~0.54 there,
    below ALPHA_MIN from row 2 down): warp 0 crosses 0.5 in the first
    chunk, two chunks before the rest of the tile.
    Tile 2's count ends the march before the others cross; tile 4 holds an
    opaque Gaussian over the whole tile at slot 40, where every warp crosses
    at once."""
    K, T, ntx = 100, 6, 3
    tp = torch.zeros((K, T, rc.NF))
    for t in range(T):
        x0, y0 = (t % ntx) * 16, (t // ntx) * 16
        tp[:, t] = torch.tensor([x0 + 7.5, y0 + 7.5, 1e-4, 0.0, 1e-4, 0.3, 0.6, 0.9, 0.0, 0.0101])
        tp[:, t, 8] = torch.linspace(1.0, 9.0, K)
    for t in (0, 2):
        x0, y0 = (t % ntx) * 16, (t // ntx) * 16
        tp[3, t] = torch.tensor([x0 + 7.5, y0 + 0.5, 1e-6, 0.0, 5.0, 1.0, 1.0, 1.0, 1.25, 1.0])
    tp[40, 4] = torch.tensor([16 + 7.5, 16 + 7.5, 1e-6, 0.0, 1e-6, 1.0, 1.0, 1.0, 5.5, 1.0])
    counts = torch.tensor([100, 100, 50, 0, 100, 7], dtype=torch.int32)
    return tp.to(device), counts.to(device), ntx


BLOCKS = {
    "random-3": lambda device="cpu": _random_block(seed=3, device=device),
    "random-4": lambda device="cpu": _random_block(seed=4, device=device),
    "saturating": _saturating_block,
    "one-warp-early": _one_warp_early_block,
}


def per_warp_median(tp, counts, ntx):
    """The kernel's schedule in float32 torch: (dmed (T, P), opac (T, P),
    stats), stats counting the warp-slots marched and replayed, and per
    chunk the warps that stopped before their tile."""
    K, T, _ = tp.shape
    px, py = rc._pixel_coords(T, ntx, tp.device)
    trans = torch.ones((T, NWARP, 32))
    dmed = torch.zeros((T, NWARP, 32))
    count = counts.long().clamp(0, K)
    live = count > 0  # tiles still marching
    stats = {"marched": 0, "replayed": 0, "early_warps": 0}
    half = torch.tensor(0.5, dtype=torch.float32)
    for c in range(-(-K // KC)):
        n = (count - c * KC).clamp(0, KC)  # slots of this chunk, per tile
        stop = torch.where(live, n, torch.zeros_like(n))[:, None].expand(T, NWARP).clone()
        marching = live[:, None].expand(T, NWARP).clone()
        alphas = []
        for kc in range(KC):
            k = c * KC + kc
            if k >= K:
                break
            p = tp[k]
            alpha = rc._alpha_at(p, px, py)[0].reshape(T, NWARP, 32)
            alphas.append(alpha)
            inside = kc < n[:, None]
            # the warp's vote before the slot
            stopping = marching & inside & ~(trans > half).any(dim=2)
            stop = torch.where(stopping, torch.full_like(stop, kc), stop)
            marching = marching & inside & ~stopping
            t_new = trans * (1.0 - alpha)
            crossed = marching[..., None] & (trans > half) & (t_new <= half)
            dmed = torch.where(crossed, p[:, 8].reshape(T, 1, 1).expand_as(dmed), dmed)
            trans = torch.where(marching[..., None], t_new, trans)
            stats["marched"] += int(marching.sum())
        # one barrier: the tile's stop, and the replay up to it
        tile_stop = stop.max(dim=1).values
        stats["early_warps"] += int((live[:, None] & (stop < tile_stop[:, None])).sum())
        for kc, alpha in enumerate(alphas):
            replay = live[:, None] & (kc >= stop) & (kc < tile_stop[:, None])
            # a replaying warp's pixels are all at 0.5 or below: no crossing
            assert not bool((replay[..., None] & (trans > half)).any())
            trans = torch.where(replay[..., None], trans * (1.0 - alpha), trans)
            stats["replayed"] += int(replay.sum())
        live = live & (tile_stop == n) & ((c + 1) * KC < count)
    return dmed.reshape(T, rc.P), 1.0 - trans.reshape(T, rc.P), stats


@pytest.mark.parametrize("block", list(BLOCKS))
def test_per_warp_schedule_equals_plain_bit_for_bit(block):
    tp, counts, ntx = BLOCKS[block]()
    dmed, opac, stats = per_warp_median(tp, counts, ntx)
    dmed_p, opac_p = rc.median_depth_plain(tp, counts, ntx)
    assert torch.equal(dmed, dmed_p)
    assert torch.equal(opac, opac_p)
    assert stats["marched"] > 0
    # the wrapper on CPU tensors is the plain version
    out = rc.median_depth(tp, counts, ntx)
    assert torch.equal(out[0], dmed_p) and torch.equal(out[1], opac_p)


def test_one_warp_crosses_chunks_before_its_tile():
    """The block built for it: warp 0 of tiles 0 and 2 crosses 0.5 in the
    first chunk and stops there; in tile 0 the rest of the tile marches into
    the third chunk, so warp 0 replays."""
    tp, counts, ntx = _one_warp_early_block()
    dmed, opac, stats = per_warp_median(tp, counts, ntx)
    dmed_p, opac_p = rc.median_depth_plain(tp, counts, ntx)
    assert torch.equal(dmed, dmed_p) and torch.equal(opac, opac_p)
    rows = dmed_p.reshape(6, 16, 16)
    # warp 0 (rows 0-1) of tiles 0 and 2 crossed at slot 3, the others later
    assert bool((rows[0, :2] == tp[3, 0, 8]).all()) and bool((rows[2, :2] == tp[3, 2, 8]).all())
    assert bool((rows[0, 2:] > tp[64, 0, 8]).all())
    # tile 2 stopped at its count before its other warps crossed; tile 3 is
    # empty; tile 4 crossed everywhere at slot 40; tile 5 (7 slots) never did
    assert bool((rows[2, 2:] == 0).all()) and bool((rows[3] == 0).all()) and bool((opac_p[3] == 0).all())
    assert bool((rows[4] == tp[40, 4, 8]).all())
    assert bool((rows[5] == 0).all()) and bool((opac_p[5] < 0.5).all())
    assert stats["early_warps"] > 0 and stats["replayed"] > 0
    # the opacity of crossed pixels depends on where the tile stopped: tiles
    # 0 and 2 hold the same slots up to tile 2's count, 50, and warp 0 of
    # tile 0 went on multiplying its transmittance into the third chunk
    assert bool((opac_p[0, :32] > opac_p[2, :32]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("block", list(BLOCKS))
def test_median_kernel_matches_plain_and_repeats_on_card(cuda_device, block):
    tp, counts, ntx = BLOCKS[block](device=cuda_device)
    dmed, opac = rc.median_depth(tp, counts, ntx)
    dmed_p, opac_p = rc.median_depth_plain(tp, counts, ntx)
    torch.testing.assert_close(dmed, dmed_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(opac, opac_p, atol=1e-5, rtol=0)
    again = rc.median_depth(tp, counts, ntx)
    assert torch.equal(again[0], dmed) and torch.equal(again[1], opac)
    torch.cuda.synchronize()
