"""The port's coarse-to-fine matching (lvdgs_torch/models/mast3r/coarse_to_fine.py):
copies of tests/test_coarse_to_fine.py on the port, and parity with the
reference: crop pairs equal, and refined matches equal on the same
coordinate model (host NumPy descriptors for the reference, the same
descriptors as torch tensors for the port)."""
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (one thread, no TF32)
from lvdgs_torch.models.mast3r import coarse_to_fine as tc
from lvdgs_tpu.models.mast3r import coarse_to_fine as jc
from tests.test_coarse_to_fine import _CoordModel


def test_window_grid_invariants():
    for (H, W) in [(370, 1226), (480, 640), (100, 100), (40, 900)]:
        cells = tc.window_grid(H, W, maxdim=512, overlap=0.5)
        assert len(cells) >= 1
        w = cells[:, 2] - cells[:, 0]
        h = cells[:, 3] - cells[:, 1]
        assert (w % 16 == 0).all() and (h % 16 == 0).all()
        assert (w == w[0]).all() and (h == h[0]).all()
        assert (cells[:, 0] >= 0).all() and (cells[:, 1] >= 0).all()
        assert (cells[:, 2] <= W).all() and (cells[:, 3] <= H).all()
        assert cells[:, 0].min() == 0 and cells[:, 1].min() == 0
        assert cells[:, 2].max() == W or w[0] == (W // 16) * 16
        assert cells[:, 3].max() == H or h[0] == (H // 16) * 16
        np.testing.assert_array_equal(cells, jc.window_grid(H, W, maxdim=512, overlap=0.5))


def test_greedy_cover_reaches_target():
    rng = np.random.default_rng(0)
    weights = rng.uniform(0, 1, (12, 200)) * (rng.uniform(size=(12, 200)) > 0.7)
    picked = tc.greedy_cover(weights, coverage=0.9)
    covered = weights[picked].max(axis=0).sum()
    assert covered >= 0.9 * weights.max(axis=0).sum()
    assert picked[0] == int(weights.sum(axis=1).argmax())
    assert tc.greedy_cover(np.zeros((3, 5))) == []
    assert len(tc.greedy_cover(weights, coverage=0.9, max_pairs=2)) <= 2
    assert picked == jc.greedy_cover(weights, coverage=0.9)


def _clusters(seed=1, H=256, W=512):
    rng = np.random.default_rng(seed)
    qa = rng.uniform([10, 10], [120, 120], (40, 2))
    qb = rng.uniform([300, 120], [480, 240], (40, 2))
    p_q = np.concatenate([qa, qb])
    p_b = np.clip(p_q + np.array([30.0, 10.0]), 0, [W - 1, H - 1])
    return p_q, p_b


def test_select_crop_pairs_cover_correspondences():
    H, W = 256, 512
    p_q, p_b = _clusters()
    pairs = tc.select_crop_pairs((H, W), (H, W), p_q, p_b, maxdim=160, overlap=0.5, coverage=0.9)
    assert len(pairs) >= 2
    for cq, cb in pairs:
        inside_q = ((cq[0] <= p_q[:, 0]) & (p_q[:, 0] < cq[2]) & (cq[1] <= p_q[:, 1]) & (p_q[:, 1] < cq[3]))
        assert inside_q.sum() >= 10
        land = p_b[inside_q]
        frac_in_b = ((cb[0] <= land[:, 0]) & (land[:, 0] < cb[2])
                     & (cb[1] <= land[:, 1]) & (land[:, 1] < cb[3])).mean()
        assert frac_in_b > 0.6, (cq, cb, frac_in_b)


class _TorchCoordModel(_CoordModel):
    """The reference test's coordinate model with the same Fourier weights,
    handing its descriptors on as torch tensors, as the network does."""

    def infer_pair(self, img1, img2):
        d1, d2, shape = super().infer_pair(np.asarray(img1), np.asarray(img2))
        return {"desc": torch.as_tensor(d1["desc"])}, {"desc": torch.as_tensor(d2["desc"])}, shape


def _coord_image(H=96, W=160):
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    return np.stack([u / 1000.0, v / 1000.0, np.zeros_like(u)])


def test_refine_matches_end_to_end():
    H, W = 96, 160
    img = _coord_image(H, W)
    m1, m2 = tc.refine_matches(_TorchCoordModel(), img, img, maxdim=64, overlap=0.5, coverage=0.95,
                               subsample=4)
    assert len(m1) > 20
    assert np.abs(m1 - m2).max() <= 2
    assert (m1[:, 0] < W).all() and (m1[:, 1] < H).all()
    assert (m1 >= 0).all() and (m2 >= 0).all()


def test_crop_pairs_and_refined_matches_equal_the_reference():
    """select_crop_pairs on the same correspondences gives the reference's
    pairs in its order; refine_matches on a shifted pair of coordinate
    images (the same model weights in both packages) gives the reference's
    matches, and so does a torch image on the same model."""
    H, W = 256, 512
    p_q, p_b = _clusters(seed=2)
    for maxdim, coverage in ((160, 0.9), (128, 0.95)):
        ours = tc.select_crop_pairs((H, W), (H, W), p_q, p_b, maxdim=maxdim, coverage=coverage)
        ref = jc.select_crop_pairs((H, W), (H, W), p_q, p_b, maxdim=maxdim, coverage=coverage)
        assert len(ours) == len(ref) >= 2
        for (a, b), (c, d) in zip(ours, ref):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)

    img1 = _coord_image(120, 200)
    img2 = img1.copy()
    img2[0] += 0.006  # the second view sees every point 6 px to the right
    kw = dict(maxdim=64, overlap=0.5, coverage=0.95, subsample=4)
    ref = jc.refine_matches(_CoordModel(seed=3), img1, img2, **kw)
    ours = tc.refine_matches(_TorchCoordModel(seed=3), img1, img2, **kw)
    ours_t = tc.refine_matches(_TorchCoordModel(seed=3), torch.as_tensor(img1), torch.as_tensor(img2), **kw)
    assert len(ref[0]) > 20
    for o in (ours, ours_t):
        for a, b in zip(o, ref):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)


def _tiny_networks():
    """The reference's TINY MASt3R and the port's, from the same weights."""
    import jax

    from lvdgs_torch import convert
    from lvdgs_torch.models.mast3r import inference as ti
    from lvdgs_torch.models.mast3r import model as tm
    from lvdgs_tpu.models.mast3r import inference as ji
    from lvdgs_tpu.models.mast3r import model as jm

    params = jm.init_params(jax.random.PRNGKey(0), jm.TINY)
    model = tm.MASt3R(tm.TINY)
    model.load_state_dict(convert.mast3r_state_dict_from_numpy(jax.tree.map(np.array, params), tm.TINY),
                          strict=True)
    return ji.MASt3RInference(params, jm.TINY, size=64), ti.MASt3RInference(model.eval(), size=64)


def test_two_shape_forward_and_refinement_on_the_network():
    """Crops that preprocess to different shapes: the port encodes each view
    alone (the official model's way; held to the reference's blocks in
    tests/test_torch_mast3r.py) and matches each at its own model
    resolution. The reference's forward concatenates the two views and
    cannot take them (ROADMAP C15)."""
    import jax.numpy as jnp

    from lvdgs_torch.models.mast3r.model import mast3r_forward
    from lvdgs_tpu.models.mast3r.model import mast3r_forward as jforward

    ref, ours = _tiny_networks()
    rng = np.random.default_rng(5)
    x1 = torch.as_tensor(rng.uniform(-1, 1, (1, 3, 32, 64)), dtype=torch.float32)
    x2 = torch.as_tensor(rng.uniform(-1, 1, (1, 3, 48, 48)), dtype=torch.float32)
    p1, p2 = mast3r_forward(ours.model, x1, x2)
    assert p1["desc"].shape[1:3] == (32, 64) and p2["desc"].shape[1:3] == (48, 48)
    assert torch.isfinite(p1["desc"]).all() and torch.isfinite(p2["desc"]).all()
    with pytest.raises(TypeError):
        jforward(ref.params, jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy()), ref.cfg)

    img1 = rng.uniform(0, 1, (3, 96, 160)).astype(np.float32)
    img2 = np.roll(img1, 4, axis=2)
    kw = dict(maxdim=64, coverage=0.95, subsample=4)
    m1, m2 = tc.refine_matches(ours, img1, torch.as_tensor(img2), **kw)
    with pytest.raises((TypeError, ValueError)):
        jc.refine_matches(ref, img1, img2, **kw)
    # at the network's size of 64 a crop keeps one 16-px patch row down to
    # about 4:1 (the pairs above hold a 160x32 partner, which it skips)
    assert not ours.fits(np.zeros((3, 32, 160))) and ours.fits(np.zeros((3, 48, 160)))
    assert len(m1) == len(m2) > 0 and m1.dtype == m2.dtype == np.int64
    for m, (H, W) in ((m1, img1.shape[1:]), (m2, img2.shape[1:])):
        assert (m >= 0).all() and (m[:, 0] <= W).all() and (m[:, 1] <= H).all()
