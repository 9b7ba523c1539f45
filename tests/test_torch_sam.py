"""lvdgs_torch's SAM against lvdgs_tpu's on the CPU: the same NumPy inputs
and the same weights (the reference's init_params, carried over by
convert.sam_state_dict_from_numpy), at SAM's TINY config and at a variant
whose 8x8 grid pads to the window (3); plus port copies of
tests/test_sam.py. Tolerance: 1e-5 of each output's largest magnitude;
masks equal away from logits within that of 0."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_torch import convert
from lvdgs_torch.models.sam import inference as ti
from lvdgs_torch.models.sam import model as tm
from lvdgs_tpu.models.sam import inference as ji
from lvdgs_tpu.models.sam import model as jm

import torch_parity  # noqa: F401  (TF32 off, one intra-op thread)

REL = 1e-5
# TINY with a window that does not divide the 8x8 grid: the windowed block
# pads to 9x9, as ViT-B's 64x64 grid pads to 70x70 for its window of 14
PADDED = dataclasses.replace(jm.TINY, window=3)


def assert_rel(ours, ref, rel=REL, what=""):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max()) / float(np.abs(ref).max())
    assert err <= rel, (what, err)


def port_model(params, cfg) -> tm.SAM:
    tcfg = tm.SAMConfig(**dataclasses.asdict(cfg))
    model = tm.SAM(tcfg)
    model.load_state_dict(convert.sam_state_dict_from_numpy(jax.tree.map(np.asarray, params), tcfg), strict=True)
    return model.eval()


@pytest.fixture(scope="module", params=[jm.TINY, PADDED], ids=["TINY", "window 3"])
def pair(request):
    cfg = request.param
    params = jm.init_params(jax.random.PRNGKey(3), cfg)
    return cfg, params, port_model(params, cfg)


def _boxes(n, rng, H=48, W=64):
    x0, y0 = rng.uniform(0, W / 2, n), rng.uniform(0, H / 2, n)
    return np.stack([x0, y0, x0 + rng.uniform(4, W / 2, n), y0 + rng.uniform(4, H / 2, n)], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# port copies of tests/test_sam.py


def test_window_partition_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 10, 13, 8)).astype(np.float32))
    parts, pads = tm.window_partition(x, 4)
    back = tm.window_unpartition(parts, 4, pads, 2, 10, 13)
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-6)


def test_encoder_shapes_tiny():
    cfg = tm.TINY
    model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu").eval()
    emb = tm.sam_encode_image(model, torch.zeros((1, 3, cfg.img_size, cfg.img_size)))
    g = cfg.img_size // cfg.patch_size
    assert emb.shape == (1, cfg.embed_dim, g, g)
    assert torch.isfinite(emb).all()


def test_mask_decoder_shapes_tiny():
    cfg = tm.TINY
    model = tm.init_params(cfg, torch.Generator().manual_seed(1), "cpu").eval()
    g = cfg.img_size // cfg.patch_size
    emb = torch.randn((1, cfg.embed_dim, g, g), generator=torch.Generator().manual_seed(2))
    masks, iou = tm.sam_predict_masks(model, emb, torch.tensor([[0.1, 0.1, 0.6, 0.7], [0.2, 0.3, 0.9, 0.8]]))
    assert masks.shape == (2, cfg.num_mask_tokens, 4 * g, 4 * g)
    assert iou.shape == (2, cfg.num_mask_tokens)
    assert torch.isfinite(masks).all()


def test_segmenter_end_to_end_random_weights():
    cfg = tm.TINY
    seg = ti.SAMSegmenter(tm.init_params(cfg, torch.Generator().manual_seed(3), "cpu").eval())
    img = np.random.default_rng(4).uniform(0, 255, size=(48, 64, 3)).astype(np.uint8)
    masks = seg(img, np.array([[5, 5, 30, 40]], np.float32))
    assert masks.shape == (1, 48, 64) and masks.dtype == bool


# ---------------------------------------------------------------------------
# the port against the reference


def test_encoder_matches_reference(pair):
    cfg, params, model = pair
    img = np.random.default_rng(1).normal(size=(1, 3, cfg.img_size, cfg.img_size)).astype(np.float32)
    ref = jm.sam_encode_image(params, jnp.asarray(img), cfg)
    assert_rel(tm.sam_encode_image(model, torch.from_numpy(img)).numpy(), ref, what="embedding")


def test_decoder_matches_reference(pair):
    cfg, params, model = pair
    rng = np.random.default_rng(2)
    g = cfg.img_size // cfg.patch_size
    emb = rng.normal(size=(1, cfg.embed_dim, g, g)).astype(np.float32)
    boxes = np.array([[0.1, 0.1, 0.6, 0.7], [0.2, 0.3, 0.9, 0.8], [0.0, 0.5, 0.3, 1.0]], np.float32)
    masks, iou = jm.sam_predict_masks(params, jnp.asarray(emb), jnp.asarray(boxes), cfg)
    tmasks, tiou = tm.sam_predict_masks(model, torch.from_numpy(emb), torch.from_numpy(boxes))
    assert_rel(tmasks.numpy(), masks, what="mask logits")
    assert_rel(tiou.numpy(), iou, what="iou")


@pytest.mark.parametrize("n", [0, 1, 3, 40])
def test_segmenter_matches_reference(pair, n):
    """SAMSegmenter.__call__ on a 48x64 frame: at 3 boxes the reference
    pads its batch to 4 (its compile buckets) and the port decodes 3; at
    40 both keep the first 32. The masks are equal wherever the port's
    logit is not within 1e-5 of its largest magnitude of 0."""
    cfg, params, model = pair
    rng = np.random.default_rng(10 + n)
    img = rng.uniform(0, 255, size=(48, 64, 3)).astype(np.uint8)
    boxes = _boxes(n, rng)
    ref = ji.SAMSegmenter(params, cfg)(img, boxes)
    seg = ti.SAMSegmenter(model)
    ours = seg(img, boxes)
    assert ours.shape == ref.shape == (min(n, 32), 48, 64) and ours.dtype == bool
    if n:
        logits = seg.mask_logits(img, boxes).numpy()
        near = np.abs(logits) <= REL * np.abs(logits).max()
        assert ((ours != ref) & ~near).sum() == 0
