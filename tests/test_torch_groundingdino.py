"""lvdgs_torch's GroundingDINO and MSDA against lvdgs_tpu's on the CPU: the
same NumPy inputs and the same weights (the reference's init_params,
carried over by convert.groundingdino_state_dict_from_numpy) through both
packages, at TINY_GDINO, TINY_SWIN and TINY_BERT; plus port copies of
tests/test_groundingdino.py. Tolerances: MSDA 1e-5 absolute (the
reference test's); every network output 1e-5 of its largest magnitude."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_torch import convert
from lvdgs_torch.models.groundingdino import bert as tb
from lvdgs_torch.models.groundingdino import inference as ti
from lvdgs_torch.models.groundingdino import model as tmodel
from lvdgs_torch.models.groundingdino import swin as ts
from lvdgs_torch.ops.msda import multi_scale_deformable_attention
from lvdgs_tpu.models.groundingdino import bert as jb
from lvdgs_tpu.models.groundingdino import inference as ji
from lvdgs_tpu.models.groundingdino import model as jmodel
from lvdgs_tpu.models.groundingdino import swin as js
from lvdgs_tpu.ops import msda as jmsda

import torch_parity  # noqa: F401  (TF32 off, one intra-op thread)

REL = 1e-5


def assert_rel(ours, ref, rel=REL, what=""):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(ours), fin, err_msg=what)
    scale = max(float(np.abs(ref[fin]).max()), 1e-30)
    err = float(np.abs(ours[fin] - ref[fin]).max()) / scale
    assert err <= rel, (what, err, scale)


def port_cfg(cfg):
    """The reference's GroundingDINOConfig as the port's."""
    return tmodel.GroundingDINOConfig(
        swin=ts.SwinConfig(**dataclasses.asdict(cfg.swin)), bert=tb.BertConfig(**dataclasses.asdict(cfg.bert)),
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name not in ("swin", "bert")})


def port_model(params, cfg):
    """A port GroundingDINO holding the reference's `params`."""
    tcfg = port_cfg(cfg)
    model = tmodel.GroundingDINO(tcfg)
    model.load_state_dict(convert.groundingdino_state_dict_from_numpy(jax.tree.map(np.asarray, params), tcfg),
                          strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    cfg = jmodel.TINY_GDINO
    params = jmodel.init_params(jax.random.PRNGKey(2), cfg)
    return cfg, params, port_model(params, cfg)


def _msda_inputs(seed=0, B=2, nH=2, c=4, Q=5, nP=3, shapes=((6, 8), (3, 4)), lo=0.05, hi=0.95):
    rng = np.random.default_rng(seed)
    N = sum(h * w for h, w in shapes)
    value = rng.normal(size=(B, N, nH, c)).astype(np.float32)
    locs = rng.uniform(lo, hi, size=(B, Q, nH, len(shapes), nP, 2)).astype(np.float32)
    weights = rng.uniform(size=(B, Q, nH, len(shapes), nP)).astype(np.float32)
    weights /= weights.sum(axis=(-1, -2), keepdims=True)
    return value, shapes, locs, weights


def _msda_fallback(value, shapes, locs, weights):
    """GroundingDINO's pure fallback (ms_deform_attn.py:93-131) through
    grid_sample, as tests/test_groundingdino.py writes it."""
    import torch.nn.functional as F

    value, locs, weights = (torch.from_numpy(np.asarray(x)) for x in (value, locs, weights))
    B, _, nH, c = value.shape
    _, Q, _, nL, nP, _ = locs.shape
    value_list = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * locs - 1
    out = []
    for lvl, (H, W) in enumerate(shapes):
        v = value_list[lvl].flatten(2).transpose(1, 2).reshape(B * nH, c, H, W)
        grid = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        out.append(F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros", align_corners=False))
    w = weights.transpose(1, 2).reshape(B * nH, 1, Q, nL * nP)
    res = (torch.stack(out, dim=-2).flatten(-2) * w).sum(-1)
    return res.view(B, nH * c, Q).transpose(1, 2).numpy()


# ---------------------------------------------------------------------------
# port copies of tests/test_groundingdino.py


def test_msda_matches_torch_fallback():
    value, shapes, locs, weights = _msda_inputs()
    ours = multi_scale_deformable_attention(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                                            torch.from_numpy(weights))
    np.testing.assert_allclose(ours.numpy(), _msda_fallback(value, shapes, locs, weights), atol=1e-5)


def test_swin_shapes():
    cfg = ts.TINY_SWIN
    outs = ts.SwinTransformer(cfg).eval()(torch.zeros((1, 3, 64, 96)))
    assert len(outs) == 3
    assert outs[0].shape == (1, cfg.embed_dim * 2, 8, 12)
    assert outs[1].shape == (1, cfg.embed_dim * 4, 4, 6)
    assert outs[2].shape == (1, cfg.embed_dim * 8, 2, 3)
    for o in outs:
        assert torch.isfinite(o).all()


def test_bert_phrase_mask_isolation(tiny):
    cfg, _, model = tiny
    bert = model.bert
    ids = np.array([1, 5, 6, 2, 7, 8, 2, 3], np.int64)  # [CLS] 5 6 . 7 8 . [SEP]
    mask, pad, position_ids = ti.build_text_masks(ids, (1, 2, 3))
    assert not mask[1, 4] and not mask[4, 1]
    assert mask[1, 2] and mask[4, 5]
    assert mask[1, 3] and mask[3, 1]
    assert not mask[0, 1] and not mask[7, 6]
    np.testing.assert_array_equal(position_ids, [0, 0, 1, 2, 0, 1, 2, 0])
    with torch.no_grad():
        out = bert(torch.from_numpy(ids)[None], torch.from_numpy(mask)[None])
        assert out.shape == (1, 8, cfg.bert.dim)
        ids2 = ids.copy()
        ids2[4] = 9
        out2 = bert(torch.from_numpy(ids2)[None], torch.from_numpy(mask)[None])
    np.testing.assert_allclose(out[0, 1:4].numpy(), out2[0, 1:4].numpy(), atol=1e-5)


def test_detector_end_to_end_random_weights():
    cfg = tmodel.TINY_GDINO
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(2), "cpu").eval()
    det = ti.GroundingDINODetector(model, image_size=64)
    img = np.random.default_rng(3).uniform(0, 255, size=(48, 64, 3)).astype(np.uint8)
    boxes, scores = det(img, "car . person .", box_threshold=0.0)
    assert len(boxes) == len(scores) == cfg.num_queries
    assert boxes.shape[1] == 4 and np.isfinite(boxes).all()


def test_tokenizer_fallback():
    tok = ti.WordPieceTokenizer(None)
    ids = tok("car . truck")
    assert ids[0] == tok.cls and ids[-1] == tok.sep
    assert tok.dot in ids


def test_tokenizer_packaged_vocab():
    """The port's own copy of the packaged prompt-lexicon vocab loads
    without a vocab_path; the whole prompt surface tokenizes [UNK]-free and
    off-lexicon words fall back to char pieces."""
    from lvdgs_torch.perception.masking import ScenePromptManager

    tok = ti.WordPieceTokenizer(None)
    assert tok.vocab and "lvdgs_torch" in ti._PACKAGED_VOCAB
    for scene in ScenePromptManager.SCENES.values():
        for phrases in scene.values():
            for phrase in phrases:
                assert tok.unk not in tok(phrase + " ."), phrase
    assert tok.unk not in tok("zeppelin .")
    assert tok("car .")[1] != tok("truck .")[1]


def test_masker_warmup_health():
    """Masker init runs the detector/segmenter self-test and reports health."""
    from lvdgs_torch.perception.masking import DynamicObjectMasker

    calls = {}

    def fake_detector(img, prompt):
        calls["det"] = (img.shape, prompt)
        return np.array([[10.0, 10.0, 50.0, 50.0]]), np.array([0.9])

    def fake_segmenter(img, boxes):
        calls["seg"] = boxes.shape
        return np.ones((len(boxes), img.shape[0], img.shape[1]), bool)

    m = DynamicObjectMasker(detector=fake_detector, segmenter=fake_segmenter)
    assert "det" in calls and "seg" in calls
    h = m.warmup()
    assert h["detector_ok"] and h["n_boxes"] == 1
    assert h["segmenter_ok"]
    assert "car" in calls["det"][1]

    def broken_detector(img, prompt):
        raise RuntimeError("boom")

    h2 = DynamicObjectMasker(detector=broken_detector, segmenter=None).warmup()
    assert h2["detector_ok"] is False and h2["segmenter_ok"] is None


# ---------------------------------------------------------------------------
# the port against the reference


@pytest.mark.parametrize("case", ["inside", "straddling the border"])
def test_msda_matches_reference(case):
    lo, hi = (0.05, 0.95) if case == "inside" else (-0.2, 1.2)
    value, shapes, locs, weights = _msda_inputs(seed=1, Q=7, lo=lo, hi=hi)
    ref = jmsda.multi_scale_deformable_attention(jnp.asarray(value), shapes, jnp.asarray(locs),
                                                  jnp.asarray(weights))
    ours = multi_scale_deformable_attention(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                                            torch.from_numpy(weights))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_swin_matches_reference(tiny):
    """A 72x100 input: the 18x25 grid is no multiple of the window (4), so
    every block pads, the shifted ones roll and mask, and the 25-wide grid
    merges with a pad."""
    cfg, params, model = tiny
    img = np.random.default_rng(4).normal(size=(2, 3, 72, 100)).astype(np.float32)
    ref = jax.jit(js.swin_forward, static_argnums=2)(jnp.asarray(img), params["backbone"], cfg.swin)
    with torch.no_grad():
        ours = model.backbone[0](torch.from_numpy(img))
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        assert_rel(o.numpy(), r, what="swin")


def test_bert_matches_reference(tiny):
    cfg, params, model = tiny
    rng = np.random.default_rng(5)
    ids = rng.integers(4, cfg.bert.vocab_size, size=(2, 9)).astype(np.int64)
    ids[:, 0], ids[:, -1], ids[:, 4] = 1, 3, 2
    masks = [ti.build_text_masks(row, (1, 2, 3)) for row in ids]
    mask = np.stack([m[0] for m in masks])
    pos = np.stack([m[2] for m in masks])
    ref = jb.bert_forward(params["bert"], jnp.asarray(ids.astype(np.int32)), jnp.asarray(mask), cfg.bert,
                          position_ids=jnp.asarray(pos.astype(np.int32)))
    with torch.no_grad():
        ours = model.bert(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pos))
    assert_rel(ours.numpy(), ref, what="bert")


def test_forward_matches_reference(tiny):
    cfg, params, model = tiny
    img = np.random.default_rng(0).normal(size=(1, 3, 64, 96)).astype(np.float32)
    ids = np.array([1, 5, 6, 2, 7, 8, 2, 3], np.int64)
    sm, pm, pos = ti.build_text_masks(ids, (1, 2, 3))
    ref = jmodel.groundingdino_forward(params, jnp.asarray(img), jnp.asarray(ids.astype(np.int32))[None],
                                       jnp.asarray(sm)[None], jnp.asarray(pm)[None], cfg,
                                       position_ids=jnp.asarray(pos.astype(np.int32))[None])
    ours = tmodel.groundingdino_forward(model, torch.from_numpy(img), torch.from_numpy(ids)[None],
                                        torch.from_numpy(sm)[None], torch.from_numpy(pm)[None],
                                        torch.from_numpy(pos)[None])
    assert_rel(ours["logits"].numpy(), ref["logits"], what="logits")
    assert_rel(ours["boxes"].numpy(), ref["boxes"], what="boxes")
    # the decoder fed the indices the selection chose gives the same output
    again = tmodel.groundingdino_forward(model, torch.from_numpy(img), torch.from_numpy(ids)[None],
                                         torch.from_numpy(sm)[None], torch.from_numpy(pm)[None],
                                         torch.from_numpy(pos)[None], topk=ours["topk"])
    assert torch.equal(again["boxes"], ours["boxes"])


def test_top_k_ties_in_index_order():
    """Equal scores are taken in index order, as jax.lax.top_k takes them
    (the invalid anchors' rows all score alike)."""
    rng = np.random.default_rng(6)
    scores = rng.integers(0, 4, size=(2, 50)).astype(np.float32)
    scores[:, 7] = -np.inf
    _, ref = jax.lax.top_k(jnp.asarray(scores), 20)
    np.testing.assert_array_equal(tmodel.top_k_in_index_order(torch.from_numpy(scores), 20).numpy(),
                                  np.asarray(ref))


def test_token_centres_match_reference():
    """The encoder's reference points, and the anchors they make valid, as
    the reference computes them: at a 50-wide level the last column's
    centre is 0.99 in float32, on the anchors' open bound, and invalid."""
    shapes = ((32, 100), (16, 50), (8, 25), (4, 13))
    ours = tmodel.token_centres(shapes)
    ref = []
    for H, W in shapes:
        gy, gx = jnp.meshgrid((jnp.arange(H) + 0.5) / H, (jnp.arange(W) + 0.5) / W, indexing="ij")
        ref.append(jnp.stack([gx, gy], -1).reshape(H * W, 2))
    ref = np.asarray(jnp.concatenate(ref, 0))
    np.testing.assert_array_equal(ours, ref)
    x = ours[3200:4000, 0].reshape(16, 50)
    assert not ((x > 0.01) & (x < 0.99))[:, 49].any() and ((x > 0.01) & (x < 0.99))[:, 48].all()


def test_text_inputs_match_reference():
    ours, ref = ti.WordPieceTokenizer(None), ji.WordPieceTokenizer(None)
    for caption in ("car . truck . traffic light .", "zeppelin . person", "Moving car. Car door."):
        assert ours.tokenize_with_spans(caption) == ref.tokenize_with_spans(caption)
        assert ours(caption) == ref(caption)
        ids = np.asarray(ours(caption))
        special = (ours.cls, ours.sep, ours.dot)
        for a, b in zip(ti.build_text_masks(ids, special), ji.build_text_masks(ids.astype(np.int32), special)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cv2_present", [True, False], ids=["cv2", "no cv2"])
def test_detector_call_matches_reference(tiny, monkeypatch, cv2_present):
    """GroundingDINODetector.__call__ on a 48x64 frame: boxes (pixels),
    scores and phrases. Without cv2 both fall back to jax.image.resize's
    bilinear (the port's weight-matrix form). The prompt's packaged-vocab
    ids stay inside TINY_BERT's 128 rows: past them the reference's gather
    clamps the index and the port's embedding raises."""
    cfg, params, model = tiny
    if not cv2_present:
        monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.random.default_rng(7).uniform(0, 255, size=(48, 64, 3)).astype(np.uint8)
    prompt = "person . car door . moving car ."
    ref = ji.GroundingDINODetector(params, cfg, image_size=96)(img, prompt, box_threshold=0.0,
                                                               return_phrases=True)
    ours = ti.GroundingDINODetector(model, image_size=96)(img, prompt, box_threshold=0.0,
                                                          return_phrases=True)
    assert_rel(ours[0], ref[0], what="boxes")
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-6)
    assert ours[2] == ref[2]
