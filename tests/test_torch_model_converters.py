"""Weight carrying and checkpoint loading of lvdgs_torch's GroundingDINO and
SAM, against lvdgs_tpu's converters on the CPU.

- The carry functions (convert.groundingdino_state_dict_from_numpy,
  convert.sam_state_dict_from_numpy) are the inverse of the reference's
  convert_state_dict: reference init_params -> NumPy -> the port's state
  dict -> the reference's converter gives back the original tree, exactly.
- Port copies of tests/test_converters.py's round trips: an official-layout
  file, with the keys that the official checkpoints hold beside the
  parameters, loads through the port's loader (weights_only) into the
  module bit for bit, and the loaded model runs as the reference's
  converted tree does (1e-5 of the largest magnitude)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvdgs_torch import convert
from lvdgs_torch.models.groundingdino import convert as tgc
from lvdgs_torch.models.groundingdino import model as tgm
from lvdgs_torch.models.sam import convert as tsc
from lvdgs_torch.models.sam import model as tsm
from lvdgs_tpu.models.groundingdino import convert as jgc
from lvdgs_tpu.models.groundingdino import model as jgm
from lvdgs_tpu.models.groundingdino.inference import build_text_masks
from lvdgs_tpu.models.sam import convert as jsc
from lvdgs_tpu.models.sam import model as jsm

import torch_parity  # noqa: F401  (TF32 off, one intra-op thread)


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb), (sorted(set(fa) - set(fb))[:5], sorted(set(fb) - set(fa))[:5])
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(scope="module")
def gdino():
    cfg = jgm.TINY_GDINO
    return cfg, jgm.init_params(jax.random.PRNGKey(5), cfg)


@pytest.fixture(scope="module")
def sam():
    cfg = jsm.TINY
    return cfg, jsm.init_params(jax.random.PRNGKey(3), cfg)


def test_gdino_carry_inverts_reference_converter(gdino):
    cfg, params = gdino
    sd = convert.groundingdino_state_dict_from_numpy(jax.tree.map(np.asarray, params), tgm.TINY_GDINO)
    assert set(sd) == set(tgm.GroundingDINO(tgm.TINY_GDINO).state_dict())
    assert_trees_equal(jgc.convert_state_dict(sd, cfg), params)


def test_sam_carry_inverts_reference_converter(sam):
    cfg, params = sam
    sd = convert.sam_state_dict_from_numpy(jax.tree.map(np.asarray, params), tsm.TINY)
    assert set(sd) == set(tsm.SAM(tsm.TINY).state_dict())
    assert_trees_equal(jsc.convert_state_dict(sd, cfg), params)


@pytest.mark.parametrize("layout", ["model", "DataParallel, bert.bert"])
def test_gdino_convert_roundtrip_tiny(gdino, tmp_path, layout):
    """Port copy of tests/test_converters.py::test_gdino_convert_roundtrip_tiny:
    the official file holds its state dict under "model", with keys no
    parameter reads (BERT's pooler and position ids, the class and the
    duplicated box heads, Swin's index buffers); wrapped as DataParallel
    saves it, or with the BERT prefix the reference also reads."""
    cfg, params = gdino
    sd = convert.groundingdino_state_dict_from_numpy(jax.tree.map(np.asarray, params), tgm.TINY_GDINO)
    official = dict(sd)
    official["bert.pooler.dense.weight"] = torch.zeros(32, 32)
    official["bert.embeddings.position_ids"] = torch.arange(64)[None]
    official["transformer.enc_out_class_embed.bias"] = torch.zeros(32)
    official["backbone.0.layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(16, 16, dtype=torch.long)
    for j in range(3):
        for w in ("weight", "bias"):
            official[f"transformer.decoder.bbox_embed.1.layers.{j}.{w}"] = sd[f"bbox_embed.0.layers.{j}.{w}"]
    if layout != "model":
        official = {"module." + k.replace("bert.", "bert.bert.", 1) if k.startswith("bert.") else "module." + k: v
                    for k, v in official.items()}
    path = tmp_path / "groundingdino.pth"
    torch.save({"model": official}, path)
    model = tgc.load_converted(str(path), tgm.TINY_GDINO, device="cpu")
    loaded = model.state_dict()
    assert set(loaded) == set(sd)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)

    img = np.random.default_rng(0).normal(size=(1, 3, 64, 96)).astype(np.float32)
    ids = np.array([1, 5, 6, 2, 7, 8, 2, 3], np.int64)
    sm, pm, pos = build_text_masks(ids.astype(np.int32), (1, 2, 3))
    ref = jgm.groundingdino_forward(jgc.convert_state_dict(sd, cfg), jnp.asarray(img),
                                    jnp.asarray(ids.astype(np.int32))[None], jnp.asarray(sm)[None],
                                    jnp.asarray(pm)[None], cfg, position_ids=jnp.asarray(pos.astype(np.int32))[None])
    ours = tgm.groundingdino_forward(model, torch.from_numpy(img), torch.from_numpy(ids)[None],
                                     torch.from_numpy(sm)[None], torch.from_numpy(pm)[None],
                                     torch.from_numpy(pos)[None])
    b, rb = ours["boxes"].numpy(), np.asarray(ref["boxes"])
    assert np.abs(b - rb).max() <= 1e-5 * np.abs(rb).max()


def test_gdino_missing_parameter_raises(gdino, tmp_path):
    _, params = gdino
    sd = convert.groundingdino_state_dict_from_numpy(jax.tree.map(np.asarray, params), tgm.TINY_GDINO)
    del sd["transformer.decoder.norm.weight"]
    torch.save({"model": sd}, tmp_path / "g.pth")
    with pytest.raises(RuntimeError, match="transformer.decoder.norm.weight"):
        tgc.load_converted(str(tmp_path / "g.pth"), tgm.TINY_GDINO, device="cpu")


def test_sam_convert_roundtrip_tiny(sam, tmp_path):
    """Port copy of tests/test_converters.py::test_sam_convert_roundtrip_tiny:
    the official file is a bare state dict holding, beside the parameters,
    the mask-prompt downscaler and the pixel statistics."""
    cfg, params = sam
    sd = convert.sam_state_dict_from_numpy(jax.tree.map(np.asarray, params), tsm.TINY)
    official = dict(sd)
    official["prompt_encoder.mask_downscaling.0.weight"] = torch.zeros(4, 1, 2, 2)
    official["pixel_mean"] = torch.tensor([123.675, 116.28, 103.53]).reshape(3, 1, 1)
    official["pixel_std"] = torch.tensor([58.395, 57.12, 57.375]).reshape(3, 1, 1)
    path = tmp_path / "sam.pth"
    torch.save(official, path)
    model = tsc.load_converted(str(path), tsm.TINY, device="cpu")
    loaded = model.state_dict()
    assert set(loaded) == set(sd)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)

    converted = jsc.convert_state_dict(sd, cfg)
    img = np.zeros((1, 3, cfg.img_size, cfg.img_size), np.float32)
    emb = jsm.sam_encode_image(converted, jnp.asarray(img), cfg)
    masks, _ = jsm.sam_predict_masks(converted, emb, jnp.array([[0.1, 0.1, 0.5, 0.5]]), cfg)
    temb = tsm.sam_encode_image(model, torch.from_numpy(img))
    tmasks, _ = tsm.sam_predict_masks(model, temb, torch.tensor([[0.1, 0.1, 0.5, 0.5]]))
    assert np.all(np.isfinite(tmasks.numpy()))
    assert np.abs(tmasks.numpy() - np.asarray(masks)).max() <= 1e-5 * np.abs(np.asarray(masks)).max()
