"""Port copy of tests/test_swin_bert_hf_parity.py: lvdgs_torch's Swin-T and
BERT against the installed HuggingFace implementations, tiny random-weight
HF models whose state dicts are renamed into the official GroundingDINO
layout and loaded into the port's modules by name. Tolerance 1e-4 (the
reference test's): BERT absolute on the real tokens, Swin relative to each
map's largest magnitude (at least 1)."""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from lvdgs_torch.models.groundingdino.bert import BertConfig, BertModel  # noqa: E402
from lvdgs_torch.models.groundingdino.convert import _rename_hf_swin_backbone  # noqa: E402
from lvdgs_torch.models.groundingdino.swin import SwinConfig, SwinTransformer  # noqa: E402

import torch_parity  # noqa: E402,F401  (TF32 off, one intra-op thread)

BCFG = BertConfig(vocab_size=99, dim=32, layers=3, heads=2, mlp=64, max_pos=48)
SCFG = SwinConfig(embed_dim=16, depths=(1, 2, 2, 1), heads=(1, 2, 4, 8), window=2, patch_size=4,
                  out_indices=(1, 2, 3))


def load_by_name(module: torch.nn.Module, sd: dict, prefix: str = "") -> torch.nn.Module:
    """`sd`'s keys under `prefix` that name a parameter of `module`, loaded
    strictly (every parameter must be given)."""
    keys = module.state_dict().keys()
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                            if k.startswith(prefix) and k[len(prefix):] in keys}, strict=True)
    return module.eval()


def test_bert_full_forward_hf_parity():
    from transformers import BertConfig as HFBertConfig
    from transformers import BertModel as HFBertModel

    torch.manual_seed(0)
    hf = HFBertModel(HFBertConfig(vocab_size=BCFG.vocab_size, hidden_size=BCFG.dim,
                                  num_hidden_layers=BCFG.layers, num_attention_heads=BCFG.heads,
                                  intermediate_size=BCFG.mlp, max_position_embeddings=BCFG.max_pos)).eval()
    ours = load_by_name(BertModel(BCFG), {f"bert.{k}": v for k, v in hf.state_dict().items()}, "bert.")

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, BCFG.vocab_size, (2, 11)).astype(np.int64))
    mask = np.ones((2, 11), bool)
    mask[1, 7:] = False  # ragged padding
    mask = torch.from_numpy(mask)
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        out = ours(ids, mask)
    # padded rows attend through a fully masked row in ours: real tokens only
    err = (out - ref).abs()[mask]
    assert float(err.max()) < 1e-4, float(err.max())


def test_swin_full_forward_hf_parity():
    from transformers import SwinConfig as HFSwinConfig
    from transformers.models.swin.modeling_swin import SwinBackbone

    torch.manual_seed(0)
    hf = SwinBackbone(HFSwinConfig(
        image_size=64, patch_size=SCFG.patch_size, embed_dim=SCFG.embed_dim, depths=list(SCFG.depths),
        num_heads=list(SCFG.heads), window_size=SCFG.window, mlp_ratio=SCFG.mlp_ratio, drop_path_rate=0.0,
        out_features=[f"stage{i + 1}" for i in SCFG.out_indices])).eval()
    ours = load_by_name(SwinTransformer(SCFG), _rename_hf_swin_backbone(hf.state_dict(), "backbone.0"),
                        "backbone.0.")

    img = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        ref = hf(img).feature_maps
        out = ours(img)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.shape == r.shape, (o.shape, r.shape)
        scale = max(1.0, float(r.abs().max()))
        assert float((o - r).abs().max()) / scale < 1e-4
