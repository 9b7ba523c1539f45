"""Port copy of tests/test_gdino_full_hf_parity.py: lvdgs_torch's whole
GroundingDINO forward (backbone, BERT, fusion encoder, two-stage
selection, decoder, ContrastiveEmbed) against HuggingFace's
GroundingDinoForObjectDetection with tiny matched configs. HF's random
weights reach the port as an HF-layout checkpoint file through the port's
own loader (convert.load_converted renames it with convert_hf_state_dict).
Tolerance 1e-4 (the reference test's): boxes absolute, logits relative to
their largest magnitude (at least 1)."""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from lvdgs_torch.models.groundingdino.bert import BertConfig  # noqa: E402
from lvdgs_torch.models.groundingdino.convert import load_converted  # noqa: E402
from lvdgs_torch.models.groundingdino.inference import build_text_masks  # noqa: E402
from lvdgs_torch.models.groundingdino.model import GroundingDINOConfig, groundingdino_forward  # noqa: E402
from lvdgs_torch.models.groundingdino.swin import SwinConfig  # noqa: E402

import torch_parity  # noqa: E402,F401  (TF32 off, one intra-op thread)

# HF hardcodes the special token ids of the real BERT vocab
CLS, SEP, DOT = 101, 102, 1012

CFG = GroundingDINOConfig(
    swin=SwinConfig(embed_dim=16, depths=(1, 2, 2, 1), heads=(1, 2, 4, 8), window=2, patch_size=4,
                    out_indices=(1, 2, 3)),
    bert=BertConfig(vocab_size=2000, dim=32, layers=2, heads=2, mlp=64, max_pos=64),
    dim=32, heads=2, enc_layers=2, dec_layers=2, ffn=64, num_queries=12, n_levels=4, n_points=2,
    max_text_len=32,
)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from transformers import BertConfig as HFBertConfig
    from transformers import GroundingDinoConfig, GroundingDinoForObjectDetection
    from transformers import SwinConfig as HFSwinConfig

    swin = HFSwinConfig(image_size=128, patch_size=CFG.swin.patch_size, embed_dim=CFG.swin.embed_dim,
                        depths=list(CFG.swin.depths), num_heads=list(CFG.swin.heads),
                        window_size=CFG.swin.window, drop_path_rate=0.0,
                        out_features=[f"stage{i + 1}" for i in CFG.swin.out_indices])
    bert = HFBertConfig(vocab_size=CFG.bert.vocab_size, hidden_size=CFG.bert.dim,
                        num_hidden_layers=CFG.bert.layers, num_attention_heads=CFG.bert.heads,
                        intermediate_size=CFG.bert.mlp, max_position_embeddings=CFG.bert.max_pos)
    cfg = GroundingDinoConfig(
        backbone_config=swin, text_config=bert, num_queries=CFG.num_queries, encoder_layers=CFG.enc_layers,
        decoder_layers=CFG.dec_layers, encoder_ffn_dim=CFG.ffn, decoder_ffn_dim=CFG.ffn,
        encoder_attention_heads=CFG.heads, decoder_attention_heads=CFG.heads, d_model=CFG.dim,
        num_feature_levels=CFG.n_levels, encoder_n_points=CFG.n_points, decoder_n_points=CFG.n_points,
        max_text_len=CFG.max_text_len, dropout=0.0)
    torch.manual_seed(0)
    hf = GroundingDinoForObjectDetection(cfg).eval()
    path = tmp_path_factory.mktemp("hf") / "grounding_dino_hf.pth"
    torch.save(hf.state_dict(), path)
    return hf, load_converted(str(path), CFG, device="cpu")


def test_full_forward_parity(models):
    hf, model = models
    img = np.random.default_rng(0).normal(size=(1, 3, 128, 128)).astype(np.float32)
    ids = np.array([[CLS, 400, 500, DOT, 600, 700, DOT, SEP]], np.int64)
    with torch.no_grad():
        out = hf(pixel_values=torch.from_numpy(img), input_ids=torch.from_numpy(ids),
                 attention_mask=torch.ones_like(torch.from_numpy(ids)))
    ref_logits, ref_boxes = out.logits[0].numpy(), out.pred_boxes[0].numpy()

    self_mask, pad_mask, position_ids = build_text_masks(ids[0], (CLS, SEP, DOT))
    ours = groundingdino_forward(model, torch.from_numpy(img), torch.from_numpy(ids),
                                 torch.from_numpy(self_mask)[None], torch.from_numpy(pad_mask)[None],
                                 torch.from_numpy(position_ids)[None])
    our_logits, our_boxes = ours["logits"][0].numpy(), ours["boxes"][0].numpy()
    assert our_boxes.shape == ref_boxes.shape
    assert np.abs(our_boxes - ref_boxes).max() < 1e-4, np.abs(our_boxes - ref_boxes).max()
    fin = np.isfinite(ref_logits)
    np.testing.assert_array_equal(np.isfinite(our_logits), fin)
    scale = max(1.0, float(np.abs(ref_logits[fin]).max()))
    err = np.abs(our_logits[fin] - ref_logits[fin]).max() / scale
    assert err < 1e-4, err
