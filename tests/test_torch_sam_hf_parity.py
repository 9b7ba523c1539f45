"""Port copy of tests/test_sam_hf_parity.py: lvdgs_torch's SAM against
HuggingFace's SamModel, a tiny random-weight HF model renamed into the
official sam_vit layout (the inverse of HF's conversion) and loaded into
the port's module by name. Tolerance 1e-4 (the reference test's): the
image embedding and the IoU absolute, the mask logits relative to their
largest magnitude (at least 1)."""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from lvdgs_torch.models.sam.convert import module_state_dict  # noqa: E402
from lvdgs_torch.models.sam.model import SAM, SAMConfig, sam_encode_image, sam_predict_masks  # noqa: E402

import torch_parity  # noqa: E402,F401  (TF32 off, one intra-op thread)

CFG = SAMConfig(img_size=128, patch_size=16, dim=64, depth=2, heads=2, window=4, global_blocks=(1,),
                embed_dim=32, decoder_depth=2, decoder_heads=8, decoder_mlp=64, num_mask_tokens=4)


def _hf_model():
    from transformers import SamConfig, SamMaskDecoderConfig, SamModel, SamPromptEncoderConfig, SamVisionConfig

    vc = SamVisionConfig(hidden_size=CFG.dim, num_hidden_layers=CFG.depth, num_attention_heads=CFG.heads,
                         image_size=CFG.img_size, patch_size=CFG.patch_size, window_size=CFG.window,
                         global_attn_indexes=list(CFG.global_blocks), output_channels=CFG.embed_dim,
                         num_pos_feats=CFG.embed_dim // 2)
    pc = SamPromptEncoderConfig(hidden_size=CFG.embed_dim, image_embedding_size=CFG.img_size // CFG.patch_size,
                                image_size=CFG.img_size, patch_size=CFG.patch_size)
    mc = SamMaskDecoderConfig(hidden_size=CFG.embed_dim, num_hidden_layers=CFG.decoder_depth,
                              num_attention_heads=CFG.decoder_heads, mlp_dim=CFG.decoder_mlp,
                              iou_head_hidden_dim=CFG.embed_dim)  # the official ViT-B's, as the port's
    torch.manual_seed(0)
    m = SamModel(SamConfig(vision_config=vc.to_dict(), prompt_encoder_config=pc.to_dict(),
                           mask_decoder_config=mc.to_dict())).eval()
    # official SAM shares one PositionEmbeddingRandom between the image and
    # the prompts; HF holds two: tie them as a converted checkpoint would
    with torch.no_grad():
        m.shared_image_embedding.positional_embedding.copy_(m.prompt_encoder.shared_embedding.positional_embedding)
    return m


def _rename_hf_to_official(hf_sd: dict) -> dict:
    """HF's convert_sam_to_hf key mapping, inverted."""
    out = {}
    for k, v in hf_sd.items():
        nk = k
        if k.startswith("vision_encoder."):
            nk = k.replace("vision_encoder.", "image_encoder.").replace("patch_embed.projection", "patch_embed.proj")
            nk = nk.replace("layers.", "blocks.").replace("layer_norm1", "norm1").replace("layer_norm2", "norm2")
            nk = (nk.replace("neck.conv1", "neck.0").replace("neck.norm1", "neck.1")
                  .replace("neck.conv2", "neck.2").replace("neck.norm2", "neck.3"))
        elif k.startswith("prompt_encoder."):
            nk = k.replace("shared_embedding.positional_embedding", "pe_layer.positional_encoding_gaussian_matrix")
            nk = nk.replace(".point_embed.", ".point_embeddings.")
        elif k.startswith("mask_decoder."):
            for i in range(1, 5):
                nk = nk.replace(f"layer_norm{i}", f"norm{i}")
            nk = nk.replace("layer_norm_final_attn", "norm_final_attn")
            nk = (nk.replace("upscale_conv1", "output_upscaling.0").replace("upscale_layer_norm", "output_upscaling.1")
                  .replace("upscale_conv2", "output_upscaling.3"))
            # HF's 3-layer MLP: proj_in / layers.0 / proj_out
            if "output_hypernetworks_mlps" in nk or "iou_prediction_head" in nk:
                nk = nk.replace("layers.0", "layers.1").replace("proj_in", "layers.0").replace("proj_out", "layers.2")
        out[nk] = v
    return out


@pytest.fixture(scope="module")
def models():
    hf = _hf_model()
    model = SAM(CFG)
    model.load_state_dict(module_state_dict(_rename_hf_to_official(hf.state_dict()), model), strict=True)
    return hf, model.eval()


def test_image_encoder_parity(models):
    hf, model = models
    img = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 3, CFG.img_size, CFG.img_size))
                           .astype(np.float32))
    with torch.no_grad():
        ref = hf.vision_encoder(img).last_hidden_state
    ours = sam_encode_image(model, img)
    assert ours.shape == ref.shape
    assert float((ours - ref).abs().max()) < 1e-4


def test_full_forward_box_to_mask_parity(models):
    hf, model = models
    img = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, 3, CFG.img_size, CFG.img_size))
                           .astype(np.float32))
    boxes_px = np.array([[8.0, 12.0, 70.0, 90.0], [40.0, 5.0, 120.0, 60.0]], np.float32)
    with torch.no_grad():
        out = hf(pixel_values=img, input_boxes=torch.from_numpy(boxes_px[None]), multimask_output=True)
    ref_masks, ref_iou = out.pred_masks[0], out.iou_scores[0]  # (NB, 3, 4h, 4w), (NB, 3)
    masks, iou = sam_predict_masks(model, sam_encode_image(model, img),
                                   torch.from_numpy((boxes_px + 0.5) / CFG.img_size))
    ours_masks, ours_iou = masks[:, 1:4], iou[:, 1:4]  # the multimask tokens
    assert ours_masks.shape == ref_masks.shape
    scale = max(1.0, float(ref_masks.abs().max()))
    assert float((ours_masks - ref_masks).abs().max()) / scale < 1e-4
    assert float((ours_iou - ref_iou).abs().max()) < 1e-4
