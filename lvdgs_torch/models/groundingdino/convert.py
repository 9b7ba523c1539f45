"""GroundingDINO checkpoints -> the port's GroundingDINO (PyTorch port of
``lvdgs_tpu/models/groundingdino/convert.py``).

The module's parameter names are the official checkpoint's
(groundingdino_swint_ogc.pth: `backbone.0.*`, `bert.*`, `transformer.*`,
`input_proj.*`, `feat_map`, `bbox_embed.0.*`), so an official state dict
loads as it is: a leading `module.` is stripped, a `bert.bert.` prefix
read as `bert.`, and the keys that no parameter reads (BERT's pooler, the
class heads, the duplicated shared box heads, buffers) are dropped, as the
reference's converter skips them; every parameter must be given. A
HuggingFace `GroundingDinoForObjectDetection` state dict is renamed into
the official layout first (`convert_hf_state_dict`), when its keys show it.
"""
from __future__ import annotations

import argparse
import warnings
from typing import Dict, Optional

import torch
import torch.nn as nn

from .model import GroundingDINO, GroundingDINOConfig


def normalize_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """Arrays or tensors -> CPU tensors; a leading 'module.' stripped."""
    return {(k[7:] if k.startswith("module.") else k): torch.as_tensor(v).detach().cpu()
            for k, v in sd.items()}


def module_state_dict(sd: Dict, model: GroundingDINO) -> Dict[str, torch.Tensor]:
    """An official-layout state dict cut to `model`'s keys (see the module
    docstring); a key of `model` that it lacks stays missing, for
    load_state_dict to report."""
    sd = normalize_state_dict(sd)
    if "bert.bert.embeddings.word_embeddings.weight" in sd:
        sd = {("bert." + k[10:] if k.startswith("bert.bert.") else k): v for k, v in sd.items()}
    keys = model.state_dict().keys()
    return {k: v for k, v in sd.items() if k in keys}


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint file (official: under "model"; or a
    bare one), read with weights_only=True. The one class besides tensors
    that a training checkpoint of this family pickles, argparse.Namespace
    (its "args"), is allowed by name. HF layouts come back renamed."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    if any(k.startswith("model.backbone.conv_encoder") for k in sd):
        sd = convert_hf_state_dict(sd)
    return sd


def load_converted(path: str, cfg: Optional[GroundingDINOConfig] = None, device=None) -> GroundingDINO:
    """The checkpoint at `path` as a GroundingDINO on `device` (the card
    when None; eval mode). Raises when a parameter is missing or of
    another shape."""
    from ...slam.system import resolve_device

    device = resolve_device(device)
    with torch.device("meta"):
        model = GroundingDINO(cfg or GroundingDINOConfig())
    sd = module_state_dict(read_checkpoint(path), model)
    with torch.device("meta"):
        for i, layer in enumerate(model.transformer.encoder.text_layers):
            # the text enhancer's FFN at the width the file holds, as the
            # reference's linears take it (the init sizes it at `ffn`; the
            # official GroundingDINO and HF's port use ffn / 2, ROADMAP C13)
            w = sd.get(f"transformer.encoder.text_layers.{i}.linear1.weight")
            if w is not None and w.shape[0] != layer.linear1.out_features:
                layer.linear1 = nn.Linear(layer.linear1.in_features, w.shape[0])
                layer.linear2 = nn.Linear(w.shape[0], layer.linear2.out_features)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device).eval()


def _rename_hf_swin_backbone(hf_sd: Dict, prefix: str) -> Dict:
    """HF Swin(Backbone) layout -> the official GroundingDINO Swin layout
    under `prefix` (e.g. 'backbone.0'), HF's split q/k/v fused into the
    official packed qkv."""
    out = {}
    qkv: Dict = {}
    for k, v in hf_sd.items():
        if "relative_position_index" in k or k.startswith("pooler"):
            continue
        nk = k
        nk = nk.replace("embeddings.patch_embeddings.projection", "patch_embed.proj")
        nk = nk.replace("embeddings.norm", "patch_embed.norm")
        nk = nk.replace("encoder.layers.", "layers.")
        nk = nk.replace("layernorm_before", "norm1").replace("layernorm_after", "norm2")
        nk = nk.replace("attention.output.dense", "attn.proj")
        nk = nk.replace("attention.self.relative_position_bias_table", "attn.relative_position_bias_table")
        nk = nk.replace("intermediate.dense", "mlp.fc1")
        nk = nk.replace("output.dense", "mlp.fc2")
        if "hidden_states_norms.stage" in nk:
            si = int(nk.split("hidden_states_norms.stage")[1].split(".")[0]) - 1
            out[f"{prefix}.norm{si}.{nk.rsplit('.', 1)[1]}"] = v
            continue
        part = None
        for p in ("query", "key", "value"):
            if f"attention.self.{p}" in nk:
                part = p
        if part is not None:
            base = nk.split(".attention.self.")[0]
            kind = nk.rsplit(".", 1)[1]
            qkv.setdefault((base, kind), {})[part] = torch.as_tensor(v)
        else:
            out[f"{prefix}.{nk}"] = v
    for (base, kind), parts in qkv.items():
        out[f"{prefix}.{base}.attn.qkv.{kind}"] = torch.cat([parts["query"], parts["key"], parts["value"]])
    return out


def convert_hf_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """HuggingFace `GroundingDinoForObjectDetection` layout -> the official
    groundingdino_swint_ogc.pth layout: lets HF-hub checkpoints
    (IDEA-Research/grounding-dino-tiny) drive the port. HF's split q/k/v
    attentions are packed back into torch MultiheadAttention's in_proj."""
    sd = normalize_state_dict(sd)
    out: Dict = {}
    packed: Dict = {}

    def pack(dst: str, part: str, kind: str, v):
        packed.setdefault((dst, kind), {})[part] = v

    swin_sub = {}
    for k, v in sd.items():
        if "position_ids" in k:
            continue
        if k.startswith("model.backbone.conv_encoder.model."):
            swin_sub[k[len("model.backbone.conv_encoder.model."):]] = v
            continue
        if k.startswith("model.text_backbone."):
            out["bert." + k[len("model.text_backbone."):]] = v
            continue
        if k.startswith("model.text_projection."):
            out[k.replace("model.text_projection", "feat_map")] = v
            continue
        if k.startswith("model.input_proj_vision."):
            out[k.replace("model.input_proj_vision", "input_proj")] = v
            continue
        if k == "model.level_embed":
            out["transformer.level_embed"] = v
            continue
        if k.startswith("model.encoder.layers."):
            i = k.split(".")[3]
            rest = k.split(f"model.encoder.layers.{i}.")[1]
            if rest.startswith("deformable_layer."):
                r = rest[len("deformable_layer."):]
                r = (r.replace("self_attn_layer_norm", "norm1").replace("final_layer_norm", "norm2")
                     .replace("fc1", "linear1").replace("fc2", "linear2"))
                out[f"transformer.encoder.layers.{i}.{r}"] = v
            elif rest.startswith("text_enhancer_layer."):
                r = rest[len("text_enhancer_layer."):]
                dst = f"transformer.encoder.text_layers.{i}"
                done = False
                for p in ("query", "key", "value"):
                    if r.startswith(f"self_attn.{p}."):
                        pack(f"{dst}.self_attn", p, r.rsplit(".", 1)[1], v)
                        done = True
                if done:
                    continue
                r = (r.replace("layer_norm_before", "norm1").replace("layer_norm_after", "norm2")
                     .replace("fc1", "linear1").replace("fc2", "linear2"))
                out[f"{dst}.{r}"] = v
            elif rest.startswith("fusion_layer."):
                r = rest[len("fusion_layer."):]
                r = (r.replace("layer_norm_vision", "layer_norm_v")
                     .replace("layer_norm_text", "layer_norm_l")
                     .replace("attn.vision_proj", "attn.v_proj")
                     .replace("attn.text_proj", "attn.l_proj")
                     .replace("attn.values_vision_proj", "attn.values_v_proj")
                     .replace("attn.values_text_proj", "attn.values_l_proj")
                     .replace("attn.out_vision_proj", "attn.out_v_proj")
                     .replace("attn.out_text_proj", "attn.out_l_proj")
                     .replace("vision_param", "gamma_v")
                     .replace("text_param", "gamma_l"))
                out[f"transformer.encoder.fusion_layers.{i}.{r}"] = v
            continue
        if k.startswith("model.decoder.layers."):
            i = k.split(".")[3]
            rest = k.split(f"model.decoder.layers.{i}.")[1]
            dst = f"transformer.decoder.layers.{i}"
            done = False
            for attn, official in (("self_attn.", "self_attn"), ("encoder_attn_text.", "ca_text")):
                if rest.startswith(attn):
                    r = rest[len(attn):]
                    p = r.split(".")[0]
                    if p in ("query", "key", "value"):
                        pack(f"{dst}.{official}", p, r.rsplit(".", 1)[1], v)
                    else:  # out_proj
                        out[f"{dst}.{official}.{r}"] = v
                    done = True
                    break
            if done:
                continue
            r = (rest.replace("self_attn_layer_norm", "norm2")
                 .replace("encoder_attn_text_layer_norm", "catext_norm")
                 .replace("encoder_attn_layer_norm", "norm1")
                 .replace("encoder_attn", "cross_attn")
                 .replace("final_layer_norm", "norm3")
                 .replace("fc1", "linear1")
                 .replace("fc2", "linear2"))
            out[f"{dst}.{r}"] = v
            continue
        if k.startswith("model.decoder.bbox_embed.") or k.startswith("model.decoder.class_embed"):
            continue  # tied duplicates of the top-level shared heads
        if k.startswith("model.decoder.reference_points_head."):
            out[k.replace("model.decoder.reference_points_head", "transformer.decoder.ref_point_head")] = v
            continue
        if k.startswith("model.decoder.layer_norm."):
            out[k.replace("model.decoder.layer_norm", "transformer.decoder.norm")] = v
            continue
        if k.startswith("model.enc_output_norm."):
            out[k.replace("model.enc_output_norm", "transformer.enc_output_norm")] = v
            continue
        if k.startswith("model.enc_output."):
            out[k.replace("model.enc_output", "transformer.enc_output")] = v
            continue
        if k.startswith("model.encoder_output_bbox_embed."):
            out[k.replace("model.encoder_output_bbox_embed", "transformer.enc_out_bbox_embed")] = v
            continue
        if k == "model.query_position_embeddings.weight":
            out["transformer.tgt_embed.weight"] = v
            continue
        if k.startswith("bbox_embed."):
            out[k] = v  # the same layout (shared heads: index 0 is read)
            continue
        warnings.warn(f"convert_hf_state_dict: unmapped key {k}")
    for (dst, kind), parts in packed.items():
        out[f"{dst}.in_proj_{kind}"] = torch.cat([parts["query"], parts["key"], parts["value"]])
    out.update(_rename_hf_swin_backbone(swin_sub, "backbone.0"))
    return out
