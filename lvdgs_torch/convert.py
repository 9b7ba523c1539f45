"""State conversion between the reference package and this one.

Takes the reference package's state as NumPy arrays (``np.asarray`` of each
JAX leaf) and builds this package's dataclasses on a device, and goes back
to NumPy for slot-by-slot comparison. Covers the Gaussian map with its
active mask, the Adam moments and step, the keyframe buffer and cameras,
and the MASt3R, GroundingDINO, SAM and DINOv2 networks' parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .core.camera import Camera
from .gaussian.model import PARAM_FIELDS, AdamState, GaussianMap
from .slam.state import KeyframeBuffer


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gaussian_map_from_numpy(fields: Dict[str, np.ndarray], device) -> GaussianMap:
    """`fields` maps every GaussianMap field name to an array."""
    return GaussianMap(**{f.name: _t(fields[f.name], device) for f in dataclasses.fields(GaussianMap)})


def gaussian_map_to_numpy(gmap: GaussianMap) -> Dict[str, np.ndarray]:
    return {f.name: _np(getattr(gmap, f.name)) for f in dataclasses.fields(GaussianMap)}


def adam_state_from_numpy(m: Dict[str, np.ndarray], v: Dict[str, np.ndarray], count, device) -> AdamState:
    return AdamState(
        m={f: _t(m[f], device) for f in PARAM_FIELDS},
        v={f: _t(v[f], device) for f in PARAM_FIELDS},
        count=int(np.asarray(count)),
    )


def adam_state_to_numpy(state: AdamState) -> dict:
    return {
        "m": {f: _np(state.m[f]) for f in PARAM_FIELDS},
        "v": {f: _np(state.v[f]) for f in PARAM_FIELDS},
        "count": int(state.count),
    }


def keyframe_buffer_from_numpy(fields: Dict[str, np.ndarray], device) -> KeyframeBuffer:
    """`fields` maps every KeyframeBuffer field name to an array; `count`
    becomes a host integer."""
    kw = {
        f.name: _t(fields[f.name], device)
        for f in dataclasses.fields(KeyframeBuffer) if f.name != "count"
    }
    return KeyframeBuffer(count=int(np.asarray(fields["count"])), **kw)


def keyframe_buffer_to_numpy(buf: KeyframeBuffer) -> Dict[str, np.ndarray]:
    out = {f.name: _np(getattr(buf, f.name)) for f in dataclasses.fields(KeyframeBuffer)
           if f.name != "count"}
    out["count"] = np.asarray(buf.count, np.int32)
    return out


def camera_from_numpy(fields: Dict[str, np.ndarray], device) -> Camera:
    """`fields` maps the Camera field names to arrays (the reference's
    learnable pose-delta fields, always zero there, are ignored)."""
    kw = {}
    for f in dataclasses.fields(Camera):
        v = fields[f.name]
        if f.name == "uid":
            kw[f.name] = int(np.asarray(v))
        elif f.name == "has_static_mask":
            kw[f.name] = bool(np.asarray(v))
        else:
            kw[f.name] = _t(v, device)
    return Camera(**kw)


def camera_to_numpy(cam: Camera) -> Dict[str, np.ndarray]:
    return {f.name: _np(getattr(cam, f.name)) for f in dataclasses.fields(Camera)}


def mast3r_state_dict_from_numpy(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """The reference's MASt3R parameters (its init_params or converter
    output, as NumPy: nested dicts and lists) as the state_dict of
    lvdgs_torch.models.mast3r.MASt3R under the official checkpoint's names;
    the inverse of the reference's convert_state_dict. Linear weights go
    back from (in, out) to (out, in); convolutions keep their arrays."""
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix, p, transpose=False):
        w = np.asarray(p["weight"])
        sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T if transpose else w))
        if "bias" in p:
            sd[f"{prefix}.bias"] = torch.from_numpy(np.array(p["bias"]))

    def put_block(prefix, blk, linears):
        for name in ("norm1", "norm2", "norm3", "norm_y"):
            if name in blk:
                put(f"{prefix}.{name}", blk[name])
        for path in linears:
            p = blk
            for part in path.split("."):
                p = p[part]
            put(f"{prefix}.{path}", p, transpose=True)

    put("patch_embed.proj", params["patch_embed"]["proj"])
    put("enc_norm", params["enc_norm"])
    put("dec_norm", params["dec_norm"])
    put("decoder_embed", params["decoder_embed"], transpose=True)
    for i, blk in enumerate(params["enc_blocks"][:cfg.enc_depth]):
        put_block(f"enc_blocks.{i}", blk, ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"))
    cross = tuple(f"cross_attn.{q}" for q in ("projq", "projk", "projv", "proj"))
    for name in ("dec_blocks", "dec_blocks2"):
        for i, blk in enumerate(params[name][:cfg.dec_depth]):
            put_block(f"{name}.{i}", blk, ("attn.qkv", "attn.proj", *cross, "mlp.fc1", "mlp.fc2"))
    for n, h in (("downstream_head1", "head1"), ("downstream_head2", "head2")):
        dpt, pre = params[h]["dpt"], f"{n}.dpt"
        for i in range(4):
            put(f"{pre}.act_postprocess.{i}.0", dpt["proj"][i])
            put(f"{pre}.scratch.layer{i + 1}_rn", dpt["scratch"][i])
            rp, ref = f"{pre}.scratch.refinenet{i + 1}", dpt["refine"][i]
            for unit, key in (("resConfUnit1", "rcu1"), ("resConfUnit2", "rcu2")):
                put(f"{rp}.{unit}.conv1", ref[key]["conv1"])
                put(f"{rp}.{unit}.conv2", ref[key]["conv2"])
            put(f"{rp}.out_conv", ref["out_conv"])
        for i in (0, 1, 3):
            put(f"{pre}.act_postprocess.{i}.1", dpt["resample"][i])
        for idx, key in ((0, "conv1"), (2, "conv2"), (4, "conv3")):
            put(f"{pre}.head.{idx}", dpt["head"][key])
        for fc in ("fc1", "fc2"):
            put(f"{n}.head_local_features.{fc}", params[h]["local_features"][fc], transpose=True)
    return sd


def groundingdino_state_dict_from_numpy(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """The reference's GroundingDINO parameters (its init_params or
    converter output, as NumPy) as the state_dict of
    lvdgs_torch.models.groundingdino.GroundingDINO under the official
    checkpoint's names; the inverse of the reference's convert_state_dict.
    Linear weights go back from (in, out) to (out, in), the attentions' q,
    k and v into the packed in_proj."""
    sd: Dict[str, torch.Tensor] = {}

    def raw(key, x):
        sd[key] = torch.from_numpy(np.array(x, np.float32))

    def lin(prefix, p):
        raw(f"{prefix}.weight", np.asarray(p["weight"]).T)
        if "bias" in p:
            raw(f"{prefix}.bias", p["bias"])

    def ln(prefix, p):
        raw(f"{prefix}.weight", p["weight"])
        raw(f"{prefix}.bias", p["bias"])

    def mha(prefix, p):
        raw(f"{prefix}.in_proj_weight", np.concatenate([np.asarray(p[k]["weight"]).T for k in "qkv"]))
        raw(f"{prefix}.in_proj_bias", np.concatenate([np.asarray(p[k]["bias"]) for k in "qkv"]))
        lin(f"{prefix}.out_proj", p["out"])

    def deform(prefix, p):
        for ours, theirs in (("sampling_offsets", "sampling_offsets"), ("attn_weights", "attention_weights"),
                             ("value_proj", "value_proj"), ("output_proj", "output_proj")):
            lin(f"{prefix}.{theirs}", p[ours])

    def ffn(prefix, p, norm):
        lin(f"{prefix}.linear1", p["fc1"])
        lin(f"{prefix}.linear2", p["fc2"])
        ln(f"{prefix}.{norm}", p["ln"])

    bb, sw = "backbone.0", params["backbone"]
    raw(f"{bb}.patch_embed.proj.weight", sw["patch_embed"]["weight"])
    raw(f"{bb}.patch_embed.proj.bias", sw["patch_embed"]["bias"])
    ln(f"{bb}.patch_embed.norm", sw["patch_norm"])
    for si, stage in enumerate(sw["stages"]):
        for bi, b in enumerate(stage["blocks"]):
            pre = f"{bb}.layers.{si}.blocks.{bi}"
            ln(f"{pre}.norm1", b["norm1"])
            lin(f"{pre}.attn.qkv", b["attn"]["qkv"])
            lin(f"{pre}.attn.proj", b["attn"]["proj"])
            raw(f"{pre}.attn.relative_position_bias_table", b["attn"]["rel_pos_bias"])
            ln(f"{pre}.norm2", b["norm2"])
            lin(f"{pre}.mlp.fc1", b["mlp"]["fc1"])
            lin(f"{pre}.mlp.fc2", b["mlp"]["fc2"])
        if "downsample" in stage:
            ln(f"{bb}.layers.{si}.downsample.norm", stage["downsample"]["norm"])
            lin(f"{bb}.layers.{si}.downsample.reduction", stage["downsample"]["reduction"])
    for si, p in sw["out_norms"].items():
        ln(f"{bb}.norm{si}", p)

    bert = params["bert"]
    raw("bert.embeddings.word_embeddings.weight", bert["word_emb"])
    raw("bert.embeddings.position_embeddings.weight", bert["pos_emb"])
    raw("bert.embeddings.token_type_embeddings.weight", bert["type_emb"])
    ln("bert.embeddings.LayerNorm", bert["emb_ln"])
    for i, b in enumerate(bert["layers"]):
        pre = f"bert.encoder.layer.{i}"
        for ours, theirs in (("q", "attention.self.query"), ("k", "attention.self.key"),
                             ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
                             ("fc1", "intermediate.dense"), ("fc2", "output.dense")):
            lin(f"{pre}.{theirs}", b[ours])
        ln(f"{pre}.attention.output.LayerNorm", b["attn_ln"])
        ln(f"{pre}.output.LayerNorm", b["out_ln"])

    lin("feat_map", params["feat_map"])
    for i, p in enumerate(params["input_proj"]):
        raw(f"input_proj.{i}.0.weight", p["weight"])
        raw(f"input_proj.{i}.0.bias", p["bias"])
        ln(f"input_proj.{i}.1", p["gn"])
    tr = "transformer"
    raw(f"{tr}.level_embed", params["level_embed"])
    for i, e in enumerate(params["enc_layers"][:cfg.enc_layers]):
        f = f"{tr}.encoder.fusion_layers.{i}"
        fu = e["fusion"]
        ln(f"{f}.layer_norm_v", fu["ln_v"])
        ln(f"{f}.layer_norm_l", fu["ln_l"])
        for ours, theirs in (("v_proj", "v_proj"), ("l_proj", "l_proj"), ("values_v", "values_v_proj"),
                             ("values_l", "values_l_proj"), ("out_v", "out_v_proj"), ("out_l", "out_l_proj")):
            lin(f"{f}.attn.{theirs}", fu[ours])
        raw(f"{f}.gamma_v", fu["gamma_v"])
        raw(f"{f}.gamma_l", fu["gamma_l"])
        t = f"{tr}.encoder.text_layers.{i}"
        mha(f"{t}.self_attn", e["text_attn"])
        ln(f"{t}.norm1", e["text_ln1"])
        ffn(t, e["text_ffn"], "norm2")
        el = f"{tr}.encoder.layers.{i}"
        deform(f"{el}.self_attn", e["deform"])
        ln(f"{el}.norm1", e["img_ln1"])
        ffn(el, e["img_ffn"], "norm2")
    lin(f"{tr}.enc_output", params["enc_output"])
    ln(f"{tr}.enc_output_norm", params["enc_output_ln"])
    for j, p in enumerate(params["enc_bbox"]):
        lin(f"{tr}.enc_out_bbox_embed.layers.{j}", p)
    raw(f"{tr}.tgt_embed.weight", params["tgt_embed"])
    for j, p in enumerate(params["ref_point_head"]):
        lin(f"{tr}.decoder.ref_point_head.layers.{j}", p)
    for i, d in enumerate(params["dec_layers"][:cfg.dec_layers]):
        pre = f"{tr}.decoder.layers.{i}"
        mha(f"{pre}.self_attn", d["self_attn"])
        ln(f"{pre}.norm2", d["ln1"])
        mha(f"{pre}.ca_text", d["text_cross"])
        ln(f"{pre}.catext_norm", d["ln2"])
        deform(f"{pre}.cross_attn", d["deform"])
        ln(f"{pre}.norm1", d["ln3"])
        ffn(pre, d["ffn"], "norm3")
    ln(f"{tr}.decoder.norm", params["dec_norm"])
    for j, p in enumerate(params["bbox_embed"]):
        lin(f"bbox_embed.0.layers.{j}", p)
    return sd


def sam_state_dict_from_numpy(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """The reference's SAM parameters (its init_params or converter
    output, as NumPy) as the state_dict of lvdgs_torch.models.sam.SAM under
    the official checkpoint's names; the inverse of the reference's
    convert_state_dict. Linear weights go back to (out, in), token vectors
    to one-row embedding tables."""
    sd: Dict[str, torch.Tensor] = {}

    def raw(key, x):
        sd[key] = torch.from_numpy(np.array(x, np.float32))

    def lin(prefix, p):
        raw(f"{prefix}.weight", np.asarray(p["weight"]).T)
        if "bias" in p:
            raw(f"{prefix}.bias", p["bias"])

    def put(prefix, p):
        for k, v in p.items():
            raw(f"{prefix}.{k}", v)

    def attn(prefix, p):
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{prefix}.{name}", p[name])

    ie, pre = params["image_encoder"], "image_encoder"
    put(f"{pre}.patch_embed.proj", ie["patch_embed"])
    raw(f"{pre}.pos_embed", ie["pos_embed"])
    for i, b in enumerate(ie["blocks"][:cfg.depth]):
        p = f"{pre}.blocks.{i}"
        put(f"{p}.norm1", b["norm1"])
        lin(f"{p}.attn.qkv", b["attn"]["qkv"])
        lin(f"{p}.attn.proj", b["attn"]["proj"])
        raw(f"{p}.attn.rel_pos_h", b["attn"]["rel_pos_h"])
        raw(f"{p}.attn.rel_pos_w", b["attn"]["rel_pos_w"])
        put(f"{p}.norm2", b["norm2"])
        lin(f"{p}.mlp.lin1", b["mlp"]["fc1"])
        lin(f"{p}.mlp.lin2", b["mlp"]["fc2"])
    for idx, key in enumerate(("conv1", "ln1", "conv2", "ln2")):
        put(f"{pre}.neck.{idx}", ie["neck"][key])

    pe = params["prompt_encoder"]
    raw("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix", pe["pe_gaussian"])
    for i in range(4):
        raw(f"prompt_encoder.point_embeddings.{i}.weight", np.asarray(pe["point_embeddings"])[i][None])
    raw("prompt_encoder.not_a_point_embed.weight", np.asarray(pe["not_a_point"])[None])
    raw("prompt_encoder.no_mask_embed.weight", np.asarray(pe["no_mask_embed"])[None])

    md, pre = params["mask_decoder"], "mask_decoder"
    raw(f"{pre}.iou_token.weight", np.asarray(md["iou_token"])[None])
    raw(f"{pre}.mask_tokens.weight", md["mask_tokens"])
    for i, b in enumerate(md["blocks"][:cfg.decoder_depth]):
        p = f"{pre}.transformer.layers.{i}"
        attn(f"{p}.self_attn", b["self_attn"])
        put(f"{p}.norm1", b["norm1"])
        attn(f"{p}.cross_attn_token_to_image", b["cross_attn_t2i"])
        put(f"{p}.norm2", b["norm2"])
        lin(f"{p}.mlp.lin1", b["mlp"]["fc1"])
        lin(f"{p}.mlp.lin2", b["mlp"]["fc2"])
        put(f"{p}.norm3", b["norm3"])
        attn(f"{p}.cross_attn_image_to_token", b["cross_attn_i2t"])
        put(f"{p}.norm4", b["norm4"])
    attn(f"{pre}.transformer.final_attn_token_to_image", md["final_attn"])
    put(f"{pre}.transformer.norm_final_attn", md["norm_final"])
    for idx, key in ((0, "conv1"), (1, "ln"), (3, "conv2")):
        put(f"{pre}.output_upscaling.{idx}", md["upscale"][key])
    for i, mlps in enumerate(md["hyper_mlps"]):
        for j, p in enumerate(mlps):
            lin(f"{pre}.output_hypernetworks_mlps.{i}.layers.{j}", p)
    for j, p in enumerate(md["iou_mlp"]):
        lin(f"{pre}.iou_prediction_head.layers.{j}", p)
    return sd


def dinov2_state_dict_from_numpy(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """The reference's DINOv2 parameters (its init_params or
    convert_state_dict output, as NumPy) as the state_dict of
    lvdgs_torch.models.dinov2.DINOv2 under the torch.hub names; linear
    weights go back from (in, out) to (out, in)."""
    def arr(x, transpose=False):
        x = np.array(x, np.float32)
        return torch.from_numpy(np.ascontiguousarray(x.T if transpose else x))

    sd = {"cls_token": arr(params["cls_token"]), "pos_embed": arr(params["pos_embed"]),
          "patch_embed.proj.weight": arr(params["patch_embed"]["weight"]),
          "patch_embed.proj.bias": arr(params["patch_embed"]["bias"]),
          "norm.weight": arr(params["norm"]["weight"]), "norm.bias": arr(params["norm"]["bias"])}
    names = {"norm1": "norm1", "qkv": "attn.qkv", "proj": "attn.proj", "norm2": "norm2", "fc1": "mlp.fc1",
             "fc2": "mlp.fc2"}
    for i, blk in enumerate(params["blocks"][:cfg.depth]):
        for key, name in names.items():
            linear = not key.startswith("norm")
            sd[f"blocks.{i}.{name}.weight"] = arr(blk[key]["weight"], transpose=linear)
            sd[f"blocks.{i}.{name}.bias"] = arr(blk[key]["bias"])
        sd[f"blocks.{i}.ls1.gamma"] = arr(blk["ls1"])
        sd[f"blocks.{i}.ls2.gamma"] = arr(blk["ls2"])
    return sd
