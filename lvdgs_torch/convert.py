"""State conversion between the reference package and this one.

Takes the reference package's state as NumPy arrays (``np.asarray`` of each
JAX leaf) and builds this package's dataclasses on a device, and goes back
to NumPy for slot-by-slot comparison. Covers the Gaussian map with its
active mask, the Adam moments and step, the keyframe buffer and cameras,
and the MASt3R network's parameters.
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
