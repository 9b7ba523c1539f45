"""State conversion between the reference package and this one.

Takes the reference package's state as NumPy arrays (``np.asarray`` of each
JAX leaf) and builds this package's dataclasses on a device, and goes back
to NumPy for slot-by-slot comparison. Covers the Gaussian map with its
active mask, the Adam moments and step, the keyframe buffer and cameras.
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
