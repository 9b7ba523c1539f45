"""Checkpoint / resume (port of ``lvdgs_tpu/io/checkpoint.py``).

A SLAM state dict goes into one file written with `torch.save`, where the
reference package writes an orbax checkpoint or a NumPy pickle. The file
holds only what `torch.load(weights_only=True)` reads back: tensors, Python
scalars, strings, None, and lists, tuples and dicts of them. NumPy arrays
in the state become tensors on the way in; `load_checkpoint` returns
tensors on `map_location`.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch


def _to_storable(x):
    """`x` with every NumPy array and scalar turned into a tensor or a
    Python scalar; refuses any other object."""
    if isinstance(x, torch.Tensor) or x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {k: _to_storable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_storable(v) for v in x)
    raise TypeError(f"a checkpoint cannot hold a {type(x).__name__}")


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write `state` to the file `path` (its directory is created). The
    file is written beside the target and renamed over it, so a run stopped
    during a save keeps its previous checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_storable(state), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location=None) -> Dict[str, Any]:
    """The state dict `save_checkpoint` wrote, its tensors on
    `map_location`."""
    return torch.load(path, map_location=map_location, weights_only=True)
