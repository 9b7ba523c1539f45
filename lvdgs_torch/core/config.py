"""Layered YAML configuration with recursive inheritance.

Parity with reference utils/config_utils.py:4-50: a config may name a parent
via `inherit_from`; parents load first and children deep-merge on top.
Also provides attribute-style access (the reference munchifies `opt_params`
etc. in its entry point — consumed as `self.opt_params.lambda_dssim`,
reference utils/slam_backend.py:214).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import yaml


def update_recursive(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Deep-merge src into dst in place; src wins on leaves."""
    for k, v in src.items():
        if k not in dst:
            dst[k] = dict() if isinstance(v, dict) else v
        if isinstance(v, dict):
            if not isinstance(dst[k], dict):
                dst[k] = {}
            update_recursive(dst[k], v)
        else:
            dst[k] = v


def load_config(path: str, default_path: str | None = None) -> Dict[str, Any]:
    """Load YAML at `path`, resolving `inherit_from` chains recursively."""
    with open(path, "r") as f:
        cfg_special = yaml.full_load(f)

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        # relative inherit paths resolve against the child file first, then cwd
        cand = inherit_from
        if not os.path.isabs(cand) and not os.path.exists(cand):
            rel = os.path.join(os.path.dirname(path), cand)
            if os.path.exists(rel):
                cand = rel
        cfg = load_config(cand, default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.full_load(f)
    else:
        cfg = dict()

    update_recursive(cfg, cfg_special)
    return cfg


class DotDict(dict):
    """dict with attribute access, recursively (munch stand-in)."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e
        if isinstance(v, dict) and not isinstance(v, DotDict):
            v = DotDict(v)
            self[name] = v
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


def dotify(d: Dict[str, Any]) -> DotDict:
    return DotDict(d)
