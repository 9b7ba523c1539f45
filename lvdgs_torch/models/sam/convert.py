"""sam_vit_b_01ec64.pth -> the port's SAM (PyTorch port of
``lvdgs_tpu/models/sam/convert.py``).

The module's parameter names are the official checkpoint's, so the file's
state dict (a bare one, or one under "model") loads straight into it, read
with weights_only=True. The official keys that no parameter reads (the
mask-prompt downscaler `prompt_encoder.mask_downscaling.*`, the pixel
statistics) are dropped, as the reference's converter skips them; every
parameter must be given.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .model import SAM, SAMConfig


def module_state_dict(sd: Dict, model: SAM) -> Dict[str, torch.Tensor]:
    """`sd` (arrays or tensors) cut to `model`'s keys."""
    keys = model.state_dict().keys()
    return {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items() if k in keys}


def load_converted(path: str, cfg: Optional[SAMConfig] = None, device=None) -> SAM:
    """The checkpoint at `path` as a SAM on `device` (the card when None;
    eval mode). Raises when a parameter is missing or of another shape."""
    from ...slam.system import resolve_device

    device = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd:
        sd = sd["model"]
    with torch.device("meta"):
        model = SAM(cfg or SAMConfig())
    model.load_state_dict(module_state_dict(sd, model), strict=True, assign=True)
    return model.to(device).eval()
