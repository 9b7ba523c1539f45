"""Rendering-quality evaluation: PSNR / SSIM over every non-keyframe frame
rendered from its estimated pose (PyTorch port of
``lvdgs_tpu/eval/rendering.py``; the static-region variants, LPIPS and the
per-frame panels are left to the dynamic-scene slice)."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.camera import Intrinsics
from ..core.log import Log
from ..core.losses import psnr as psnr_fn
from ..core.losses import ssim as ssim_fn
from ..ops.rasterizer import RenderConfig, rasterize


@torch.no_grad()
def eval_rendering(
    gmap,
    frames: Dict[int, dict],
    dataset,
    intr: Intrinsics,
    rcfg: RenderConfig,
    save_dir: Optional[str] = None,
    kf_indices: Optional[List[int]] = None,
    iteration: str = "final",
    max_frames: Optional[int] = None,
) -> Dict[str, float]:
    """Mean PSNR (over valid-RGB pixels) and SSIM of every non-keyframe
    frame rendered from its estimated pose; frames with a non-finite pose
    or score are counted and excluded."""
    kf_set = set(kf_indices or [])
    psnrs, ssims = [], []
    nonfinite_frames: List[int] = []
    params = gmap.params()
    dev = gmap.device
    end = len(dataset) if max_frames is None else min(len(dataset), max_frames)
    for idx in range(end):
        if idx in kf_set or idx not in frames:
            continue
        f = frames[idx]
        if not (np.all(np.isfinite(f["R"])) and np.all(np.isfinite(f["T"]))):
            nonfinite_frames.append(idx)
            Log(f"eval frame {idx}: non-finite pose, skipped", tag="Eval")
            continue
        image = dataset[idx][0]
        gt = torch.as_tensor(image, dtype=torch.float32, device=dev)
        out = rasterize(
            params, gmap.active,
            torch.as_tensor(np.asarray(f["R"], np.float32), device=dev),
            torch.as_tensor(np.asarray(f["T"], np.float32), device=dev),
            intr, rcfg, need_n_touched=False,
        )
        render = torch.clamp(out.image, 0.0, 1.0)
        valid = (gt.sum(dim=0) > 0.01)[None]
        p = float(psnr_fn(render, gt, valid))
        s = float(ssim_fn(render, gt))
        if not (np.isfinite(p) and np.isfinite(s)):
            nonfinite_frames.append(idx)
            Log(f"eval frame {idx}: non-finite render (psnr={p}, ssim={s}), "
                "excluded from means", tag="Eval")
            continue
        psnrs.append(p)
        ssims.append(s)

    result = {
        "mean_psnr": float(np.mean(psnrs)) if psnrs else 0.0,
        "mean_ssim": float(np.mean(ssims)) if ssims else 0.0,
        "n_eval_frames": len(psnrs),
    }
    if nonfinite_frames:
        result["n_nonfinite_frames"] = len(nonfinite_frames)
        result["nonfinite_frames"] = nonfinite_frames[:20]
    Log(
        f"Rendering eval [{iteration}]: PSNR {result['mean_psnr']:.2f} dB, "
        f"SSIM {result['mean_ssim']:.4f} ({result['n_eval_frames']} frames)",
        tag="Eval",
    )
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, f"metrics_{iteration}.json"), "w") as fh:
            json.dump(result, fh, indent=2)
    return result
