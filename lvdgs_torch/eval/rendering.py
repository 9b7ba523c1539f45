"""Rendering-quality evaluation: PSNR / SSIM over every non-keyframe frame
rendered from its estimated pose, and over its static region where the
frame has a static mask (PyTorch port of ``lvdgs_tpu/eval/rendering.py``).

LPIPS follows the reference's `_lpips`: without AlexNet weights the metric
is unavailable and its key is left out; none are in the repo, so the port
reports none. With a `save_dir`, each `viz_every`-th frame also writes the
reference's per-frame files: its render (PNG) and depth (.npy) under
`renders_{iteration}/` and the six-panel figure under
`panels_{iteration}/`, both best-effort (a failure is logged)."""
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
    viz_every: int = 1,
) -> Dict[str, float]:
    """Mean PSNR (over valid-RGB pixels) and SSIM of every non-keyframe
    frame rendered from its estimated pose; frames with a non-finite pose
    or score are counted and excluded. Where a frame has a static mask,
    mean_psnr_static and mean_ssim_static score the render and the GT with
    the dynamic pixels set to the background colour: the dataset's GT
    static mask where it has one (so masked and unmasked runs are scored on
    the same pixels), else the frame record's own mask. With `save_dir`,
    frames whose index is a multiple of `viz_every` (0: none) write their
    render, depth and six-panel figure, as the reference does."""
    kf_set = set(kf_indices or [])
    psnrs, ssims = [], []
    psnrs_s, ssims_s = [], []
    nonfinite_frames: List[int] = []
    params = gmap.params()
    dev = gmap.device
    bg = torch.full((3, 1, 1), 1.0 if rcfg.white_background else 0.0, dtype=torch.float32, device=dev)
    end = len(dataset) if max_frames is None else min(len(dataset), max_frames)
    for idx in range(end):
        if idx in kf_set or idx not in frames:
            continue
        f = frames[idx]
        if not (np.all(np.isfinite(f["R"])) and np.all(np.isfinite(f["T"]))):
            nonfinite_frames.append(idx)
            Log(f"eval frame {idx}: non-finite pose, skipped", tag="Eval")
            continue
        image, _, _, mono_depth = dataset[idx]
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

        static = f.get("static_mask")
        if hasattr(dataset, "get_gt_static_mask"):
            gt_static = dataset.get_gt_static_mask(idx)
            if gt_static is not None:
                static = gt_static
        if static is not None:
            sm = torch.as_tensor(static, device=dev)[None]
            render_s = torch.where(sm, render, bg)
            gt_s = torch.where(sm, gt, bg)
            ps = float(psnr_fn(render_s, gt_s, valid & sm))
            ss = float(ssim_fn(render_s, gt_s))
            if np.isfinite(ps) and np.isfinite(ss):  # an empty static region gives NaN
                psnrs_s.append(ps)
                ssims_s.append(ss)

        if save_dir is not None and viz_every and idx % viz_every == 0:
            depth = out.depth[0].cpu().numpy()
            _dump_frame(save_dir, iteration, idx, render.cpu().numpy(), depth)
            try:
                from .viz import six_panel

                six_panel(gt, render, depth, mono_depth if mono_depth is not None else depth, static, idx,
                          os.path.join(save_dir, f"panels_{iteration}"))
            except Exception as e:  # the panels are best-effort
                Log(f"six_panel viz failed for frame {idx}: {e}", tag="Eval")

    result = {
        "mean_psnr": float(np.mean(psnrs)) if psnrs else 0.0,
        "mean_ssim": float(np.mean(ssims)) if ssims else 0.0,
        "n_eval_frames": len(psnrs),
    }
    if nonfinite_frames:
        result["n_nonfinite_frames"] = len(nonfinite_frames)
        result["nonfinite_frames"] = nonfinite_frames[:20]
    if psnrs_s:
        result["mean_psnr_static"] = float(np.mean(psnrs_s))
        result["mean_ssim_static"] = float(np.mean(ssims_s))
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


def _dump_frame(save_dir, iteration, idx, render, depth):
    """The reference's render PNG and depth .npy of one frame (best-effort)."""
    try:
        from PIL import Image

        d = os.path.join(save_dir, f"renders_{iteration}")
        os.makedirs(d, exist_ok=True)
        Image.fromarray((np.clip(render, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)).save(
            os.path.join(d, f"{idx:05d}.png"))
        np.save(os.path.join(d, f"depth_{idx:05d}.npy"), depth)
    except Exception as e:
        Log(f"render dump failed for frame {idx}: {e}", tag="Eval")
