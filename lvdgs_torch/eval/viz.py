"""Evaluation visualisations (port of ``lvdgs_tpu/eval/viz.py``), drawn with
PIL:

- save_depth_comparison: rendered and mono depth, their error and the RGB,
  four panels;
- six_panel: a frame's GT, render, residual, render and mono depth and
  static mask;
- mask_overlay: red dynamic pixels, yellow expansion margin.

Each takes tensors on any device or arrays, and brings a tensor to the host
itself. The reference draws its figures with matplotlib and writes none
where matplotlib is not installed; the port draws the same panels and titles
under the same file names with PIL, which the port's machines have, so a
saving run writes its figures everywhere. The difference is deliberate: no
colour bars, and viridis, magma and gray from nine-stop tables interpolated
linearly.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


# matplotlib's colour maps at nine evenly spaced stops (RGB, 0-255)
_CMAPS = {
    "viridis": [(68, 1, 84), (71, 44, 122), (59, 82, 139), (44, 113, 142), (33, 145, 140), (39, 173, 129),
                (92, 200, 99), (170, 220, 50), (253, 231, 37)],
    "magma": [(0, 0, 4), (28, 16, 68), (79, 18, 123), (129, 37, 129), (181, 54, 122), (229, 80, 100),
              (251, 135, 97), (254, 194, 135), (252, 253, 191)],
    "gray": [(0, 0, 0), (255, 255, 255)],
}


def _to_rgb(img, cmap: Optional[str]) -> np.ndarray:
    """A panel as (H, W, 3) uint8: an RGB image in [0, 1] as it is, a map in
    [0, 1] through `cmap`'s stops, interpolated linearly."""
    img = np.asarray(img, np.float64)
    if img.ndim == 3:
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)
    stops = np.asarray(_CMAPS[cmap or "viridis"], np.float64)
    x = np.clip(np.nan_to_num(img), 0, 1) * (len(stops) - 1)
    lo = np.minimum(x.astype(np.int64), len(stops) - 2)
    t = (x - lo)[..., None]
    return (stops[lo] * (1 - t) + stops[lo + 1] * t).round().astype(np.uint8)


def _pil_figure(panels, cols: int, path: str, title: Optional[str] = None) -> str:
    """The panels [(image, title, cmap)] on a grid of `cols` columns, each
    under its title, with an optional title above, written to `path`."""
    from PIL import Image, ImageDraw

    tiles = [(_to_rgb(img, cmap), name) for img, name, cmap in panels]
    h, w = tiles[0][0].shape[:2]
    bar, top = 18, (24 if title else 0)
    rows = -(-len(tiles) // cols)
    canvas = Image.new("RGB", (cols * (w + 4), top + rows * (h + bar + 4)), (255, 255, 255))
    draw = ImageDraw.Draw(canvas)
    if title:
        draw.text((4, 4), title, fill=(0, 0, 0))
    for i, (rgb, name) in enumerate(tiles):
        x, y = (i % cols) * (w + 4), top + (i // cols) * (h + bar + 4)
        draw.text((x + 2, y + 2), name, fill=(0, 0, 0))
        canvas.paste(Image.fromarray(rgb), (x, y + bar))
    canvas.save(path, compress_level=1)  # a figure of 3 MP: level 6 takes ~1 s
    return path


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _norm(x):
    lo, hi = float(np.min(x)), float(np.max(x))
    return (x - lo) / (hi - lo + 1e-12)


def save_depth_comparison(render_depth, mono_depth, rgb, cur_frame_idx, save_dir):
    """Four-panel depth comparison; returns the saved path."""
    os.makedirs(save_dir, exist_ok=True)
    render_depth = _host(render_depth)
    if render_depth.ndim == 3:
        render_depth = render_depth[0]
    mono_depth = _host(mono_depth)
    rgb_img = _host(rgb)
    if rgb_img.ndim == 3 and rgb_img.shape[0] == 3:
        rgb_img = rgb_img.transpose(1, 2, 0)

    err = np.abs(render_depth - mono_depth)
    path = os.path.join(save_dir, f"{cur_frame_idx}.png")
    return _pil_figure([(_norm(render_depth), "Rendered Depth", "viridis"),
                        (_norm(mono_depth), "Pointmap Mono Depth", "viridis"),
                        (_norm(err), "Depth Error", "magma"), (np.clip(rgb_img, 0, 1), "RGB", None)],
                       2, path, f"Frame {cur_frame_idx}")


def six_panel(gt, render, render_depth, mono_depth, static_mask, idx, save_dir):
    """GT / render / residual / depths / mask figure; returns the saved path."""
    os.makedirs(save_dir, exist_ok=True)
    gt = _host(gt).transpose(1, 2, 0)
    render = _host(render).transpose(1, 2, 0)
    resid = np.abs(gt - render).mean(-1)
    panels = [
        (np.clip(gt, 0, 1), "GT", None),
        (np.clip(render, 0, 1), "Render", None),
        (_norm(resid), "Residual", "magma"),
        (_norm(_host(render_depth)), "Render depth", "viridis"),
        (_norm(_host(mono_depth)), "Mono depth", "viridis"),
        (_host(static_mask).astype(float) if static_mask is not None else np.ones(resid.shape),
         "Static mask", "gray"),
    ]
    path = os.path.join(save_dir, f"panel_{idx:05d}.png")
    return _pil_figure(panels, 3, path)


def mask_overlay(image_u8, dynamic_mask, expanded_mask=None, path: Optional[str] = None):
    """Red = dynamic, yellow = expansion margin."""
    out = _host(image_u8).copy()
    dm = _host(dynamic_mask).astype(bool)
    out[dm] = [255, 0, 0]
    if expanded_mask is not None:
        em = _host(expanded_mask).astype(bool) & ~dm
        out[em] = [255, 255, 0]
    if path is not None:
        from PIL import Image

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        Image.fromarray(out).save(path)
    return out
