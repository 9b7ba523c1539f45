"""Patch-based mono-to-render depth scale alignment (PyTorch port of
``lvdgs_tpu/slam/depth_alignment.py``).

Each of up to `max_iter` rounds keeps the patches whose render and scaled
mono mean/std agree, marks pixels whose normalised values agree, and
re-estimates the global scale from those pixels; then erroneous or zero
render pixels are filled with the scaled mono depth. The optional
`remedy_fn` supplies a scale when too few pixels align.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.log import device_constant


class AlignResult(NamedTuple):
    final_depth: torch.Tensor  # (H, W) fused depth
    scale_factor: torch.Tensor  # ()
    error_mask: torch.Tensor  # (H, W) bool: pixels filled from mono
    num_accurate: torch.Tensor  # () int


def _patch_stats(x: torch.Tensor, ps: int):
    """(H, W) -> per-patch mean/std on the zero-padded patch grid, with
    weights for the ragged edges. Returns (mean, std, patches, weights)."""
    H, W = x.shape
    nh, nw = -(-H // ps), -(-W // ps)
    xp = x.new_zeros(nh * ps, nw * ps)
    xp[:H, :W] = x
    wp = x.new_zeros(nh * ps, nw * ps)
    wp[:H, :W] = 1.0
    patches = xp.reshape(nh, ps, nw, ps).permute(0, 2, 1, 3)
    weights = wp.reshape(nh, ps, nw, ps).permute(0, 2, 1, 3)
    cnt = weights.sum(dim=(2, 3))
    mean = (patches * weights).sum(dim=(2, 3)) / torch.clamp(cnt, min=1.0)
    var = ((patches - mean[..., None, None]) ** 2 * weights).sum(dim=(2, 3)) / torch.clamp(cnt, min=1.0)
    return mean, torch.sqrt(var), patches, weights


@torch.no_grad()
def align_scale(
    render_depth: torch.Tensor,
    mono_depth: torch.Tensor,
    *,
    patch_size: int = 10,
    mean_threshold: float = 0.25,
    std_threshold: float = 0.3,
    error_threshold: float = 0.1,
    final_error_threshold: float = 0.15,
    max_iter: int = 4,
    epsilon: float = 0.01,
    min_accurate_pixels_ratio: float = 0.01,
) -> AlignResult:
    H, W = render_depth.shape
    ps = patch_size
    min_acc = int(min_accurate_pixels_ratio * H * W)
    dev = render_depth.device
    r_mean, r_std, r_patches, weights = _patch_stats(render_depth, ps)

    def one_iter(scale):
        m_mean, m_std, m_patches, _ = _patch_stats(mono_depth * scale, ps)
        patch_ok = ((r_mean - m_mean).abs() < mean_threshold * m_mean) & (
            (r_std - m_std).abs() < std_threshold * m_std
        )
        r_norm = (r_patches - r_mean[..., None, None]) / (r_std[..., None, None] + 1e-6)
        m_norm = (m_patches - m_mean[..., None, None]) / (m_std[..., None, None] + 1e-6)
        pix_ok = ((r_norm - m_norm).abs() < error_threshold) & patch_ok[..., None, None] & (weights > 0)
        acc = pix_ok.to(torch.float32)
        n_acc = acc.sum().to(torch.int32)
        r_acc_mean = (r_patches * acc).sum() / torch.clamp(acc.sum(), min=1.0)
        # accurate-pixel means use UNSCALED mono, as the reference does
        m_acc_mean = ((m_patches / torch.clamp(scale, min=1e-12)) * acc).sum() / torch.clamp(acc.sum(), min=1.0)
        new_scale = torch.where(n_acc > 0, r_acc_mean / torch.clamp(m_acc_mean, min=1e-12), scale)
        nh, nw = pix_ok.shape[:2]
        mask_img = pix_ok.permute(0, 2, 1, 3).reshape(nh * ps, nw * ps)[:H, :W]
        return new_scale, n_acc, mask_img

    scale = device_constant(1.0, torch.float32, dev)
    prev = device_constant(0.0, torch.float32, dev)
    n_acc = device_constant(0, torch.int32, dev)
    for k in range(max_iter):
        converged = ((scale - prev).abs() < epsilon) & (scale != 1.0)
        new_scale, new_nacc, _new_mask = one_iter(scale)
        use = ~converged
        prev = torch.where(use, scale, prev)
        enough = (new_nacc >= min_acc) | (k < 2)
        has_any = new_nacc > 0
        scale = torch.where(use & enough & has_any, new_scale, scale)
        n_acc = torch.where(use, torch.where(enough & has_any, new_nacc, torch.zeros_like(new_nacc)), n_acc)

    mono_scaled = mono_depth * scale
    rel_err = (render_depth - mono_scaled).abs() / (mono_scaled + 1e-8)
    error_mask = (rel_err > final_error_threshold) | (render_depth == 0.0)
    final_depth = torch.where(error_mask, mono_scaled, render_depth)
    return AlignResult(final_depth, scale, error_mask, n_acc)


def process_depth(
    render_depth: torch.Tensor,
    mono_depth: torch.Tensor,
    *,
    remedy_fn: Optional[Callable[[], float]] = None,
    patch_size: int = 10,
    mean_threshold: float = 0.25,
    std_threshold: float = 0.3,
    error_threshold: float = 0.1,
    final_error_threshold: float = 0.15,
    max_iter: int = 4,
    epsilon: float = 0.01,
    min_accurate_pixels_ratio: float = 0.01,
):
    """Alignment plus the scale-remedy fallback. Returns (final_depth,
    scale_factor, error_mask, num_accurate)."""
    if render_depth.dim() == 3:
        render_depth = render_depth[0]
    res = align_scale(
        render_depth, mono_depth, patch_size=patch_size, mean_threshold=mean_threshold,
        std_threshold=std_threshold, error_threshold=error_threshold,
        final_error_threshold=final_error_threshold, max_iter=max_iter, epsilon=epsilon,
        min_accurate_pixels_ratio=min_accurate_pixels_ratio,
    )
    H, W = render_depth.shape
    min_acc = int(min_accurate_pixels_ratio * H * W)
    if remedy_fn is not None and int(res.num_accurate) < min_acc:
        scale = torch.tensor(float(remedy_fn()), dtype=torch.float32, device=render_depth.device)
        mono_scaled = mono_depth * scale
        rel_err = (render_depth - mono_scaled).abs() / (mono_scaled + 1e-8)
        error_mask = (rel_err > final_error_threshold) | (render_depth == 0.0)
        return torch.where(error_mask, mono_scaled, render_depth), scale, error_mask, res.num_accurate
    return res.final_depth, res.scale_factor, res.error_mask, res.num_accurate
