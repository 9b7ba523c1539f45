"""Photometric / geometric losses and image statistics (PyTorch).

Port of ``lvdgs_tpu/core/losses.py``: Scharr image gradients and the edge
mask that gates the tracking loss, the exposure-compensated tracking and
mapping losses, the mask-aware mapping loss, L1 / SSIM / PSNR, the
loss-mask coverage report, and the median depth of opaque pixels. Masked
means use sum/count, as there.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .camera import Camera
from .log import device_constant, sync

# ----------------------------------------------------------------------------
# image gradients

_SCHARR_Y = ((3.0, 0.0, -3.0), (10.0, 0.0, -10.0), (3.0, 0.0, -3.0))
_SCHARR_X = ((3.0, 10.0, 3.0), (0.0, 0.0, 0.0), (-3.0, -10.0, -3.0))


def _reflect_pad_hw(img: torch.Tensor, pad: int = 1) -> torch.Tensor:
    return F.pad(img[None], (pad, pad, pad, pad), mode="reflect")[0]


def _depthwise_conv3x3(img: torch.Tensor, kernel) -> torch.Tensor:
    """Valid 3x3 depthwise conv over (C, H+2, W+2) -> (C, H, W)."""
    c = img.shape[0]
    w = device_constant(kernel, img.dtype, img.device).expand(c, 1, 3, 3).contiguous()
    return F.conv2d(img[None], w, groups=c)[0]


def image_gradient(image: torch.Tensor):
    """Scharr gradients of a (C, H, W) image -> (grad_v, grad_h), with the
    reference's naming (grad_v is the x-kernel response)."""
    normalizer = 1.0 / 32.0  # 1 / sum |SCHARR_Y|
    p = _reflect_pad_hw(image)
    return normalizer * _depthwise_conv3x3(p, _SCHARR_X), normalizer * _depthwise_conv3x3(
        p, _SCHARR_Y
    )


def image_gradient_mask(image: torch.Tensor, eps: float = 0.01):
    """True where the full 3x3 neighbourhood has |I| > eps."""
    p = (_reflect_pad_hw(image.abs()) > eps).to(torch.float32)
    m = _depthwise_conv3x3(p, ((1.0,) * 3,) * 3)
    return m == 9.0, m == 9.0


def _median_all(x: torch.Tensor) -> torch.Tensor:
    """Median with the mean of the two middle values for even counts
    (numpy/jnp semantics; torch.median returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def compute_grad_mask(
    image: torch.Tensor, edge_threshold: float, dataset_type: str = "KITTI"
) -> torch.Tensor:
    """Edge mask gating the tracking loss: Scharr magnitude above
    median * edge_threshold, or per-32x32-block medians for 'replica'.
    Returns (H, W) bool."""
    gray = image.mean(dim=0, keepdim=True)
    gv, gh = image_gradient(gray)
    mv, mh = image_gradient_mask(gray)
    mag = torch.sqrt((gv * mv) ** 2 + (gh * mh) ** 2)[0]

    if dataset_type == "replica":
        H, W = mag.shape
        rows, cols = 32, 32
        bh, bw = H // rows, W // cols
        blocks = mag[: rows * bh, : cols * bw].reshape(rows, bh, cols, bw)
        flat = blocks.permute(0, 2, 1, 3).reshape(rows, cols, bh * bw)
        s = torch.sort(flat, dim=-1).values
        n = bh * bw
        med = 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])
        mask_blocks = blocks > (med[:, None, :, None] * edge_threshold)
        mask = torch.zeros_like(mag, dtype=torch.bool)
        mask[: rows * bh, : cols * bw] = mask_blocks.reshape(rows * bh, cols * bw)
        return mask
    return mag > _median_all(mag) * edge_threshold


# ----------------------------------------------------------------------------
# masked means (static-shape substitutes for boolean indexing)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / (m.sum() + eps)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x over mask: sort with invalid entries at +inf, then index
    the middle of the valid prefix."""
    flat = torch.where(mask.reshape(-1), x.reshape(-1), torch.full_like(x.reshape(-1), float("inf")))
    s = torch.sort(flat).values
    n = mask.sum()
    lo = torch.clamp((n - 1) // 2, 0, flat.shape[0] - 1)
    hi = torch.clamp(n // 2, 0, flat.shape[0] - 1)
    with sync():  # indexing by a device scalar reads it
        a, b = s[lo], s[hi]
    return 0.5 * (a + b)


# ----------------------------------------------------------------------------
# L1 / SSIM / PSNR


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def _gaussian_window(window_size: int, dtype, device) -> torch.Tensor:
    sigma = 1.5
    xs = torch.arange(window_size, dtype=torch.float32, device=device) - window_size // 2
    g = torch.exp(-(xs**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g).to(dtype)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two (C, H, W) images (gaussian 11x11 window, sigma 1.5,
    same-padded, C1/C2 for the [0, 1] range)."""
    c = img1.shape[0]
    w = _gaussian_window(window_size, img1.dtype, img1.device).expand(
        c, 1, window_size, window_size
    ).contiguous()

    def blur(x):
        return F.conv2d(x[None], w, padding=window_size // 2, groups=c)[0]

    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu12
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return ssim_map.mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PSNR over valid pixels."""
    se = (img1 - img2) ** 2
    mse = se.mean() if mask is None else masked_mean(se, torch.broadcast_to(mask, se.shape))
    return -10.0 * torch.log10(mse + 1e-12)


# ----------------------------------------------------------------------------
# tracking losses


def _rgb_mask(cam: Camera, thr: float, dtype) -> torch.Tensor:
    return ((cam.image.sum(dim=0) > thr) & cam.grad_mask)[None].to(dtype)


def loss_tracking_rgb(image_ab: torch.Tensor, cam: Camera, rgb_boundary_threshold: float):
    """Masked L1, normalised over the full image as the reference does."""
    m = _rgb_mask(cam, rgb_boundary_threshold, image_ab.dtype)
    return (image_ab * m - cam.image * m).abs().mean()


def loss_tracking_rgb_opacity(image_ab, opacity, cam: Camera, rgb_boundary_threshold: float):
    """Masked L1 weighted by the rendered opacity."""
    m = _rgb_mask(cam, rgb_boundary_threshold, image_ab.dtype)
    return (opacity * (image_ab * m - cam.image * m).abs()).mean()


def loss_tracking(
    image, depth, opacity, cam: Camera, *, rgb_boundary_threshold: float = 0.01,
    alpha: float = 0.95, monocular: bool = True, depth_loss: bool = True,
):
    """Full tracking loss: RGB-only for monocular, RGBD otherwise."""
    image_ab = torch.exp(cam.exposure_a) * image + cam.exposure_b
    rgb = loss_tracking_rgb_opacity(image_ab, opacity, cam, rgb_boundary_threshold)
    if monocular:
        return rgb
    gt_depth = cam.depth[None]
    depth_mask = (gt_depth > 0.01) & (opacity > 0.95)
    l1_depth = ((depth - gt_depth) * depth_mask).abs().mean()
    return alpha * rgb + (1 - alpha) * l1_depth


# ----------------------------------------------------------------------------
# mapping losses


def loss_mapping_rgbd(image_ab, depth, cam: Camera, *, rgb_boundary_threshold=0.01, alpha=0.95):
    """RGB + mono-depth mapping loss."""
    gt = cam.image
    gt_depth = cam.mono_depth[None]
    mr = (gt.sum(dim=0) > rgb_boundary_threshold)[None].to(image_ab.dtype)
    md = (gt_depth > 0.01).to(image_ab.dtype)
    l1_rgb = (image_ab * mr - gt * mr).abs().mean()
    l1_depth = (depth * md - gt_depth * md).abs().mean()
    return alpha * l1_rgb + (1 - alpha) * l1_depth


def loss_mapping(
    image, depth, cam: Camera, *, rgb_boundary_threshold: float = 0.01, alpha: float = 0.95,
    initialization: bool = False, monocular: bool = True, monodepth: bool = True,
):
    """Dispatch of the reference mapping loss."""
    image_ab = image if initialization else torch.exp(cam.exposure_a) * image + cam.exposure_b
    if (monocular and monodepth) or not monocular:
        return loss_mapping_rgbd(
            image_ab, depth, cam, rgb_boundary_threshold=rgb_boundary_threshold, alpha=alpha
        )
    mr = (cam.image.sum(dim=0) > rgb_boundary_threshold)[None].to(image_ab.dtype)
    return (image_ab * mr - cam.image * mr).abs().mean()


def loss_mapping_masked(
    image, depth, cam: Camera, background, *, lambda_dssim: float = 0.2, depth_lambda: float = 0.1,
):
    """Dynamic-mask-aware mapping loss: dynamic pixels filled with the
    background colour, L1 + DSSIM, depth L1 over static valid pixels."""
    static = cam.static_mask[None]
    bg = background[:, None, None]
    masked_image = torch.where(static, image, bg)
    masked_gt = torch.where(static, cam.image, bg)
    loss = (1.0 - lambda_dssim) * l1_loss(masked_image, masked_gt) + lambda_dssim * (
        1.0 - ssim(masked_image, masked_gt)
    )
    d = depth[0] if depth.ndim == 3 else depth
    depth_mask = cam.static_mask & (cam.mono_depth > 0) & (d > 0)
    depth_l1 = masked_mean((d - cam.mono_depth).abs(), depth_mask)
    return loss + depth_lambda * torch.where(depth_mask.any(), depth_l1, torch.zeros_like(depth_l1))


def isotropic_reg(scaling: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """|s - mean(s)| isotropy regulariser over active Gaussians."""
    dev = (scaling - scaling.mean(dim=1, keepdim=True)).abs()
    m = active.to(scaling.dtype)[:, None]
    return (dev * m).sum() / (m.sum() * scaling.shape[1] + 1e-8)


def debug_loss_mask_coverage(cam: Camera, rgb_boundary_threshold: float = 0.01,
                             verbose: bool = False) -> dict:
    """What share of the pixels each mask stage keeps in the tracking loss:
    valid RGB, the edge mask, both, and with a static mask the static share
    and all three together. The original LVD-GS calls this but never
    defines it; the reference package implements it as intended."""
    total = cam.image.shape[1] * cam.image.shape[2]
    rgb_mask = cam.image.sum(dim=0) > rgb_boundary_threshold

    def share(m):
        return float(m.to(torch.float32).mean())

    stats = {
        "rgb_valid": share(rgb_mask),
        "grad_mask": share(cam.grad_mask),
        "combined": share(rgb_mask & cam.grad_mask),
        "total_pixels": int(total),
    }
    if cam.has_static_mask:
        stats["static"] = share(cam.static_mask)
        stats["combined_static"] = share(rgb_mask & cam.grad_mask & cam.static_mask)
    if verbose:
        from .log import Log

        Log("loss mask coverage: "
            + ", ".join(f"{k}={v:.1%}" for k, v in stats.items() if isinstance(v, float)))
    return stats


# ----------------------------------------------------------------------------
# depth statistics


def get_median_depth(depth: torch.Tensor, opacity: Optional[torch.Tensor] = None,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Median of valid rendered depth."""
    d = depth.reshape(-1)
    valid = d > 0
    if opacity is not None:
        valid = valid & (opacity.reshape(-1) > 0.95)
    if mask is not None:
        valid = valid & mask.reshape(-1)
    return masked_median(d, valid)
