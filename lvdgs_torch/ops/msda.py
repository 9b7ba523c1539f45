"""Multi-scale deformable attention (PyTorch port of
``lvdgs_tpu/ops/msda.py``).

For each query, head and level, `num_points` value vectors are sampled
bilinearly at the predicted locations and summed with softmaxed attention
weights: the math of GroundingDINO's pure fallback
`multi_scale_deformable_attn_pytorch`. Sampling is written as the
reference writes it, four gathers and a bilinear blend, with
grid_sample's conventions (align_corners=False: pixel centres at
(i + 0.5) / size; zero padding outside the image). Torch ops on the
tensors' device; the levels are a loop over the static spatial shapes.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _bilinear_sample(value: torch.Tensor, locs: torch.Tensor) -> torch.Tensor:
    """value: (B, H, W, C); locs: (B, Q, P, 2) normalised (x, y). Returns
    (B, Q, P, C); corners outside the image contribute zero."""
    B, H, W, C = value.shape
    x = locs[..., 0] * W - 0.5
    y = locs[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    flat = value.reshape(B, H * W, C)

    def gather(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi = xi.clamp(0, W - 1).to(torch.int64)
        yi = yi.clamp(0, H - 1).to(torch.int64)
        idx = (yi * W + xi).reshape(B, -1, 1).expand(-1, -1, C)
        out = torch.gather(flat, 1, idx).reshape(*xi.shape, C)
        return out * inb[..., None]

    v00 = gather(x0, y0)
    v01 = gather(x0 + 1, y0)
    v10 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    return v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) + v10 * (1 - wx) * wy + v11 * wx * wy


def multi_scale_deformable_attention(
    value: torch.Tensor,  # (B, N_total, n_heads, c)
    spatial_shapes: Sequence[Tuple[int, int]],  # [(H_l, W_l)]
    sampling_locations: torch.Tensor,  # (B, Q, n_heads, n_levels, n_points, 2)
    attention_weights: torch.Tensor,  # (B, Q, n_heads, n_levels, n_points)
) -> torch.Tensor:
    """Returns (B, Q, n_heads * c)."""
    B, N, nH, c = value.shape
    Q = sampling_locations.shape[1]
    out = torch.zeros((B, Q, nH, c), dtype=torch.float32, device=value.device)
    offset = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v = value[:, offset:offset + H * W]  # (B, HW, nH, c)
        offset += H * W
        v = v.permute(0, 2, 1, 3).reshape(B * nH, H, W, c)
        locs = sampling_locations[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * nH, Q, -1, 2)
        sampled = _bilinear_sample(v, locs)  # (B*nH, Q, P, c)
        w = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * nH, Q, -1, 1)
        out = out + (sampled * w).sum(dim=2).reshape(B, nH, Q, c).permute(0, 2, 1, 3)
    return out.reshape(B, Q, nH * c)
