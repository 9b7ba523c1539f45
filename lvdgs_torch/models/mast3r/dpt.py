"""DPT dense-prediction head of DUSt3R/MASt3R (PyTorch port of
``lvdgs_tpu/models/mast3r/dpt.py``).

Four transformer hook maps are projected to pyramid features (96, 192,
384, 768 channels), resampled to 1/4, 1/8, 1/16 and 1/32 of the image,
fused by RefineNet-style residual blocks at 256 channels, and decoded by a
small conv head to `num_channels` at full resolution.

Convolutions pad as the reference's "SAME" does (for the stride-2 one,
one row and column more at the end than at the start where the input is
even), and bilinear resizing is the reference's `jax.image.resize`
(half-pixel centres, the kernel widened when it shrinks), written as one
weight matrix per axis. Module names are the official checkpoint's.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .vit import normal_

LAYER_DIMS = (96, 192, 384, 768)


class Conv2dSame(nn.Conv2d):
    """nn.Conv2d with the reference's "SAME" padding: out = ceil(in /
    stride), the padding split with the odd one at the end."""

    def forward(self, x):
        pads = []
        for size, k, s in zip(x.shape[-2:][::-1], self.kernel_size[::-1], self.stride[::-1]):
            out = -(-size // s)
            total = max((out - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(x, pads), self.weight, self.bias, self.stride)


def _triangle(x):
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _keys_cubic(x):
    """Keys' cubic convolution kernel at a = -0.5, jax.image's "bicubic"."""
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= 2.0, f(0.0), out)


KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def _axis_weights(n_in: int, n_out: int, device, method: str = "bilinear") -> torch.Tensor:
    """(n_in, n_out) weights of jax.image.resize (antialiased, translation
    0) with `method`'s kernel along one axis, computed in float32 as there;
    built once per shape and device."""
    f = np.float32
    inv = f(1.0) / (f(n_out) / f(n_in))
    kscale = max(inv, f(1.0))
    sample = (np.arange(n_out, dtype=f) + f(0.5)) * inv - f(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None]) / kscale
    w = KERNELS[method](x)
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= f(n_in) - f(0.5))
    w = np.where(inside[None, :], w, f(0.0))
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, *hw), as jax.image.resize(..., "bilinear")."""
    H, W = x.shape[-2:]
    wy = _axis_weights(H, hw[0], x.device)
    wx = _axis_weights(W, hw[1], x.device)
    return torch.einsum("bchw,hy,wx->bcyx", x, wy, wx)


class Resize2x(nn.Module):
    """Bilinear 2x upsampling (no parameters; holds a place in the head's
    Sequential so its convolutions keep the checkpoint's indices)."""

    def forward(self, x):
        return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))


class ResidualConvUnit(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = Conv2dSame(c, c, 3)
        self.conv2 = Conv2dSame(c, c, 3)

    def forward(self, x):
        out = self.conv1(F.relu(x))
        return self.conv2(F.relu(out)) + x


class FusionBlock(nn.Module):
    """FeatureFusionBlock_custom: the skip through resConfUnit1 (where
    there is one), resConfUnit2, 2x up, 1x1 out conv. `prev` is resized to
    the skip's shape where they differ (odd patch grids)."""

    def __init__(self, c: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(c)
        self.resConfUnit2 = ResidualConvUnit(c)
        self.out_conv = Conv2dSame(c, c, 1)

    def forward(self, prev, skip=None):
        x = prev
        if skip is not None:
            if x.shape[-2:] != skip.shape[-2:]:
                x = resize_bilinear(x, skip.shape[-2:])
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        return self.out_conv(Resize2x()(x))


class Scratch(nn.Module):
    def __init__(self, feature_dim: int):
        super().__init__()
        for i, c in enumerate(LAYER_DIMS):
            setattr(self, f"layer{i + 1}_rn", Conv2dSame(c, feature_dim, 3, bias=False))
        for i in range(4):
            setattr(self, f"refinenet{i + 1}", FusionBlock(feature_dim))


class DPTHead(nn.Module):
    """`act_postprocess.i`: a 1x1 projection to LAYER_DIMS[i], then the
    resampling of hook i (4x and 2x transposed convolutions, none, a
    stride-2 3x3 convolution); `scratch`; `head` (3x3, 2x up, 3x3, ReLU,
    1x1)."""

    def __init__(self, dim_tokens=(1024, 768, 768, 768), feature_dim: int = 256, last_dim: int = 128,
                 num_channels: int = 4):
        super().__init__()
        L = LAYER_DIMS
        resample = [nn.ConvTranspose2d(L[0], L[0], 4, stride=4), nn.ConvTranspose2d(L[1], L[1], 2, stride=2),
                    None, Conv2dSame(L[3], L[3], 3, stride=2)]
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(Conv2dSame(dim_tokens[i], L[i], 1), *([r] if r is not None else []))
            for i, r in enumerate(resample)
        ])
        self.scratch = Scratch(feature_dim)
        self.head = nn.Sequential(
            Conv2dSame(feature_dim, last_dim, 3), Resize2x(), Conv2dSame(last_dim, 32, 3), nn.ReLU(),
            Conv2dSame(32, num_channels, 1),
        )

    def forward(self, hook_tokens: Sequence[torch.Tensor], grid_hw) -> torch.Tensor:
        """hook_tokens: 4 token maps (B, N, D_i) on the patch grid; returns
        (B, num_channels, H, W) with H = 16 * grid_h."""
        h, w = grid_hw
        feats = []
        for tok, post in zip(hook_tokens, self.act_postprocess):
            B, N, D = tok.shape
            feats.append(post(tok.transpose(1, 2).reshape(B, D, h, w)))
        sc = self.scratch
        rn = [getattr(sc, f"layer{i + 1}_rn")(f) for i, f in enumerate(feats)]
        path = sc.refinenet4(rn[3])
        path = sc.refinenet3(path, rn[2])
        path = sc.refinenet2(path, rn[1])
        path = sc.refinenet1(path, rn[0])
        return self.head(path)


def init_convs_(module: nn.Module, generator: torch.Generator) -> None:
    """The reference's init of every convolution of `module`, in module
    order: N(0, 1) * 0.25 * sqrt(2 / (cin k k)) weights (cin the array's
    second axis), zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            cin, k = m.weight.shape[1], m.weight.shape[2]
            normal_(m.weight, 0.25 * math.sqrt(2.0 / (cin * k * k)), generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
