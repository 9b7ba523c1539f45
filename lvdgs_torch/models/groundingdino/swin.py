"""Swin Transformer backbone (Swin-T) of GroundingDINO (PyTorch port of
``lvdgs_tpu/models/groundingdino/swin.py``).

A 4x4 patch embedding, four stages of shifted-window attention with a
relative position bias, patch merging between stages; the maps of stages
1-3 (strides 8, 16, 32) feed the detector's neck. As in the reference,
every block pads its normed map to a multiple of the window (the padded
tokens are zeros, attended to unmasked in unshifted windows), shifted
blocks roll it and mask across the roll's seams, and patch merging pads
odd sizes. LayerNorms use torch's default eps 1e-5; the GELU is exact.
Module names are those of the official checkpoint under `backbone.0`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    patch_size: int = 4
    mlp_ratio: float = 4.0
    out_indices: Tuple[int, ...] = (1, 2, 3)


TINY_SWIN = SwinConfig(embed_dim=24, depths=(1, 1, 2, 1), heads=(1, 2, 3, 4), window=4)


@functools.lru_cache(maxsize=8)
def _rel_pos_index(win: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(win), np.arange(win), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (win - 1)
    return rel[..., 0] * (2 * win - 1) + rel[..., 1]  # (win^2, win^2)


def _to_windows(x: torch.Tensor, win: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // win, win, W // win, win, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, C)


def _from_windows(x: torch.Tensor, win: int, B: int, H: int, W: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(B, H // win, W // win, win, win, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


@functools.lru_cache(maxsize=32)
def _shift_mask_np(H: int, W: int, win: int, shift: int) -> np.ndarray:
    """(nW, win^2, win^2) additive mask: -100 between tokens that the roll
    brought together from different regions of the padded map."""
    img_mask = np.zeros((H, W), np.float32)
    cnt = 0
    for h in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for w in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img_mask[h, w] = cnt
            cnt += 1
    windows = img_mask.reshape(H // win, win, W // win, win).transpose(0, 2, 1, 3).reshape(-1, win * win)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, win: int):
        super().__init__()
        self.heads, self.win = heads, win
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * win - 1) ** 2, heads))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x: (nW * B, win^2, C); mask: (nW, win^2, win^2) or None."""
        B_, N, C = x.shape
        h = self.heads
        d = C // h
        qkv = self.qkv(x).reshape(B_, N, 3, h, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        att = torch.matmul(q, k.transpose(-2, -1)) * d ** -0.5
        rpi = torch.as_tensor(_rel_pos_index(self.win), device=x.device)
        bias = self.relative_position_bias_table[rpi]  # (N, N, heads)
        att = att + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            att = att.reshape(B_ // nW, nW, h, N, N) + mask[None, :, None]
            att = att.reshape(B_, h, N, N)
        out = torch.matmul(torch.softmax(att, dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(B_, N, C))


class SwinMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, win: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.win, self.shift = win, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, win)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = SwinMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B = x.shape[0]
        win, shift = self.win, self.shift
        xn = self.norm1(x).reshape(B, H, W, -1)
        pad_r = (win - W % win) % win
        pad_b = (win - H % win) % win
        xn = F.pad(xn, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if shift > 0:
            xn = torch.roll(xn, (-shift, -shift), dims=(1, 2))
            mask = torch.as_tensor(_shift_mask_np(Hp, Wp, win, shift), device=x.device)
        attn = self.attn(_to_windows(xn, win), mask)
        xn = _from_windows(attn, win, B, Hp, Wp)
        if shift > 0:
            xn = torch.roll(xn, (shift, shift), dims=(1, 2))
        x = x + xn[:, :H, :W].reshape(B, H * W, -1)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, H: int, W: int):
        B, N, C = x.shape
        x = F.pad(x.reshape(B, H, W, C), (0, 0, 0, W % 2, 0, H % 2))
        x0 = x[:, 0::2, 0::2]
        x1 = x[:, 1::2, 0::2]
        x2 = x[:, 0::2, 1::2]
        x3 = x[:, 1::2, 1::2]
        x = torch.cat([x0, x1, x2, x3], dim=-1)
        Ho, Wo = x.shape[1], x.shape[2]
        return self.reduction(self.norm(x.reshape(B, Ho * Wo, 4 * C))), Ho, Wo


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, cfg: SwinConfig, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, cfg.window, 0 if bi % 2 == 0 else cfg.window // 2, cfg.mlp_ratio)
            for bi in range(depth)
        ])
        if downsample:
            self.downsample = PatchMerging(dim)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(dim)


class SwinTransformer(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.patch_size)
        n = len(cfg.depths)
        self.layers = nn.ModuleList([
            SwinStage(cfg.embed_dim * 2 ** si, depth, cfg.heads[si], cfg, si < n - 1)
            for si, depth in enumerate(cfg.depths)
        ])
        for si in cfg.out_indices:
            self.add_module(f"norm{si}", nn.LayerNorm(cfg.embed_dim * 2 ** si))

    def forward(self, img: torch.Tensor) -> List[torch.Tensor]:
        """img: (B, 3, H, W) -> [(B, C_i, H_i, W_i)] for the out_indices
        stages."""
        B = img.shape[0]
        x = self.patch_embed.proj(img.to(self.patch_embed.proj.weight.dtype))
        h, w = x.shape[2], x.shape[3]
        x = self.patch_embed.norm(x.reshape(B, -1, h * w).transpose(1, 2))
        outs = []
        for si, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x, h, w)
            if si in self.cfg.out_indices:
                xo = getattr(self, f"norm{si}")(x)
                outs.append(xo.transpose(1, 2).reshape(B, -1, h, w))
            if hasattr(stage, "downsample"):
                x, h, w = stage.downsample(x, h, w)
        return outs
