"""ViT building blocks of the MASt3R/DUSt3R/CroCo stack (PyTorch port of
``lvdgs_tpu/models/mast3r/vit.py``).

- a 16x16 conv patch embedding (PatchEmbedDust3R semantics);
- 2D rotary position embedding: per head, the first half of the channels
  rotates with the patch row, the second half with the column, base
  frequency 100 (CroCo's "RoPE100"), each half laid out as two contiguous
  blocks that rotate against each other (`_rotate_half_block`);
- pre-norm transformer encoder blocks and CroCo decoder blocks
  (self-attention, cross-attention to the other view, MLP).

Attention is written as the reference writes it: matmul, softmax, matmul.
Module and parameter names are those of the official checkpoint, so its
`state_dict` loads into these modules directly.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6


def layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class Mlp(nn.Module):
    """fc1, exact (erf) GELU, fc2."""

    def __init__(self, d: int, hidden: int, out: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d if out is None else out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


# ---------------------------------------------------------------------------
# 2D RoPE


def rope2d_angles(positions: torch.Tensor, dim: int, base: float = 100.0):
    """positions: (..., 2) integer (y, x); dim: channels per head. Returns
    (cos, sin) of shape (..., dim) laid out [y-half | x-half], each half
    holding its D = dim / 4 frequencies twice."""
    D = dim // 4
    freqs = 1.0 / (base ** (torch.arange(D, dtype=torch.float32, device=positions.device) / D))
    y = positions[..., 0:1].to(torch.float32) * freqs
    x = positions[..., 1:2].to(torch.float32) * freqs
    ang = torch.cat([y, y, x, x], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half_block(t: torch.Tensor) -> torch.Tensor:
    """Each axis-half holds its pairs as two contiguous blocks:
    rotate_half(u)[i] = -u[i + D] for i < D, u[i - D] otherwise."""
    y1, y2, x1, x2 = torch.chunk(t, 4, dim=-1)
    return torch.cat([-y2, y1, -x2, x1], dim=-1)


def apply_rope2d(q: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """q: (B, H, N, d); cos, sin: (B, N, d) or (N, d)."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, None], sin[:, None]
    return q * cos + _rotate_half_block(q) * sin


def _attend(q, k, v):
    """(B, H, N, d) queries against (B, H, M, d) keys and values."""
    att = torch.matmul(q, k.transpose(-2, -1)) * (q.shape[-1] ** -0.5)
    return torch.matmul(torch.softmax(att, dim=-1), v)


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, N, D = x.shape
    return x.reshape(B, N, n_heads, D // n_heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    B, H, N, d = x.shape
    return x.transpose(1, 2).reshape(B, N, H * d)


class Attention(nn.Module):
    """Self-attention with optional RoPE on queries and keys."""

    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)

    def forward(self, x, rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        B, N, D = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.n_heads, D // self.n_heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if rope is not None:
            q, k = apply_rope2d(q, *rope), apply_rope2d(k, *rope)
        return self.proj(_merge(_attend(q, k, v)))


class CrossAttention(nn.Module):
    """Queries from x, keys and values from y."""

    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.projq = nn.Linear(d, d)
        self.projk = nn.Linear(d, d)
        self.projv = nn.Linear(d, d)
        self.proj = nn.Linear(d, d)

    def forward(self, x, y, rope_q=None, rope_k=None):
        q = _heads(self.projq(x), self.n_heads)
        k = _heads(self.projk(y), self.n_heads)
        v = _heads(self.projv(y), self.n_heads)
        if rope_q is not None:
            q = apply_rope2d(q, *rope_q)
        if rope_k is not None:
            k = apply_rope2d(k, *rope_k)
        return self.proj(_merge(_attend(q, k, v)))


class EncoderBlock(nn.Module):
    def __init__(self, d: int, n_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = layer_norm(d)
        self.attn = Attention(d, n_heads)
        self.norm2 = layer_norm(d)
        self.mlp = Mlp(d, int(d * mlp_ratio))

    def forward(self, x, rope):
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """CroCo DecoderBlock: self-attention, cross-attention to the (normed)
    other view, MLP, pre-norm residual layout."""

    def __init__(self, d: int, n_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = layer_norm(d)
        self.attn = Attention(d, n_heads)
        self.norm2 = layer_norm(d)
        self.norm_y = layer_norm(d)
        self.cross_attn = CrossAttention(d, n_heads)
        self.norm3 = layer_norm(d)
        self.mlp = Mlp(d, int(d * mlp_ratio))

    def forward(self, x, y, rope_x, rope_y):
        x = x + self.attn(self.norm1(x), rope_x)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(y), rope_q=rope_x, rope_k=rope_y)
        return x + self.mlp(self.norm3(x))


class PatchEmbed(nn.Module):
    def __init__(self, d: int, patch_size: int = 16):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, d, patch_size, stride=patch_size)

    def forward(self, img):
        """img (B, 3, H, W) -> tokens (B, N, D) and positions (N, 2) as
        (y, x)."""
        out = self.proj(img.to(self.proj.weight.dtype))
        B, D, h, w = out.shape
        tokens = out.reshape(B, D, h * w).transpose(1, 2)
        yy, xx = torch.meshgrid(torch.arange(h, device=img.device), torch.arange(w, device=img.device),
                                indexing="ij")
        return tokens, torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


# ---------------------------------------------------------------------------
# random init, with the reference's distributions


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """t <- N(0, 1) * std, drawn from `generator` on its own device."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator, device=generator.device) * std)


def init_linear_(lin: nn.Linear, generator: torch.Generator) -> None:
    """N(0, 1) * 0.25 * sqrt(2 / (din + dout)) weights, zero bias."""
    dout, din = lin.weight.shape
    normal_(lin.weight, 0.25 * math.sqrt(2.0 / (din + dout)), generator)
    if lin.bias is not None:
        nn.init.zeros_(lin.bias)


def init_blocks_(module: nn.Module, generator: torch.Generator) -> None:
    """Every Linear of `module` as init_linear_, every LayerNorm at
    (1, 0), in module order."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
