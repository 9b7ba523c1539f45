"""DINOv2 ViT in PyTorch, the feature-analysis model (port of
``lvdgs_tpu/models/dinov2/model.py``).

The forward returns every block's tokens and attention maps, as the
reference's `dinov2_forward` does (the counterpart of hooks on each block),
for the feature analyser (`python -m lvdgs_torch.tools.dinov2_analyze`).

Architecture (ViT-B/14 by default): patch 14, a class token, a learned
position embedding resized to the input grid, pre-norm blocks with
LayerScale. Parameter names are those of the torch.hub `dinov2_vitb14`
state dict, so a hub file loads directly once the keys the forward never
reads (`HUB_ONLY_KEYS`) are cut. The position-embedding resize is
jax.image.resize's antialiased Keys cubic (a = -0.5, its edge weighting)
written as two weight matrices: `F.interpolate(mode="bicubic")` uses a =
-0.75 and clamps at the edge, and differs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..mast3r import vit
from ..mast3r.dpt import _axis_weights


@dataclasses.dataclass(frozen=True)
class DINOv2Config:
    patch_size: int = 14
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    pos_grid: int = 37  # 518 / 14


TINY_DINO = DINOv2Config(patch_size=8, dim=32, depth=2, heads=2, pos_grid=8)

# keys of the hub state dict that the forward never reads
HUB_ONLY_KEYS = ("mask_token",)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.dim, cfg.patch_size, stride=cfg.patch_size)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        d = D // self.heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        att = torch.softmax((q @ k.transpose(-2, -1)) * d**-0.5, dim=-1)
        out = (att @ v).transpose(1, 2).reshape(B, N, D)
        return self.proj(out), att


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        D = cfg.dim
        self.norm1 = vit.layer_norm(D)
        self.attn = Attention(D, cfg.heads)
        self.ls1 = LayerScale(D)
        self.norm2 = vit.layer_norm(D)
        self.mlp = vit.Mlp(D, int(D * cfg.mlp_ratio))
        self.ls2 = LayerScale(D)

    def forward(self, x):
        out, att = self.attn(self.norm1(x))
        x = x + self.ls1(out)
        x = x + self.ls2(self.mlp(self.norm2(x)))
        return x, att


def resize_pos_embed(patch_pos: torch.Tensor, hw) -> torch.Tensor:
    """(B, gh, gw, D) -> (B, h, w, D), as jax.image.resize(..., "bicubic")."""
    wy = _axis_weights(patch_pos.shape[1], hw[0], patch_pos.device, "bicubic")
    wx = _axis_weights(patch_pos.shape[2], hw[1], patch_pos.device, "bicubic")
    return torch.einsum("bhwd,hy,wx->byxd", patch_pos, wy, wx)


class DINOv2(nn.Module):
    def __init__(self, cfg: DINOv2Config = DINOv2Config()):
        super().__init__()
        self.cfg = cfg
        D = cfg.dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid**2, D))
        self.blocks = nn.ModuleList([Block(cfg) for _ in range(cfg.depth)])
        self.norm = vit.layer_norm(D)

    def forward(self, img: torch.Tensor) -> Dict:
        """img: (B, 3, H, W), H and W multiples of patch_size. Returns
        'tokens': each block's (B, 1+N, D), 'attn': each block's (B, heads,
        1+N, 1+N), 'final': (B, 1+N, D) after the norm, 'grid': (h, w)."""
        cfg = self.cfg
        B = img.shape[0]
        x = self.patch_embed.proj(img.to(self.cls_token.dtype))
        h, w = x.shape[2], x.shape[3]
        x = x.reshape(B, cfg.dim, h * w).transpose(1, 2)

        cls_pos, patch_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        g = cfg.pos_grid
        patch_pos = resize_pos_embed(patch_pos.reshape(1, g, g, cfg.dim), (h, w)).reshape(1, h * w, cfg.dim)
        x = torch.cat([(self.cls_token + cls_pos).expand(B, 1, cfg.dim), x + patch_pos], dim=1)

        tokens, attns = [], []
        for blk in self.blocks:
            x, att = blk(x)
            tokens.append(x)
            attns.append(att)
        return {"tokens": tokens, "attn": attns, "final": self.norm(x), "grid": (h, w)}


@torch.no_grad()
def dinov2_forward(model: DINOv2, img: torch.Tensor) -> Dict:
    return model(img)


def init_params(cfg: DINOv2Config, generator: torch.Generator, device=None) -> DINOv2:
    """A DINOv2 with the reference's random init, drawn from `generator` (on
    its device) into parameters on `device`: patch embedding, class token
    and position embedding N(0, 1) * 0.02, linears N(0, 1) * 0.25 *
    sqrt(2 / (din + dout)), zero biases, unit LayerNorms, LayerScale 1e-5."""
    with torch.device("meta"):
        model = DINOv2(cfg)
    model = model.to_empty(device=device or generator.device)
    for t in (model.patch_embed.proj.weight, model.cls_token, model.pos_embed):
        vit.normal_(t, 0.02, generator)
    nn.init.zeros_(model.patch_embed.proj.bias)
    vit.init_blocks_(model.blocks, generator)
    vit.init_blocks_(model.norm, generator)
    for blk in model.blocks:
        nn.init.constant_(blk.ls1.gamma, 1e-5)
        nn.init.constant_(blk.ls2.gamma, 1e-5)
    return model


def convert_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torch.hub DINOv2 state dict (bare or under "model") with the keys
    the forward never reads (HUB_ONLY_KEYS) cut: DINOv2's own state dict."""
    sd = sd.get("model", sd)
    return {k: v for k, v in sd.items() if k not in HUB_ONLY_KEYS}


def load_hub(path_or_sd, cfg: DINOv2Config = DINOv2Config(), device=None) -> DINOv2:
    """A DINOv2 on `device` (the card when None) from a hub file or state
    dict, loaded strictly after the listed cuts (read with
    weights_only=True)."""
    sd = path_or_sd
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    with torch.device("meta"):
        model = DINOv2(cfg)
    model.load_state_dict(convert_state_dict(sd), strict=True, assign=True)
    return model.to(torch.device("cuda" if device is None else device)).eval()
