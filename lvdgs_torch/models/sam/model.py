"""Segment Anything (ViT-B) in PyTorch (port of
``lvdgs_tpu/models/sam/model.py``).

- image encoder: ViT-B/16 at 1024x1024 with windowed attention (window 14,
  the 64x64 grid padded to 70; global attention at blocks 2, 5, 8 and 11)
  and decomposed relative positions, then the 256-channel neck -> the
  (256, 64, 64) image embedding;
- prompt encoder: random-Fourier positional encoding of the box corners;
- mask decoder: a two-way transformer (2 blocks), the IoU and mask tokens,
  hypernetwork MLPs and 4x upscaling -> (N, 4, 256, 256) mask logits.

Every LayerNorm uses eps 1e-6 (the reference's, the decoder's included),
the GELUs are exact, and the neck's convolutions pad as the reference's
"SAME" does. Module and parameter names are those of the official
checkpoint (sam_vit_b_01ec64.pth), so its state_dict loads into this
module; the keys no parameter reads (the mask-prompt downscaler, the pixel
statistics) are dropped by the loader (convert.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..mast3r.dpt import Conv2dSame
from ..mast3r.vit import init_linear_, normal_

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    dim: int = 768
    depth: int = 12
    heads: int = 12
    window: int = 14
    global_blocks: Tuple[int, ...] = (2, 5, 8, 11)
    embed_dim: int = 256  # neck / decoder dim
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp: int = 2048
    num_mask_tokens: int = 4


TINY = SAMConfig(img_size=128, dim=64, depth=2, heads=2, window=4, global_blocks=(1,), embed_dim=32,
                 decoder_mlp=64)


def _ln(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


# ---------------------------------------------------------------------------
# image encoder


def rel_pos_bias(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """SAM's decomposed relative position bias: q (Bh, h*w, d) unscaled,
    rel_h / rel_w (2 size - 1, d) tables -> (Bh, h*w, h*w)."""
    dev = q.device
    ch = torch.arange(h, device=dev)
    Rh = rel_h[ch[:, None] - ch[None, :] + (h - 1)]  # (h, h, d)
    cw = torch.arange(w, device=dev)
    Rw = rel_w[cw[:, None] - cw[None, :] + (w - 1)]  # (w, w, d)
    Bh = q.shape[0]
    qr = q.reshape(Bh, h, w, -1)
    bias_h = torch.einsum("bhwd,hkd->bhwk", qr, Rh)  # (Bh, h, w, h)
    bias_w = torch.einsum("bhwd,wkd->bhwk", qr, Rw)  # (Bh, h, w, w)
    return (bias_h[:, :, :, :, None] + bias_w[:, :, :, None, :]).reshape(Bh, h * w, h * w)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """x: (B, h*w, D)."""
        B, N, D = x.shape
        H = self.heads
        d = D // H
        qkv = self.qkv(x).reshape(B, N, 3, H, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2).reshape(B * H, N, d) for i in range(3))
        att = torch.matmul(q, k.transpose(-2, -1)) * d ** -0.5
        att = att + rel_pos_bias(q, self.rel_pos_h, self.rel_pos_w, h, w)
        out = torch.matmul(torch.softmax(att, dim=-1), v)
        return self.proj(out.reshape(B, H, N, d).transpose(1, 2).reshape(B, N, D))


class SamMlp(nn.Module):
    """lin1, exact GELU, lin2 (the encoder's MLPBlock)."""

    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(d, hidden)
        self.lin2 = nn.Linear(hidden, d)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x), approximate="none"))


def window_partition(x: torch.Tensor, win: int):
    """(B, H, W, D) -> (B * nW, win*win, D), zero-padded to multiples of
    win, and the pads."""
    B, H, W, D = x.shape
    ph = (win - H % win) % win
    pw = (win - W % win) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // win, win, Wp // win, win, D).permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, D)
    return x, (Hp, Wp, ph, pw)


def window_unpartition(x: torch.Tensor, win: int, pads, B: int, H: int, W: int) -> torch.Tensor:
    Hp, Wp, _, _ = pads
    D = x.shape[-1]
    x = x.reshape(B, Hp // win, Wp // win, win, win, D).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, D)
    return x[:, :H, :W]


class Block(nn.Module):
    def __init__(self, cfg: SAMConfig, is_global: bool):
        super().__init__()
        self.window = 0 if is_global else cfg.window
        size = cfg.img_size // cfg.patch_size if is_global else cfg.window
        self.norm1 = _ln(cfg.dim)
        self.attn = Attention(cfg.dim, cfg.heads, size)
        self.norm2 = _ln(cfg.dim)
        self.mlp = SamMlp(cfg.dim, 4 * cfg.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, D)."""
        B, H, W, D = x.shape
        xn = self.norm1(x)
        if self.window == 0:
            att = self.attn(xn.reshape(B, H * W, D), H, W).reshape(B, H, W, D)
        else:
            win = self.window
            tokens, pads = window_partition(xn, win)
            att = window_unpartition(self.attn(tokens, win, win), win, pads, B, H, W)
        x = x + att
        return x + self.mlp(self.norm2(x))


class LayerNorm2d(nn.Module):
    """Channel-wise LayerNorm over (B, C, H, W), eps 1e-6."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mu = x.mean(dim=1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + LN_EPS)
        return x * self.weight[None, :, None, None] + self.bias[None, :, None, None]


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        g = cfg.img_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.dim, cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, cfg.dim))
        self.blocks = nn.ModuleList([Block(cfg, i in cfg.global_blocks) for i in range(cfg.depth)])
        E = cfg.embed_dim
        self.neck = nn.Sequential(Conv2dSame(cfg.dim, E, 1, bias=False), LayerNorm2d(E),
                                  Conv2dSame(E, E, 3, bias=False), LayerNorm2d(E))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed.proj(img.to(self.patch_embed.proj.weight.dtype)).permute(0, 2, 3, 1)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# prompt encoder and mask decoder


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, E: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, E // 2))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """Coordinates in [0, 1], (..., 2) -> (..., E)."""
        proj = 2 * math.pi * ((2.0 * coords - 1.0) @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, E: int):
        super().__init__()
        self.pe_layer = PositionEmbeddingRandom(E)
        self.point_embeddings = nn.ModuleList([nn.Embedding(1, E) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, E)
        self.no_mask_embed = nn.Embedding(1, E)


class DecoderAttention(nn.Module):
    def __init__(self, E: int, heads: int, downsample: int = 1):
        super().__init__()
        self.heads = heads
        d = E // downsample
        self.q_proj = nn.Linear(E, d)
        self.k_proj = nn.Linear(E, d)
        self.v_proj = nn.Linear(E, d)
        self.out_proj = nn.Linear(d, E)

    def forward(self, q, k, v):
        B, Nq, _ = q.shape
        h = self.heads
        d_out = self.q_proj.weight.shape[0]
        d = d_out // h
        qq = self.q_proj(q).reshape(B, Nq, h, d).transpose(1, 2)
        kk = self.k_proj(k).reshape(B, -1, h, d).transpose(1, 2)
        vv = self.v_proj(v).reshape(B, -1, h, d).transpose(1, 2)
        att = torch.matmul(qq, kk.transpose(-2, -1)) * d ** -0.5
        out = torch.matmul(torch.softmax(att, dim=-1), vv)
        return self.out_proj(out.transpose(1, 2).reshape(B, Nq, d_out))


class DecoderMlp(nn.Module):
    """lin1, ReLU, lin2 (the decoder's MLPBlock)."""

    def __init__(self, E: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(E, hidden)
        self.lin2 = nn.Linear(hidden, E)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayBlock(nn.Module):
    """TwoWayAttentionBlock: on the first block the self-attention's output
    replaces the queries (no residual, no PE)."""

    def __init__(self, cfg: SAMConfig, skip_first_pe: bool):
        super().__init__()
        E, h = cfg.embed_dim, cfg.decoder_heads
        self.skip_first_pe = skip_first_pe
        self.self_attn = DecoderAttention(E, h)
        self.norm1 = _ln(E)
        self.cross_attn_token_to_image = DecoderAttention(E, h, 2)
        self.norm2 = _ln(E)
        self.mlp = DecoderMlp(E, cfg.decoder_mlp)
        self.norm3 = _ln(E)
        self.cross_attn_image_to_token = DecoderAttention(E, h, 2)
        self.norm4 = _ln(E)

    def forward(self, queries, keys, qpe, kpe):
        if self.skip_first_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q_in = queries + qpe
            queries = queries + self.self_attn(q_in, q_in, queries)
        queries = self.norm1(queries)
        q = queries + qpe
        k = keys + kpe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q = queries + qpe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        E = cfg.embed_dim
        self.layers = nn.ModuleList([TwoWayBlock(cfg, i == 0) for i in range(cfg.decoder_depth)])
        self.final_attn_token_to_image = DecoderAttention(E, cfg.decoder_heads, 2)
        self.norm_final_attn = _ln(E)


class MLP3(nn.Module):
    """Linear layers with ReLU between them (the hypernetworks, the IoU
    head)."""

    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        E, T = cfg.embed_dim, cfg.num_mask_tokens
        self.iou_token = nn.Embedding(1, E)
        self.mask_tokens = nn.Embedding(T, E)
        self.transformer = TwoWayTransformer(cfg)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(E, E // 4, 2, stride=2), LayerNorm2d(E // 4), nn.GELU(),
            nn.ConvTranspose2d(E // 4, E // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList([MLP3((E, E, E, E // 8)) for _ in range(T)])
        self.iou_prediction_head = MLP3((E, E, E, T))


class SAM(nn.Module):
    def __init__(self, cfg: SAMConfig = SAMConfig()):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg.embed_dim)
        self.mask_decoder = MaskDecoder(cfg)


@torch.no_grad()
def sam_encode_image(model: SAM, img: torch.Tensor) -> torch.Tensor:
    """img: (B, 3, S, S), SAM-normalised -> (B, embed_dim, S/16, S/16)."""
    return model.image_encoder(img)


@torch.no_grad()
def sam_predict_masks(model: SAM, image_embedding: torch.Tensor, boxes: torch.Tensor):
    """image_embedding: (1, E, h, w); boxes: (B, 4) xyxy normalised to the
    padded square. Returns (mask logits (B, num_mask_tokens, 4h, 4w), IoU
    (B, num_mask_tokens)); each box is decoded on its own."""
    cfg = model.cfg
    pe, dec = model.prompt_encoder, model.mask_decoder
    B = boxes.shape[0]
    h, w = image_embedding.shape[-2:]
    E = cfg.embed_dim
    dev = image_embedding.device

    # the box's corners as two points with their corner embeddings
    corner_pe = pe.pe_layer(boxes.reshape(B, 2, 2))
    sparse = torch.stack([corner_pe[:, 0] + pe.point_embeddings[2].weight[0],
                          corner_pe[:, 1] + pe.point_embeddings[3].weight[0]], dim=1)  # (B, 2, E)

    # the image's dense PE grid
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    img_pe = pe.pe_layer(torch.stack([gx, gy], -1)).reshape(1, h * w, E)

    src = image_embedding + pe.no_mask_embed.weight[0][None, :, None, None]
    src = src.expand(B, E, h, w).reshape(B, E, h * w).transpose(1, 2)
    T = cfg.num_mask_tokens
    tokens = torch.cat([dec.iou_token.weight[None].expand(B, 1, E),
                        dec.mask_tokens.weight[None].expand(B, T, E), sparse], dim=1)
    qpe = tokens  # the tokens are their own PE
    kpe = img_pe.expand(B, h * w, E)
    queries, keys = tokens, src
    tr = dec.transformer
    for blk in tr.layers:
        queries, keys = blk(queries, keys, qpe, kpe)
    q = queries + qpe
    k = keys + kpe
    queries = tr.norm_final_attn(queries + tr.final_attn_token_to_image(q, k, keys))

    iou_tok = queries[:, 0]
    mask_toks = queries[:, 1:1 + T]
    x = dec.output_upscaling(keys.transpose(1, 2).reshape(B, E, h, w))  # (B, E/8, 4h, 4w)
    hyper = torch.stack([mlp(mask_toks[:, i]) for i, mlp in enumerate(dec.output_hypernetworks_mlps)], dim=1)
    masks = torch.einsum("btd,bdhw->bthw", hyper, x)
    return masks, dec.iou_prediction_head(iou_tok)


# ---------------------------------------------------------------------------
# random init, with the reference's distributions


def init_params(cfg: SAMConfig, generator: torch.Generator, device=None) -> SAM:
    """A SAM with the reference's random init, drawn from `generator` (on
    its device) into parameters on `device`: linears N(0, 1) * 0.25 *
    sqrt(2 / (din + dout)) with zero biases, relative position tables,
    the position embedding, the patch embedding and the token tables
    N(0, 1) * 0.02, the neck's and the upscaler's convolutions N(0, 1) *
    0.05 with zero biases, the Fourier matrix N(0, 1), unit norms."""
    with torch.device("meta"):
        model = SAM(cfg)
    model = model.to_empty(device=device or generator.device)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                init_linear_(m, generator)
            elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, Attention):
                normal_(m.rel_pos_h, 0.02, generator)
                normal_(m.rel_pos_w, 0.02, generator)
            elif isinstance(m, nn.Embedding):
                normal_(m.weight, 0.02, generator)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                normal_(m.weight, 0.05, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        ie = model.image_encoder
        normal_(ie.patch_embed.proj.weight, 0.02, generator)
        normal_(ie.pos_embed, 0.02, generator)
        normal_(model.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix, 1.0, generator)
    return model
