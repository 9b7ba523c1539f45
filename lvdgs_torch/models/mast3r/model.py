"""AsymmetricMASt3R: the two-view pointmap and descriptor network (PyTorch
port of ``lvdgs_tpu/models/mast3r/model.py``).

Both images go through one shared RoPE ViT encoder; two decoders
cross-attend to each other's view; each view's catMLP+DPT head gives
    pts3d (H, W, 3)  metric pointmap in view 1's frame ("exp" depth mode),
    conf (H, W)      confidence (1 + exp),
    desc (H, W, 24)  L2-normalised local descriptors (pixel-shuffled MLP),
    desc_conf (H, W) descriptor confidence (exp).

`MASt3R`'s parameter names are the official checkpoint's
(``MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth``), so its
`state_dict` loads directly. The SLAM loop runs one fused forward per
tracked frame (`mast3r_forward_fused`): the two images encoded once, the
(keyframe, current) pose pair and the (current, current) depth pair
decoded as one batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import vit
from .dpt import DPTHead, init_convs_


@dataclasses.dataclass(frozen=True)
class MASt3RConfig:
    """The published ViT-Large encoder / ViT-Base decoder defaults."""

    patch_size: int = 16
    enc_dim: int = 1024
    enc_depth: int = 24
    enc_heads: int = 16
    dec_dim: int = 768
    dec_depth: int = 12
    dec_heads: int = 12
    local_feat_dim: int = 24
    two_confs: bool = True
    rope_base: float = 100.0
    conf_vmin: float = 1.0
    desc_conf_vmin: float = 0.0

    @property
    def hooks(self):
        """The DPT's four hook layers of [encoder, decoder 1..L]."""
        l2 = self.dec_depth
        return (0, l2 * 2 // 4, l2 * 3 // 4, l2)


TINY = MASt3RConfig(enc_dim=64, enc_depth=2, enc_heads=2, dec_dim=48, dec_depth=4,
                    dec_heads=2, local_feat_dim=8)


class CatMLPDPTHead(nn.Module):
    """The DPT on the hook layers and the local-feature MLP on [encoder |
    last decoder] tokens, pixel-shuffled to full resolution."""

    def __init__(self, cfg: MASt3RConfig):
        super().__init__()
        self.cfg = cfg
        d, dd = cfg.enc_dim, cfg.dec_dim
        self.dpt = DPTHead(dim_tokens=(d, dd, dd, dd), num_channels=4)
        idim = d + dd
        out = (cfg.local_feat_dim + int(cfg.two_confs)) * cfg.patch_size ** 2
        self.head_local_features = vit.Mlp(idim, int(4.0 * idim), out)

    def forward(self, outs, grid_hw) -> torch.Tensor:
        """The raw feature map (B, H, W, 4 + local_feat_dim + two_confs)."""
        raw = self.dpt([outs[i] for i in self.cfg.hooks], grid_hw)
        lf = self.head_local_features(torch.cat([outs[0], outs[-1]], dim=-1))
        B, N, _ = lf.shape
        h, w = grid_hw
        lf = F.pixel_shuffle(lf.transpose(1, 2).reshape(B, -1, h, w), self.cfg.patch_size)
        return torch.cat([raw, lf], dim=1).permute(0, 2, 3, 1)


def postprocess(fmap: torch.Tensor, cfg: MASt3RConfig) -> Dict[str, torch.Tensor]:
    """The head's feature map -> pts3d ("exp" depth: direction times
    expm1 of the norm), conf, normalised desc and desc_conf."""
    xyz = fmap[..., 0:3]
    d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    pts3d = xyz / torch.clamp(d, min=1e-8) * torch.expm1(d)
    conf = cfg.conf_vmin + torch.exp(fmap[..., 3])
    desc = fmap[..., 4:4 + cfg.local_feat_dim]
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-8)
    desc_conf = (cfg.desc_conf_vmin + torch.exp(fmap[..., 4 + cfg.local_feat_dim])
                 if cfg.two_confs else conf)
    return {"pts3d": pts3d, "conf": conf, "desc": desc, "desc_conf": desc_conf}


class MASt3R(nn.Module):
    def __init__(self, cfg: MASt3RConfig = MASt3RConfig()):
        super().__init__()
        self.cfg = cfg
        d, dd = cfg.enc_dim, cfg.dec_dim
        self.patch_embed = vit.PatchEmbed(d, cfg.patch_size)
        self.enc_blocks = nn.ModuleList(vit.EncoderBlock(d, cfg.enc_heads) for _ in range(cfg.enc_depth))
        self.enc_norm = vit.layer_norm(d)
        self.decoder_embed = nn.Linear(d, dd)
        self.dec_blocks = nn.ModuleList(vit.DecoderBlock(dd, cfg.dec_heads) for _ in range(cfg.dec_depth))
        self.dec_blocks2 = nn.ModuleList(vit.DecoderBlock(dd, cfg.dec_heads) for _ in range(cfg.dec_depth))
        self.dec_norm = vit.layer_norm(dd)
        self.downstream_head1 = CatMLPDPTHead(cfg)
        self.downstream_head2 = CatMLPDPTHead(cfg)

    def encode(self, img):
        cfg = self.cfg
        tokens, pos = self.patch_embed(img)
        rope = vit.rope2d_angles(pos, cfg.enc_dim // cfg.enc_heads, cfg.rope_base)
        for blk in self.enc_blocks:
            tokens = blk(tokens, rope)
        return self.enc_norm(tokens), pos

    def decode(self, f1, pos1, f2, pos2):
        """The per-layer outputs of both views, [encoder, decoder 1..L],
        the last normed."""
        cfg = self.cfg
        rope1 = vit.rope2d_angles(pos1, cfg.dec_dim // cfg.dec_heads, cfg.rope_base)
        rope2 = vit.rope2d_angles(pos2, cfg.dec_dim // cfg.dec_heads, cfg.rope_base)
        outs1, outs2 = [f1], [f2]
        x1, x2 = self.decoder_embed(f1), self.decoder_embed(f2)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = blk1(x1, x2, rope1, rope2), blk2(x2, x1, rope2, rope1)
            outs1.append(x1)
            outs2.append(x2)
        outs1[-1] = self.dec_norm(outs1[-1])
        outs2[-1] = self.dec_norm(outs2[-1])
        return outs1, outs2

    def heads(self, outs1, outs2, grid_hw, raw: bool = False, grid_hw2=None):
        """Both views' predictions; view 2 at `grid_hw2` where its patch grid
        differs from view 1's."""
        preds = []
        for outs, head, grid in ((outs1, self.downstream_head1, grid_hw),
                                 (outs2, self.downstream_head2, grid_hw2 or grid_hw)):
            fmap = head(outs, grid)
            pred = postprocess(fmap, self.cfg)
            if raw:
                pred["raw"] = fmap
            preds.append(pred)
        return preds


def init_params(cfg: MASt3RConfig, generator: torch.Generator, device=None) -> MASt3R:
    """A MASt3R with the reference's random init, drawn from `generator`
    (on its device) into parameters on `device`: patch embedding N(0, 1) *
    0.02, linears N(0, 1) * 0.25 * sqrt(2 / (din + dout)), convolutions
    N(0, 1) * 0.25 * sqrt(2 / (cin k k)), zero biases, unit LayerNorms."""
    with torch.device("meta"):
        model = MASt3R(cfg)
    model = model.to_empty(device=device or generator.device)
    vit.normal_(model.patch_embed.proj.weight, 0.02, generator)
    nn.init.zeros_(model.patch_embed.proj.bias)
    for part in (model.enc_blocks, model.enc_norm, model.decoder_embed, model.dec_blocks,
                 model.dec_blocks2, model.dec_norm):
        vit.init_blocks_(part, generator)
    for head in (model.downstream_head1, model.downstream_head2):
        init_convs_(head.dpt, generator)
        vit.init_blocks_(head.head_local_features, generator)
    return model


def _split(preds, n: int):
    return [{k: v[:n] for k, v in p.items()} for p in preds], [{k: v[n:] for k, v in p.items()} for p in preds]


def _forward_apart(model: MASt3R, img1, img2, raw: bool = False):
    """mast3r_forward for two views of two shapes (a coarse-to-fine crop
    pair): each view encoded alone, as the official model does, and headed
    at its own patch grid; the reference needs equal shapes."""
    ps = model.cfg.patch_size
    f1, pos1 = model.encode(img1)
    f2, pos2 = model.encode(img2)
    outs1, outs2 = model.decode(f1, pos1, f2, pos2)
    return model.heads(outs1, outs2, (img1.shape[-2] // ps, img1.shape[-1] // ps), raw,
                       (img2.shape[-2] // ps, img2.shape[-1] // ps))


@torch.no_grad()
def mast3r_forward(model: MASt3R, img1, img2, raw: bool = False):
    """img1, img2: (B, 3, H, W) normalised to [-1, 1]. Returns (pred1,
    pred2), view 2's pts3d in view 1's frame; with `raw`, each also holds
    the head's feature map under "raw"."""
    if img1.shape[-2:] != img2.shape[-2:]:
        return _forward_apart(model, img1, img2, raw)
    ps = model.cfg.patch_size
    grid_hw = (img1.shape[-2] // ps, img1.shape[-1] // ps)
    tokens, pos = model.encode(torch.cat([img1, img2], dim=0))
    B = img1.shape[0]
    outs1, outs2 = model.decode(tokens[:B], pos, tokens[B:], pos)
    pred1, pred2 = model.heads(outs1, outs2, grid_hw, raw)
    return pred1, pred2


@torch.no_grad()
def mast3r_forward_fused(model: MASt3R, img_kf, img_cur, raw: bool = False):
    """Both per-tracked-frame forwards in one: the two images encoded once
    (a batch of 2), then the (keyframe, current) pose pair and the
    (current, current) depth pair decoded and headed as one batch. Returns
    (pose_pred1, pose_pred2, depth_pred1)."""
    ps = model.cfg.patch_size
    grid_hw = (img_kf.shape[-2] // ps, img_kf.shape[-1] // ps)
    tokens, pos = model.encode(torch.cat([img_kf, img_cur], dim=0))
    B = img_kf.shape[0]
    f_kf, f_cur = tokens[:B], tokens[B:]
    outs1, outs2 = model.decode(torch.cat([f_kf, f_cur]), pos, torch.cat([f_cur, f_cur]), pos)
    (pose1, pose2), (depth1, _) = _split(model.heads(outs1, outs2, grid_hw, raw), B)
    return pose1, pose2, depth1


