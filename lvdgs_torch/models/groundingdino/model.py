"""GroundingDINO open-vocabulary detector in PyTorch (port of
``lvdgs_tpu/models/groundingdino/model.py``).

  Swin-T backbone (swin.py) -> 4 feature levels (256-d neck)
  BERT text tower (bert.py) with phrase-block attention masks
  6 encoder layers: bi-directional image<->text fusion, text self-attention,
    multi-scale deformable image self-attention (ops/msda.py)
  two-stage proposal selection (top num_queries by text-grounded score)
  6 decoder layers: query self-attention, text cross-attention, deformable
    cross-attention, iterative box refinement
  classification = ContrastiveEmbed (query . text features), read from the
    decoder's final norm

Every LayerNorm uses torch's default eps 1e-5, the neck's GroupNorms 32
groups (computed as the reference's, which also takes a 1x1 map). The top-k of the two-stage selection ranks with a stable sort, so
equal scores (the invalid anchors' zeroed rows all score alike) are taken
in index order, as `jax.lax.top_k` takes them, on every device. Module and
parameter names are those of the official checkpoint
(groundingdino_swint_ogc.pth), so its state_dict loads into this module;
the keys it holds that no parameter here reads are dropped by the loader
(convert.py).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.msda import multi_scale_deformable_attention
from ..mast3r.vit import init_linear_, normal_
from .bert import TINY_BERT, BertConfig, BertModel
from .swin import TINY_SWIN, SwinConfig, SwinTransformer


@dataclasses.dataclass(frozen=True)
class GroundingDINOConfig:
    swin: SwinConfig = SwinConfig()
    bert: BertConfig = BertConfig()
    dim: int = 256
    heads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    ffn: int = 2048
    num_queries: int = 900
    n_levels: int = 4
    n_points: int = 4
    max_text_len: int = 256


TINY_GDINO = GroundingDINOConfig(
    swin=TINY_SWIN, bert=TINY_BERT, dim=32, heads=2, enc_layers=2, dec_layers=2,
    ffn=64, num_queries=20, n_points=2, max_text_len=32,
)


def _inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def _freq(npf: int, temperature: float, device) -> torch.Tensor:
    return temperature ** (2 * (torch.arange(npf, device=device) // 2) / npf)


def _interleave(x: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., n): sin of the even channels and cos of the odd
    ones, interleaved pairwise."""
    return torch.stack([torch.sin(x[..., 0::2]), torch.cos(x[..., 1::2])], dim=-1).flatten(-2)


def sine_pos_embed_2d(H: int, W: int, dim: int, device, tempH=20.0, tempW=20.0) -> torch.Tensor:
    """PositionEmbeddingSineHW (num_pos_feats dim / 2): (H, W, dim), the y
    half first."""
    npf = dim // 2
    ys = torch.arange(1, H + 1, dtype=torch.float32, device=device)[:, None] * torch.ones((1, W), device=device)
    xs = torch.arange(1, W + 1, dtype=torch.float32, device=device)[None, :] * torch.ones((H, 1), device=device)
    eps = 1e-6
    ys = ys / (ys[-1:, :] + eps) * 2 * math.pi
    xs = xs / (xs[:, -1:] + eps) * 2 * math.pi
    pos_x = _interleave(xs[..., None] / _freq(npf, tempW, device))
    pos_y = _interleave(ys[..., None] / _freq(npf, tempH, device))
    return torch.cat([pos_y, pos_x], dim=-1)


def sine_embed_boxes(boxes: torch.Tensor, dim: int) -> torch.Tensor:
    """(.., 4) cxcywh in [0, 1] -> (.., 2 dim), DINO's
    gen_sineembed_for_position: dim / 2 channels each, in the order (y, x,
    w, h)."""
    npf = dim // 2
    t = _freq(npf, 10000, boxes.device)

    def emb(v):
        return _interleave(v[..., None] * (2 * math.pi) / t)

    return torch.cat([emb(boxes[..., 1]), emb(boxes[..., 0]), emb(boxes[..., 2]), emb(boxes[..., 3])], dim=-1)


def sine_pos_1d(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """get_sine_pos_embed (temperature 10000): scalar positions -> (..,
    dim), the text tokens' position embedding from their per-phrase ids."""
    return _interleave(pos[..., None] * (2 * math.pi) / _freq(dim, 10000.0, pos.device))


# ---------------------------------------------------------------------------
# layers


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (q, k, v packed in
    in_proj), attention as matmul, softmax, matmul with an additive bias."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, bias=None):
        B, Nq, D = q.shape
        h = self.heads
        d = D // h
        W, b = self.in_proj_weight, self.in_proj_bias
        qq = F.linear(q, W[:D], b[:D]).reshape(B, Nq, h, d).transpose(1, 2)
        kk = F.linear(k, W[D:2 * D], b[D:2 * D]).reshape(B, -1, h, d).transpose(1, 2)
        vv = F.linear(v, W[2 * D:], b[2 * D:]).reshape(B, -1, h, d).transpose(1, 2)
        att = torch.matmul(qq, kk.transpose(-2, -1)) * d ** -0.5
        if bias is not None:
            att = att + bias
        out = torch.matmul(torch.softmax(att, dim=-1), vv)
        return self.out_proj(out.transpose(1, 2).reshape(B, Nq, D))


class BiMultiHeadAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        for name in ("v_proj", "l_proj", "values_v_proj", "values_l_proj", "out_v_proj", "out_l_proj"):
            setattr(self, name, nn.Linear(dim, dim))


class BiAttentionBlock(nn.Module):
    """BiAttentionBlock (reference fuse_modules.py:99-295): one attention
    matrix, softmaxed both ways, layer-scaled residuals on the normed
    inputs (the reference overwrites its inputs with their norms before
    the residual sum)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.layer_norm_v = nn.LayerNorm(dim)
        self.layer_norm_l = nn.LayerNorm(dim)
        self.attn = BiMultiHeadAttention(dim)
        self.gamma_v = nn.Parameter(torch.zeros(dim))
        self.gamma_l = nn.Parameter(torch.zeros(dim))

    def forward(self, img, text, text_mask):
        B, Ni, D = img.shape
        Nt = text.shape[1]
        h = self.heads
        d = D // h
        a = self.attn
        imgn, textn = self.layer_norm_v(img), self.layer_norm_l(text)
        vq = a.v_proj(imgn).reshape(B, Ni, h, d).transpose(1, 2)
        lq = a.l_proj(textn).reshape(B, Nt, h, d).transpose(1, 2)
        vv = a.values_v_proj(imgn).reshape(B, Ni, h, d).transpose(1, 2)
        lv = a.values_l_proj(textn).reshape(B, Nt, h, d).transpose(1, 2)
        att = (torch.matmul(vq, lq.transpose(-2, -1)) * d ** -0.5).clamp(-50000.0, 50000.0)  # (B, h, Ni, Nt)
        mask = torch.where(text_mask[:, None, None, :], 0.0, -1e9)
        att_v2l = torch.softmax(att + mask, dim=-1)  # the image attends the text
        att_l2v = torch.softmax(att, dim=-2).transpose(-2, -1)  # the text attends the image
        dv = torch.matmul(att_v2l, lv).transpose(1, 2).reshape(B, Ni, D)
        dl = torch.matmul(att_l2v, vv).transpose(1, 2).reshape(B, Nt, D)
        return imgn + self.gamma_v * a.out_v_proj(dv), textn + self.gamma_l * a.out_l_proj(dl)


class MSDeformAttn(nn.Module):
    def __init__(self, cfg: GroundingDINOConfig):
        super().__init__()
        D, nH, nL, nP = cfg.dim, cfg.heads, cfg.n_levels, cfg.n_points
        self.nH, self.nL, self.nP = nH, nL, nP
        self.sampling_offsets = nn.Linear(D, nH * nL * nP * 2)
        self.attention_weights = nn.Linear(D, nH * nL * nP)
        self.value_proj = nn.Linear(D, D)
        self.output_proj = nn.Linear(D, D)

    def forward(self, query, query_pos, value, ref_points, spatial_shapes):
        """ref_points: (B, Q, 4) cxcywh or (B, Q, 2) centres, normalised."""
        B, Q, D = query.shape
        nH, nL, nP = self.nH, self.nL, self.nP
        q = query if query_pos is None else query + query_pos
        offsets = self.sampling_offsets(q).reshape(B, Q, nH, nL, nP, 2)
        weights = torch.softmax(self.attention_weights(q).reshape(B, Q, nH, nL * nP), dim=-1)
        weights = weights.reshape(B, Q, nH, nL, nP)
        v = self.value_proj(value).reshape(B, -1, nH, D // nH)
        if ref_points.shape[-1] == 4:
            centers = ref_points[:, :, None, None, None, :2]
            wh = ref_points[:, :, None, None, None, 2:]
            locs = centers + offsets / nP * wh * 0.5
        else:
            shapes_wh = torch.tensor([[w, h] for (h, w) in spatial_shapes], dtype=torch.float32,
                                     device=query.device)
            locs = ref_points[:, :, None, None, None, :] + offsets / shapes_wh[None, None, None, :, None, :]
        return self.output_proj(multi_scale_deformable_attention(v, spatial_shapes, locs, weights))


class EncoderLayer(nn.Module):
    """transformer.encoder.layers.i: deformable image self-attention, FFN."""

    def __init__(self, cfg: GroundingDINOConfig):
        super().__init__()
        D = cfg.dim
        self.self_attn = MSDeformAttn(cfg)
        self.norm1 = nn.LayerNorm(D)
        self.linear1 = nn.Linear(D, cfg.ffn)
        self.linear2 = nn.Linear(cfg.ffn, D)
        self.norm2 = nn.LayerNorm(D)

    def forward(self, img, img_pos, ref_points, spatial_shapes):
        img = self.norm1(img + self.self_attn(img, img_pos, img, ref_points, spatial_shapes))
        return self.norm2(img + self.linear2(F.relu(self.linear1(img))))


class TextEnhancerLayer(nn.Module):
    """transformer.encoder.text_layers.i: text self-attention within the
    phrase blocks, FFN."""

    def __init__(self, cfg: GroundingDINOConfig):
        super().__init__()
        D = cfg.dim
        self.self_attn = MultiheadAttention(D, cfg.heads)
        self.norm1 = nn.LayerNorm(D)
        self.linear1 = nn.Linear(D, cfg.ffn)
        self.linear2 = nn.Linear(cfg.ffn, D)
        self.norm2 = nn.LayerNorm(D)

    def forward(self, text, text_pos, self_bias):
        tq = text + text_pos
        text = self.norm1(text + self.self_attn(tq, tq, text, self_bias))
        return self.norm2(text + self.linear2(F.relu(self.linear1(text))))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GroundingDINOConfig):
        super().__init__()
        D = cfg.dim
        self.self_attn = MultiheadAttention(D, cfg.heads)
        self.norm2 = nn.LayerNorm(D)
        self.ca_text = MultiheadAttention(D, cfg.heads)
        self.catext_norm = nn.LayerNorm(D)
        self.cross_attn = MSDeformAttn(cfg)
        self.norm1 = nn.LayerNorm(D)
        self.linear1 = nn.Linear(D, cfg.ffn)
        self.linear2 = nn.Linear(cfg.ffn, D)
        self.norm3 = nn.LayerNorm(D)

    def forward(self, tgt, query_pos, memory, text, ref_points, spatial_shapes, text_bias):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        tgt = self.catext_norm(tgt + self.ca_text(tgt + query_pos, text, text, text_bias))
        tgt = self.norm1(tgt + self.cross_attn(tgt, query_pos, memory, ref_points, spatial_shapes))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm's parameters, computed as the reference computes it
    (mean and biased variance per group, eps 1e-5), which also takes a
    group of one value: the extra level's 1x1 map at small inputs, which
    F.group_norm refuses."""

    def forward(self, x):
        B, C, H, W = x.shape
        xg = x.reshape(B, self.num_groups, C // self.num_groups, H, W)
        mu = xg.mean(dim=(2, 3, 4), keepdim=True)
        var = ((xg - mu) ** 2).mean(dim=(2, 3, 4), keepdim=True)
        x = ((xg - mu) * torch.rsqrt(var + self.eps)).reshape(B, C, H, W)
        return x * self.weight[None, :, None, None] + self.bias[None, :, None, None]


class MLP(nn.Module):
    """Linear layers with ReLU between them."""

    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: GroundingDINOConfig):
        super().__init__()
        n = cfg.enc_layers
        self.layers = nn.ModuleList([EncoderLayer(cfg) for _ in range(n)])
        self.text_layers = nn.ModuleList([TextEnhancerLayer(cfg) for _ in range(n)])
        self.fusion_layers = nn.ModuleList([BiAttentionBlock(cfg.dim, cfg.heads) for _ in range(n)])


class Decoder(nn.Module):
    def __init__(self, cfg: GroundingDINOConfig):
        super().__init__()
        D = cfg.dim
        self.layers = nn.ModuleList([DecoderLayer(cfg) for _ in range(cfg.dec_layers)])
        self.ref_point_head = MLP((2 * D, D, D))
        self.norm = nn.LayerNorm(D)


class Transformer(nn.Module):
    def __init__(self, cfg: GroundingDINOConfig):
        super().__init__()
        D = cfg.dim
        self.level_embed = nn.Parameter(torch.zeros(cfg.n_levels, D))
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.enc_output = nn.Linear(D, D)
        self.enc_output_norm = nn.LayerNorm(D)
        self.enc_out_bbox_embed = MLP((D, D, D, 4))
        self.tgt_embed = nn.Embedding(cfg.num_queries, D)


class GroundingDINO(nn.Module):
    def __init__(self, cfg: GroundingDINOConfig = GroundingDINOConfig()):
        super().__init__()
        self.cfg = cfg
        D = cfg.dim
        self.backbone = nn.ModuleList([SwinTransformer(cfg.swin)])
        self.bert = BertModel(cfg.bert)
        self.feat_map = nn.Linear(cfg.bert.dim, D)
        swin_dims = [cfg.swin.embed_dim * 2 ** i for i in cfg.swin.out_indices]
        groups = min(32, D)
        self.input_proj = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(c, D, 1), GroupNorm(groups, D)) for c in swin_dims]
            + [nn.Sequential(nn.Conv2d(swin_dims[-1], D, 3, stride=2, padding=1), GroupNorm(groups, D))]
        )
        self.transformer = Transformer(cfg)
        self.bbox_embed = nn.ModuleList([MLP((D, D, D, 4))])


def _contrastive_logits(queries, text, text_mask, max_text_len: int):
    """ContrastiveEmbed: query . text, -inf on padding, padded with -inf
    (or cut) to max_text_len."""
    logits = torch.matmul(queries, text.transpose(-2, -1))
    logits = torch.where(text_mask[:, None, :], logits, -math.inf)
    L = logits.shape[-1]
    if L < max_text_len:
        pad = torch.full((*logits.shape[:2], max_text_len - L), -math.inf, device=logits.device)
        logits = torch.cat([logits, pad], dim=-1)
    return logits[..., :max_text_len]


@functools.lru_cache(maxsize=16)
def token_centres(spatial_shapes) -> np.ndarray:
    """(N, 2) float32 (x, y) normalised centre of every token of every
    level: the encoder's reference points and the two-stage anchors'
    centres. Made on the host in IEEE float32, as the reference computes
    them: on CUDA, torch divides by a Python scalar through its reciprocal,
    which moves (49 + 0.5) / 50 below the anchors' 0.99 bound and makes the
    last column of a 50-wide level valid (the street's 16x50 level)."""
    refs = []
    for Hl, Wl in spatial_shapes:
        ys = (np.arange(Hl, dtype=np.float32) + np.float32(0.5)) / np.float32(Hl)
        xs = (np.arange(Wl, dtype=np.float32) + np.float32(0.5)) / np.float32(Wl)
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        refs.append(np.stack([gx, gy], -1).reshape(Hl * Wl, 2))
    return np.concatenate(refs, 0)


def top_k_in_index_order(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, equal scores
    in index order (jax.lax.top_k's order): a stable descending sort."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


@torch.no_grad()
def groundingdino_forward(model: GroundingDINO, img, input_ids, text_self_mask, text_pad_mask,
                          position_ids=None, topk: Optional[torch.Tensor] = None):
    """img: (B, 3, H, W) normalised; input_ids: (B, L); text_self_mask: (B,
    L, L) phrase-block mask; text_pad_mask: (B, L) True on real tokens;
    position_ids: (B, L) per-phrase ids (arange when None). `topk` (B,
    num_queries) replaces the two-stage selection's indices (to feed the
    decoder another device's choice). Returns dict(logits (B, Q,
    max_text_len), boxes (B, Q, 4) cxcywh, topk (B, Q), scores (B, N) the
    selection's per-token scores)."""
    cfg = model.cfg
    tr = model.transformer
    B = img.shape[0]
    D = cfg.dim
    dev = img.device
    if position_ids is None:
        position_ids = torch.arange(input_ids.shape[1], device=dev).expand(input_ids.shape)

    # ---- backbone and neck
    feats = model.backbone[0](img)
    srcs = [proj(f) for proj, f in zip(model.input_proj, feats)]
    srcs.append(model.input_proj[len(feats)](feats[-1]))
    spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
    tokens, poss = [], []
    for lvl, s in enumerate(srcs):
        Hl, Wl = s.shape[2], s.shape[3]
        tokens.append(s.reshape(B, D, Hl * Wl).transpose(1, 2))
        pe = sine_pos_embed_2d(Hl, Wl, D, dev).reshape(1, Hl * Wl, D)
        poss.append(pe + tr.level_embed[lvl][None, None])
    memory = torch.cat(tokens, dim=1)  # (B, N, D)
    mem_pos = torch.cat(poss, dim=1)

    enc_refs = torch.as_tensor(token_centres(spatial_shapes), device=dev)[None].expand(B, memory.shape[1], 2)

    # ---- text tower
    text = model.feat_map(model.bert(input_ids, text_self_mask, position_ids=position_ids))
    text_pos = sine_pos_1d(position_ids.to(torch.float32), D)

    # ---- encoder
    self_bias = torch.where(text_self_mask[:, None], 0.0, -1e9)  # (B, 1, L, L)
    enc = tr.encoder
    for fusion, text_layer, layer in zip(enc.fusion_layers, enc.text_layers, enc.layers):
        memory, text = fusion(memory, text, text_pad_mask)
        text = text_layer(text, text_pos, self_bias)
        memory = layer(memory, mem_pos, enc_refs, spatial_shapes)

    # ---- two-stage proposals: anchor wh 0.05 * 2^level; anchors outside
    # (0.01, 0.99) are invalid: their memory rows are zeroed, their
    # logit-space anchors infinite
    whs = torch.cat([torch.full((Hl * Wl, 2), 0.05 * (2.0 ** lvl), device=dev)
                     for lvl, (Hl, Wl) in enumerate(spatial_shapes)], dim=0)[None]
    anchors = torch.cat([enc_refs, whs.expand(B, enc_refs.shape[1], 2)], dim=-1)
    valid = ((anchors > 0.01) & (anchors < 0.99)).all(-1, keepdim=True)
    anchors_unsig = torch.where(valid, torch.log(anchors / (1.0 - anchors)), math.inf)
    out_mem = torch.where(valid, memory, 0.0)
    out_mem = tr.enc_output_norm(tr.enc_output(out_mem))
    enc_logits = _contrastive_logits(out_mem, text, text_pad_mask, cfg.max_text_len)
    scores = torch.where(torch.isfinite(enc_logits), enc_logits, -math.inf).amax(-1)
    if topk is None:
        topk = top_k_in_index_order(scores, cfg.num_queries)
    props = torch.sigmoid(anchors_unsig + tr.enc_out_bbox_embed(out_mem))
    ref = torch.gather(props, 1, topk[..., None].expand(-1, -1, 4))  # (B, Q, 4)
    tgt = tr.tgt_embed.weight[None].expand(B, cfg.num_queries, D)

    # ---- decoder with iterative refinement
    text_bias = torch.where(text_pad_mask[:, None, None, :], 0.0, -1e9)
    dec = tr.decoder
    for layer in dec.layers:
        qpos = dec.ref_point_head(sine_embed_boxes(ref, D))
        tgt = layer(tgt, qpos, memory, text, ref, spatial_shapes, text_bias)
        ref = torch.sigmoid(_inverse_sigmoid(ref) + model.bbox_embed[0](tgt))

    # the classification head reads the normed decoder output; the boxes
    # the raw one
    logits = _contrastive_logits(dec.norm(tgt), text, text_pad_mask, cfg.max_text_len)
    return {"logits": logits, "boxes": ref, "topk": topk, "scores": scores}


# ---------------------------------------------------------------------------
# random init, with the reference's distributions


def init_params(cfg: GroundingDINOConfig, generator: torch.Generator, device=None) -> GroundingDINO:
    """A GroundingDINO with the reference's random init, drawn from
    `generator` (on its device) into parameters on `device`: linears
    N(0, 1) * 0.25 * sqrt(2 / (din + dout)) with zero biases (packed
    attention projections each as its own D x D linear), Swin's relative
    position tables N(0, 1) * 0.02, the patch embedding N(0, 1) * 0.05, BERT's
    embedding tables, the level embedding and the query table N(0, 1) *
    0.02, the neck's convolutions N(0, 1) * 0.02, the fusion gammas 0.125,
    unit norms."""
    with torch.device("meta"):
        model = GroundingDINO(cfg)
    model = model.to_empty(device=device or generator.device)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                init_linear_(m, generator)
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, MultiheadAttention):
                D = m.in_proj_weight.shape[1]
                for i in range(3):
                    normal_(m.in_proj_weight[i * D:(i + 1) * D], 0.25 * math.sqrt(2.0 / (2 * D)), generator)
                nn.init.zeros_(m.in_proj_bias)
            elif isinstance(m, BiAttentionBlock):
                m.gamma_v.fill_(0.125)
                m.gamma_l.fill_(0.125)
            elif isinstance(m, nn.Embedding):
                normal_(m.weight, 0.02, generator)
        sw = model.backbone[0]
        normal_(sw.patch_embed.proj.weight, 0.05, generator)
        nn.init.zeros_(sw.patch_embed.proj.bias)
        for stage in sw.layers:
            for blk in stage.blocks:
                normal_(blk.attn.relative_position_bias_table, 0.02, generator)
        for seq in model.input_proj:
            normal_(seq[0].weight, 0.02, generator)
            nn.init.zeros_(seq[0].bias)
        normal_(model.transformer.level_embed, 0.02, generator)
    return model
