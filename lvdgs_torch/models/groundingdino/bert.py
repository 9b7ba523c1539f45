"""BERT-base text encoder, GroundingDINO's text tower (PyTorch port of
``lvdgs_tpu/models/groundingdino/bert.py``).

Post-norm encoder layers (LayerNorm eps 1e-12), token type 0 throughout,
an additive -1e9 attention mask: the detector passes the phrase-block
self-attention mask and per-phrase position ids. Module names are those of
HuggingFace's BertModel, as the official checkpoint holds them under
`bert.`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    layers: int = 12
    heads: int = 12
    mlp: int = 3072
    max_pos: int = 512
    type_vocab: int = 2


TINY_BERT = BertConfig(vocab_size=128, dim=32, layers=2, heads=2, mlp=64, max_pos=64)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.position_embeddings = nn.Embedding(cfg.max_pos, cfg.dim)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab, cfg.dim)
        self.LayerNorm = nn.LayerNorm(cfg.dim, eps=LN_EPS)


class BertSelfAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)


class BertDenseNorm(nn.Module):
    """A dense layer and the LayerNorm of its residual sum."""

    def __init__(self, din: int, dim: int):
        super().__init__()
        self.dense = nn.Linear(din, dim)
        self.LayerNorm = nn.LayerNorm(dim, eps=LN_EPS)


class BertAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.self = BertSelfAttention(dim)
        self.output = BertDenseNorm(dim, dim)


class BertIntermediate(nn.Module):
    def __init__(self, dim: int, mlp: int):
        super().__init__()
        self.dense = nn.Linear(dim, mlp)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.heads = cfg.heads
        self.attention = BertAttention(cfg.dim)
        self.intermediate = BertIntermediate(cfg.dim, cfg.mlp)
        self.output = BertDenseNorm(cfg.mlp, cfg.dim)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        H = self.heads
        sa = self.attention.self

        def heads(t):
            return t.reshape(B, L, H, D // H).transpose(1, 2)

        q, k, v = heads(sa.query(x)), heads(sa.key(x)), heads(sa.value(x))
        att = torch.matmul(q, k.transpose(-2, -1)) * (D // H) ** -0.5
        out = torch.matmul(torch.softmax(att + bias, dim=-1), v).transpose(1, 2).reshape(B, L, D)
        ao = self.attention.output
        x = ao.LayerNorm(x + ao.dense(out))
        h = F.gelu(self.intermediate.dense(x), approximate="none")
        return self.output.LayerNorm(x + self.output.dense(h))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg) for _ in range(cfg.layers)])


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids: (B, L) integer; attention_mask: (B, L, L) bool or (B,
        L) padding mask. Returns (B, L, dim)."""
        B, L = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(L, device=input_ids.device).expand(B, L)
        e = self.embeddings
        emb = (e.word_embeddings(input_ids) + e.position_embeddings(position_ids)
               + e.token_type_embeddings(torch.zeros_like(input_ids)))
        x = e.LayerNorm(emb)
        if attention_mask.dim() == 2:
            att_mask = attention_mask[:, None, :] & attention_mask[:, :, None]
        else:
            att_mask = attention_mask
        bias = torch.where(att_mask[:, None], 0.0, -1e9).to(x.dtype)  # (B, 1, L, L)
        for blk in self.encoder.layer:
            x = blk(x, bias)
        return x
