"""GroundingDINO inference: tokenisation, prompt masks, the detector hook
(PyTorch port of ``lvdgs_tpu/models/groundingdino/inference.py``).

`load_detector(ckpt)` returns the callable the DynamicObjectMasker takes,
(image_rgb_u8, prompt) -> (boxes_xyxy in pixels (N, 4), scores (N,)): the
reference's `predict()` path, with its cxcywh -> xyxy fix.

Tokenisation is a WordPiece tokenizer over a local vocab.txt
(BERT-uncased). The phrase-block self-attention masks follow
generate_masks_with_special_tokens_and_transfer_map: '.', [CLS] and [SEP]
split the caption into phrases, and tokens attend within their phrase.
The network runs on its module's device; the pre- and post-processing on
the host (OpenCV's resize, as the reference's).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...core.log import Log
from .model import GroundingDINO, GroundingDINOConfig, groundingdino_forward

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# packaged fallback vocab: tokenizes the SLAM system's own prompt lexicon
# word-level and any other ASCII word char-level
_PACKAGED_VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "prompt_vocab.txt")


def resize_u8(img_u8: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3): OpenCV's bilinear resize where cv2 is
    present (uint8 out), else the reference's fallback, jax.image.resize's
    antialiased bilinear in float32 (the port's weight-matrix form)."""
    try:
        import cv2

        return cv2.resize(img_u8, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        from ..mast3r.dpt import resize_bilinear

        x = torch.as_tensor(img_u8, dtype=torch.float32).permute(2, 0, 1)[None]
        return resize_bilinear(x, hw)[0].permute(1, 2, 0).numpy()


class WordPieceTokenizer:
    """Minimal BERT-uncased WordPiece tokenizer (vocab.txt driven).

    Vocab resolution order:
    1. an explicit `vocab_path`, else the LVDGS_BERT_VOCAB environment
       variable (required for pretrained GroundingDINO weights: their
       text embedding rows are indexed by bert-base-uncased token ids);
    2. the packaged prompt-lexicon vocab (assets/prompt_vocab.txt):
       deterministic, [UNK]-free for ASCII captions, ids NOT bert-parity;
    3. hash ids: architecture plumbing only (warns).
    """

    def __init__(self, vocab_path: Optional[str] = None):
        self.vocab = {}
        if not vocab_path:
            vocab_path = os.environ.get("LVDGS_BERT_VOCAB") or None
        if vocab_path and os.path.exists(vocab_path):
            self._load(vocab_path)
        elif vocab_path:
            Log(f"WARNING: vocab_path {vocab_path!r} does not exist")
        if not self.vocab:
            if os.path.exists(_PACKAGED_VOCAB):
                self._load(_PACKAGED_VOCAB)
                if vocab_path:
                    Log("WARNING: falling back to the packaged prompt-lexicon vocab — token ids are NOT "
                        "bert-base-uncased; pretrained-weight detections need the real vocab.txt")
            else:
                Log("WARNING: GroundingDINO tokenizer running on HASH ids — no vocab.txt found (not even "
                    "the packaged prompt_vocab.txt). Detections are MEANINGLESS. Supply bert-base-uncased "
                    "vocab.txt via vocab_path.")
        self.cls = self.vocab.get("[CLS]", 101)
        self.sep = self.vocab.get("[SEP]", 102)
        self.unk = self.vocab.get("[UNK]", 100)
        self.dot = self.vocab.get(".", 1012)

    def _load(self, path: str) -> None:
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i

    def _wordpiece(self, word: str) -> List[int]:
        if not self.vocab:
            return [hash(word) % 28000 + 2000]
        if word in self.vocab:
            return [self.vocab[word]]
        out = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = self.vocab[sub]
                    break
                end -= 1
            if piece is None:
                return [self.unk]
            out.append(piece)
            start = end
        return out

    def __call__(self, caption: str) -> List[int]:
        return self.tokenize_with_spans(caption)[0]

    def tokenize_with_spans(self, caption: str):
        """(ids, phrase_idx): phrase_idx[i] is the '.'-separated phrase
        token i belongs to, -1 for special tokens (for decoding the phrase
        each box grounds to)."""
        ids = [self.cls]
        spans = [-1]
        phrase = 0
        seen_word = False
        for tok in caption.lower().replace(".", " . ").split():
            if tok == ".":
                ids.append(self.dot)
                spans.append(-1)
                if seen_word:
                    phrase += 1
                    seen_word = False
            else:
                pieces = self._wordpiece(tok)
                ids.extend(pieces)
                spans.extend([phrase] * len(pieces))
                seen_word = True
        ids.append(self.sep)
        spans.append(-1)
        return ids, spans


def build_text_masks(ids: np.ndarray, special: Tuple[int, ...]):
    """(L,) ids -> ((L, L) phrase-block self-attention mask, (L,) pad mask,
    (L,) per-phrase position ids): each block spans (previous special,
    special], so the terminating '.' attends with its phrase and holds its
    last position id; [CLS] and the last token attend to themselves only,
    at position 0."""
    L = len(ids)
    is_special = np.isin(ids, special)
    mask = np.eye(L, dtype=bool)
    position_ids = np.zeros(L, np.int64)
    previous_col = 0
    for col in np.nonzero(is_special)[0]:
        if col in (0, L - 1):
            position_ids[col] = 0
        else:
            mask[previous_col + 1:col + 1, previous_col + 1:col + 1] = True
            position_ids[previous_col + 1:col + 1] = np.arange(0, col - previous_col)
        previous_col = col
    return mask, np.ones(L, bool), position_ids


class GroundingDINODetector:
    """The network on its device, fed host images and prompts."""

    def __init__(self, model: GroundingDINO, vocab_path: Optional[str] = None, image_size: int = 800):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = WordPieceTokenizer(vocab_path)
        self.image_size = image_size

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[GroundingDINOConfig] = None,
                        vocab_path: Optional[str] = None, device=None):
        from .convert import load_converted

        return cls(load_converted(path, cfg, device), vocab_path)

    def preprocess(self, img_u8: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> (1, 3, h, w) ImageNet-normalised, the long
        side near image_size and both sides multiples of 32."""
        H, W = img_u8.shape[:2]
        scale = self.image_size / max(H, W)
        newH = int(round(H * scale / 32)) * 32 or 32
        newW = int(round(W * scale / 32)) * 32 or 32
        x = (resize_u8(img_u8, (newH, newW)).astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        return x.transpose(2, 0, 1)[None]

    def text_inputs(self, prompt: str):
        """(ids, spans, self_mask, pad_mask, position_ids) as host arrays,
        cut to max_text_len."""
        ids_list, span_list = self.tokenizer.tokenize_with_spans(prompt)
        ids = np.asarray(ids_list, np.int64)[:self.cfg.max_text_len]
        spans = np.asarray(span_list, np.int32)[:self.cfg.max_text_len]
        t = self.tokenizer
        return (ids, spans, *build_text_masks(ids, (t.cls, t.sep, t.dot)))

    def forward_raw(self, img_u8: np.ndarray, prompt: str, topk: Optional[torch.Tensor] = None):
        """The network's outputs before thresholding, on its device:
        dict(logits (1, Q, max_text_len), boxes (1, Q, 4) cxcywh, topk (1,
        Q), scores (1, N)), and the prompt's token spans on the host
        (spans); `topk` replaces the two-stage selection."""
        dev = self.device
        ids, spans, self_mask, pad_mask, position_ids = self.text_inputs(prompt)
        out = groundingdino_forward(
            self.model, torch.as_tensor(self.preprocess(img_u8), device=dev),
            torch.as_tensor(ids, device=dev)[None], torch.as_tensor(self_mask, device=dev)[None],
            torch.as_tensor(pad_mask, device=dev)[None], torch.as_tensor(position_ids, device=dev)[None],
            topk=topk)
        out["spans"] = spans
        return out

    def __call__(self, img_u8: np.ndarray, prompt: str, box_threshold: float = 0.35,
                 return_phrases: bool = False):
        H, W = img_u8.shape[:2]
        out = self.forward_raw(img_u8, prompt)
        logits = out["logits"][0].cpu().numpy()  # (Q, max_text_len)
        boxes = out["boxes"][0].cpu().numpy()  # (Q, 4) cxcywh normalised
        spans = out["spans"]
        with np.errstate(invalid="ignore", over="ignore"):
            scores = 1.0 / (1.0 + np.exp(-np.nan_to_num(logits, neginf=-50.0)))
        best = scores.max(axis=1)
        keep = best >= box_threshold
        boxes = boxes[keep]
        phrases = None
        if return_phrases:
            # the prompt class whose span holds the box's best token
            classes = [c.strip() for c in prompt.split(".") if c.strip()]
            tok_best = scores[keep][:, :len(spans)].argmax(axis=1)
            phrases = []
            for t in tok_best:
                pi = int(spans[t]) if t < len(spans) else -1
                phrases.append(classes[pi] if 0 <= pi < len(classes) else "")
        best = best[keep]
        # cxcywh normalised -> xyxy pixels
        if len(boxes):
            cx, cy, bw, bh = boxes.T
            xyxy = np.stack([(cx - bw / 2) * W, (cy - bh / 2) * H, (cx + bw / 2) * W, (cy + bh / 2) * H], axis=-1)
        else:
            xyxy = np.zeros((0, 4))
        if return_phrases:
            return xyxy, best, phrases
        return xyxy, best


def load_detector(ckpt_path: str, vocab_path: Optional[str] = None, device=None) -> GroundingDINODetector:
    """The detector hook from a checkpoint, on `device` (the card when
    None; raises without one)."""
    return GroundingDINODetector.from_checkpoint(ckpt_path, vocab_path=vocab_path, device=device)
