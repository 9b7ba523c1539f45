"""SAM inference: box-prompted segmentation for the masking stack (PyTorch
port of ``lvdgs_tpu/models/sam/inference.py``).

`load_segmenter(ckpt)` returns the callable the DynamicObjectMasker takes,
(image_rgb_u8 (H, W, 3), boxes_xyxy (N, 4) in pixels) -> (N, H, W) bool
masks, as the reference's SamPredictor use: the long side resized to 1024
and the square zero-padded, at most 32 boxes, each decoded on its own, the
single-mask output (token 0), upsampled to the padded square, cropped and
resized to the frame. Both mask resizes are jax.image.resize's bilinear
(antialiased when it shrinks, as for frames under 1024 pixels), on the
network's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..groundingdino.inference import resize_u8
from ..mast3r.dpt import resize_bilinear
from .model import SAM, SAMConfig, sam_encode_image, sam_predict_masks

PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


class SAMSegmenter:
    MAX_BOXES = 32  # the reference's cap

    def __init__(self, model: SAM):
        self.model = model
        self.cfg = model.cfg

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[SAMConfig] = None, device=None):
        from .convert import load_converted

        return cls(load_converted(path, cfg, device))

    def preprocess(self, img_u8: np.ndarray):
        """-> ((1, 3, S, S) normalised and zero-padded, (newH, newW))."""
        H, W = img_u8.shape[:2]
        S = self.cfg.img_size
        scale = S / max(H, W)
        newH, newW = int(round(H * scale)), int(round(W * scale))
        x = (resize_u8(img_u8, (newH, newW)).astype(np.float32) - PIXEL_MEAN) / PIXEL_STD
        padded = np.zeros((S, S, 3), np.float32)
        padded[:newH, :newW] = x
        return padded.transpose(2, 0, 1)[None], (newH, newW)

    def box_inputs(self, img_u8: np.ndarray, boxes_xyxy: np.ndarray) -> torch.Tensor:
        """Pixel boxes scaled to the model's resolution, shifted to pixel
        centres (+0.5, the official prompt encoder's) and normalised to the
        padded square; the first MAX_BOXES."""
        S = self.cfg.img_size
        scale = S / max(img_u8.shape[:2])
        boxes = (np.asarray(boxes_xyxy, np.float32)[:self.MAX_BOXES] * scale + 0.5) / S
        return torch.as_tensor(boxes, device=self.device)

    @torch.no_grad()
    def mask_logits(self, img_u8: np.ndarray, boxes_xyxy: np.ndarray) -> torch.Tensor:
        """(min(N, MAX_BOXES), H, W) mask logits at the frame's size, on the
        device."""
        H, W = img_u8.shape[:2]
        S = self.cfg.img_size
        x, (newH, newW) = self.preprocess(img_u8)
        emb = sam_encode_image(self.model, torch.as_tensor(x, device=self.device))
        masks, _ = sam_predict_masks(self.model, emb, self.box_inputs(img_u8, boxes_xyxy))
        m = resize_bilinear(masks[:, 0][None], (S, S))[:, :, :newH, :newW]
        return resize_bilinear(m, (H, W))[0]

    def __call__(self, img_u8: np.ndarray, boxes_xyxy: np.ndarray) -> np.ndarray:
        H, W = img_u8.shape[:2]
        if len(boxes_xyxy) == 0:
            return np.zeros((0, H, W), bool)
        return (self.mask_logits(img_u8, boxes_xyxy) > 0.0).cpu().numpy()


def load_segmenter(ckpt_path: str, device=None) -> SAMSegmenter:
    """The segmenter hook from a checkpoint, on `device` (the card when
    None; raises without one)."""
    return SAMSegmenter.from_checkpoint(ckpt_path, device=device)
