"""Class-list dynamic-object filter (legacy masker path; port of
``lvdgs_tpu/perception/dynamic_filter.py``, host-side NumPy).

Parity with reference utils/Dynamic.py (DynamicObjectFilter :9-116): the
YOLOv8-seg variant used by the `duna` frontend masks 12 COCO dynamic classes
with optional SAM refinement. Ultralytics isn't available here; the same
capability is provided by the open-vocabulary detector prompted with the
COCO dynamic-class list (a strict superset of YOLO's closed set), with the
same API surface.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

COCO_DYNAMIC_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "bus", "train", "truck",
    "boat", "bird", "cat", "dog", "horse",
]


class DynamicObjectFilter:
    def __init__(
        self,
        detector=None,
        segmenter=None,
        confidence: float = 0.35,
        classes=None,
        use_sam: bool = True,
    ):
        self.detector = detector
        self.segmenter = segmenter if use_sam else None
        self.confidence = confidence
        self.classes = classes or COCO_DYNAMIC_CLASSES
        self.prompt = " . ".join(self.classes)

    def get_dynamic_mask(self, image_rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> (H, W) bool dynamic mask."""
        H, W = image_rgb.shape[:2]
        mask = np.zeros((H, W), bool)
        if self.detector is None:
            return mask
        boxes, scores = self.detector(image_rgb, self.prompt, self.confidence)
        if len(boxes) == 0:
            return mask
        if self.segmenter is not None:
            try:
                masks = self.segmenter(image_rgb, boxes)
                return np.any(masks, axis=0)
            except Exception:
                pass
        for x0, y0, x1, y1 in boxes.astype(int):
            mask[max(y0, 0) : min(y1, H), max(x0, 0) : min(x1, W)] = True
        return mask

    def get_static_mask(self, image_rgb: np.ndarray, frame_idx: int = 0) -> np.ndarray:
        return ~self.get_dynamic_mask(image_rgb)
