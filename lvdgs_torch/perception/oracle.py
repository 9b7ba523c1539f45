"""Oracle perception hooks for the dynamic street scene (port of
``lvdgs_tpu/perception/oracle.py``).

With no detector or segmenter weights, the dynamic-scene path runs end to
end on ground-truth stand-ins wired through the real plumbing:

- ``OracleMasker``: returns the dataset's GT static mask directly — the
  upper bound of the masking ladder, used for the headline masked-vs-
  unmasked quality claim.
- ``OracleDetector`` / ``OracleSegmenter``: emit GT-derived boxes and
  per-box masks so the full ``DynamicObjectMasker`` ladder (detector ->
  SAM fusion -> flow refinement -> temporal median, perception/masking.py)
  runs exactly as it would with GroundingDINO + SAM (reference
  utils/slam_frontend.py:832-1183), exercising every stage in between.

The synthetic dataset's GT mask lives on its device; it reaches these
host-side hooks through ``.cpu()``.
- ``OracleLadderMasker``: a DynamicObjectMasker whose hooks are the oracle
  detector/segmenter (they need the frame index, which the detector
  protocol does not carry).
"""
from __future__ import annotations

import numpy as np

from .masking import DynamicObjectMasker


def _host_mask(m) -> np.ndarray:
    """A mask (tensor on any device, or array) as a host bool array."""
    if hasattr(m, "detach"):
        m = m.detach().cpu().numpy()
    return np.asarray(m, bool)


def _boxes_from_mask(dynamic: np.ndarray, min_area: int = 12):
    """Connected components of a bool mask -> (N, 4) xyxy boxes + areas.

    Pure-numpy 2-pass labeling via flood fill over component seeds; scenes
    have only a handful of objects so this is cheap.
    """
    H, W = dynamic.shape
    visited = np.zeros_like(dynamic, dtype=bool)
    boxes = []
    ys, xs = np.nonzero(dynamic)
    order = np.argsort(ys * W + xs)
    for y0, x0 in zip(ys[order], xs[order]):
        if visited[y0, x0]:
            continue
        # BFS flood fill
        stack = [(y0, x0)]
        visited[y0, x0] = True
        ymin = ymax = y0
        xmin = xmax = x0
        area = 0
        while stack:
            y, x = stack.pop()
            area += 1
            ymin, ymax = min(ymin, y), max(ymax, y)
            xmin, xmax = min(xmin, x), max(xmax, x)
            for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ny, nx = y + dy, x + dx
                if 0 <= ny < H and 0 <= nx < W and dynamic[ny, nx] and not visited[ny, nx]:
                    visited[ny, nx] = True
                    stack.append((ny, nx))
        if area >= min_area:
            boxes.append((xmin, ymin, xmax + 1, ymax + 1))
    if not boxes:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
    b = np.asarray(boxes, np.float32)
    return b, np.full((b.shape[0],), 0.99, np.float32)


class OracleMasker:
    """Masker returning the dataset's GT static mask verbatim.

    Interface-compatible with DynamicObjectMasker as SLAM consumes it
    (get_static_mask(image, frame_idx), .save_images, save_keyframe_overlay).
    """

    save_images = False

    def __init__(self, dataset):
        self.dataset = dataset

    def get_static_mask(self, image, frame_idx: int = 0) -> np.ndarray:
        m = self.dataset.get_gt_static_mask(frame_idx)
        if m is None:
            return np.ones(np.asarray(image).shape[-2:], bool)
        return _host_mask(m)

    get_static_mask_for_gaussian_init = get_static_mask

    def save_keyframe_overlay(self, image, static, kf_idx: int) -> None:
        pass


class OracleDetector:
    """GT-box "GroundingDINO": boxes from connected components of the GT
    dynamic mask. `frame_idx` must be set before each call (the detector
    protocol carries only image + prompt); OracleLadderMasker does this."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.frame_idx = 0

    def __call__(self, img_u8, prompt):
        m = self.dataset.get_gt_static_mask(self.frame_idx)
        if m is None:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
        return _boxes_from_mask(~_host_mask(m))


class OracleSegmenter:
    """GT-mask "SAM": per-box mask = GT dynamic mask clipped to the box."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.frame_idx = 0

    def __call__(self, img_u8, boxes):
        H, W = img_u8.shape[:2]
        m = self.dataset.get_gt_static_mask(self.frame_idx)
        dyn = (
            ~_host_mask(m) if m is not None else np.zeros((H, W), bool)
        )
        out = np.zeros((len(boxes), H, W), bool)
        for i, (x0, y0, x1, y1) in enumerate(np.asarray(boxes).astype(int)):
            clip = np.zeros((H, W), bool)
            clip[max(y0, 0): min(y1, H), max(x0, 0): min(x1, W)] = True
            out[i] = dyn & clip
        return out


class OracleLadderMasker(DynamicObjectMasker):
    """The REAL masking ladder driven by oracle hooks: detector boxes ->
    (oracle-)SAM fusion -> optical-flow refinement -> temporal median —
    every stage of perception/masking.py runs; only the two model forwards
    are GT stand-ins."""

    def __init__(self, dataset, **kwargs):
        det = OracleDetector(dataset)
        seg = OracleSegmenter(dataset)
        kwargs.setdefault("use_sam", True)
        # the hallucination failsafe guards against broken DETECTORS; these
        # hooks are GT-derived, and a close-passing truck can legitimately
        # cover most of a small test frame
        kwargs.setdefault("max_dynamic_ratio", 1.01)
        super().__init__(detector=det, segmenter=seg, **kwargs)
        self._oracle_det = det
        self._oracle_seg = seg

    def warmup(self):  # oracle hooks need a frame index; skip random warmup
        pass

    def get_static_mask_for_gaussian_init(self, image, frame_idx: int = 0):
        self._oracle_det.frame_idx = frame_idx
        self._oracle_seg.frame_idx = frame_idx
        return super().get_static_mask_for_gaussian_init(image, frame_idx)

    def get_static_mask(self, image, frame_idx: int = 0):
        return self.get_static_mask_for_gaussian_init(image, frame_idx)
