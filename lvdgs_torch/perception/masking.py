"""Dynamic-object masking with a graceful fallback ladder (port of
``lvdgs_tpu/perception/masking.py``).

Host-side NumPy and OpenCV, as in the reference package; the SLAM loop
hands each frame over once as a host array and sends the mask back to the
device once. The stages:

- `ScenePromptManager`: scene-conditioned text prompts for open-vocabulary
  detection (seven scene types).
- `DynamicObjectMasker.get_static_mask_for_gaussian_init`: the per-frame
  static/dynamic mask that gates Gaussian seeding, the mapping loss and
  the static-region metrics.

Per frame (each stage optional, with the reference's fallbacks):
1. open-vocabulary box detection through the `detector` hook (absent ->
   skipped);
2. box-prompted segmentation through the `segmenter` hook (absent -> the
   boxes become rectangle masks);
3. optical-flow motion refinement (Farneback, OpenCV);
4. a temporal median over the last `temporal_window` masks;
5. a conservative colour/position heuristic on the first frame when there
   is no detector.

Without OpenCV the flow, the first-frame heuristic and the ground
segmentation turn off, as in the reference. The model-backed hooks load
GroundingDINO and SAM (`lvdgs_torch.models`) from configured checkpoints
onto the masker's device (the card unless the caller asks for another);
as in the reference, a checkpoint that does not load leaves its hook
empty (the failure is logged). `HFGroundingDINODetector` is the detector
through HuggingFace `transformers`, where that is installed. Oracle hooks
stand in for the models in tests (`oracle.py`).
"""
from __future__ import annotations

import os
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from ..core.log import Log

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


class ScenePromptManager:
    """Scene-conditioned detection prompts (reference :41-129).

    Prompts are ". "-joined phrase lists per scene; dynamic classes are
    masked out, static-context classes kept."""

    SCENES = {
        "outdoor_street": {
            "dynamic": ["car", "truck", "bus", "motorcycle", "bicycle", "person",
                        "pedestrian", "van", "scooter"],
            "static_context": ["building", "road", "tree", "traffic light", "pole"],
        },
        "highway": {
            "dynamic": ["car", "truck", "bus", "trailer", "motorcycle"],
            "static_context": ["road", "barrier", "sign", "bridge"],
        },
        "parking": {
            "dynamic": ["person", "car door", "moving car", "bicycle"],
            "static_context": ["parked car", "building", "pillar"],
        },
        "residential": {
            "dynamic": ["person", "car", "bicycle", "dog", "cat", "stroller"],
            "static_context": ["house", "fence", "tree", "lawn"],
        },
        "indoor": {
            "dynamic": ["person", "chair being moved", "door", "pet"],
            "static_context": ["wall", "table", "shelf", "floor"],
        },
        "campus": {
            "dynamic": ["person", "bicycle", "skateboard", "scooter", "car"],
            "static_context": ["building", "path", "tree", "bench"],
        },
        "mixed": {
            "dynamic": ["car", "truck", "bus", "person", "bicycle", "motorcycle",
                        "animal"],
            "static_context": ["building", "road", "vegetation"],
        },
    }

    def __init__(self, scene_type: str = "outdoor_street"):
        self.current_scene = scene_type if scene_type in self.SCENES else "mixed"

    def set_scene(self, scene_type: str) -> None:
        if scene_type in self.SCENES:
            self.current_scene = scene_type

    def get_dynamic_prompt(self) -> str:
        return " . ".join(self.SCENES[self.current_scene]["dynamic"])

    def get_classes(self) -> List[str]:
        return list(self.SCENES[self.current_scene]["dynamic"])


class DynamicObjectMasker:
    """Produces per-frame static masks (True = static scene).

    `detector(image_rgb_u8, prompt) -> (boxes_xyxy (N,4), scores (N,))` and
    `segmenter(image_rgb_u8, boxes) -> (N, H, W) bool` are pluggable model
    hooks; without them, configured checkpoints load GroundingDINO and SAM
    onto `device` (the card when None). `saturated_frames` counts the
    frames whose raw mask the hallucination failsafe rejected."""

    def __init__(
        self,
        scene_type: str = "outdoor_street",
        use_sam: bool = True,
        use_flow: bool = True,
        box_threshold: float = 0.35,
        save_dir: Optional[str] = None,
        save_images: bool = False,
        detector=None,
        segmenter=None,
        grounding_dino_checkpoint: Optional[str] = None,
        sam_checkpoint: Optional[str] = None,
        temporal_window: int = 5,
        use_ground_segmentation: bool = False,
        max_dynamic_ratio: float = 0.7,
        device=None,
    ):
        self.device = device
        self.use_ground_segmentation = use_ground_segmentation and cv2 is not None
        self.prompt_manager = ScenePromptManager(scene_type)
        self.use_sam = use_sam
        self.use_flow = use_flow and cv2 is not None
        self.box_threshold = box_threshold
        self.save_dir = save_dir
        self.save_images = save_images and save_dir is not None
        self.detector = detector
        self.segmenter = segmenter
        self._mask_history: deque = deque(maxlen=temporal_window)
        self._prev_gray: Optional[np.ndarray] = None
        self._warned = False
        self._warned_saturated = False
        self.saturated_frames = 0
        self.max_dynamic_ratio = max_dynamic_ratio

        if detector is None and grounding_dino_checkpoint:
            self.detector = self._try_load_grounding_dino(grounding_dino_checkpoint)
        if segmenter is None and use_sam and sam_checkpoint:
            self.segmenter = self._try_load_sam(sam_checkpoint)
        if self.save_images:
            # reference dump layout: 11 categories under save_dir
            # (utils/slam_frontend.py:698-717)
            for d in self.DUMP_DIRS:
                os.makedirs(os.path.join(self.save_dir, d), exist_ok=True)
        if self.detector is not None or self.segmenter is not None:
            self.warmup()

    DUMP_DIRS = (
        "original",
        "grounding_dino_detections",
        "grounding_dino_masks",
        "sam_masks",
        "motion_masks",
        "final_masks",
        "masked_overlay",
        "static_only",
        "keyframes",
        "detection_analysis",
    )

    # ------------------------------------------------------------ model hooks

    def _try_load_grounding_dino(self, ckpt: str):
        try:
            from ..models.groundingdino.inference import load_detector

            return load_detector(ckpt, device=self.device)
        except Exception as e:
            Log(f"WARNING: GroundingDINO checkpoint {ckpt!r} did not load ({type(e).__name__}: {e}) "
                "— detection falls back to the flow ladder")
            return None

    def _try_load_sam(self, ckpt: str):
        try:
            from ..models.sam.inference import load_segmenter

            return load_segmenter(ckpt, device=self.device)
        except Exception as e:
            Log(f"WARNING: SAM checkpoint {ckpt!r} did not load ({type(e).__name__}: {e}) "
                "— box masks stay rectangles")
            return None

    def warmup(self) -> dict:
        """Detector/segmenter init self-test (reference `_warmup_detector`,
        utils/slam_frontend.py:251-276 + utils/SAM.py:152-204): one
        detection on a synthetic scene-like image and one box-prompted
        segmentation, with health logging, so the first real frame does
        not pay the hooks' first-call costs. Returns a
        health dict {detector_ok, detector_ms, n_boxes, segmenter_ok,
        segmenter_ms}."""
        import time as _time

        health = {
            "detector_ok": None, "detector_ms": None, "n_boxes": None,
            "segmenter_ok": None, "segmenter_ms": None,
        }
        # structured ramp + bright block: deterministic, roughly road-scene
        # statistics (the reference warms up on random noise; a structured
        # image exercises the backbone's normalisation more realistically)
        H, W = 240, 320
        yy, xx = np.mgrid[0:H, 0:W]
        img = np.stack(
            [
                (120 + 100 * yy / H).astype(np.uint8),
                (100 + 80 * xx / W).astype(np.uint8),
                np.full((H, W), 128, np.uint8),
            ],
            axis=-1,
        )
        img[140:200, 90:210] = (200, 60, 60)  # car-sized bright block
        if self.detector is not None:
            t0 = _time.perf_counter()
            try:
                boxes, scores = self.detector(
                    img, self.prompt_manager.get_dynamic_prompt()
                )
                health["detector_ok"] = True
                health["n_boxes"] = int(len(boxes))
                health["detector_ms"] = (_time.perf_counter() - t0) * 1e3
                Log(
                    f"Detector warmup OK: {len(boxes)} boxes in "
                    f"{health['detector_ms']:.0f} ms"
                )
            except Exception as e:
                health["detector_ok"] = False
                Log(f"WARNING: detector warmup FAILED ({type(e).__name__}: {e}) "
                    "— dynamic masking will use fallback ladders")
        if self.segmenter is not None:
            t0 = _time.perf_counter()
            try:
                masks = self.segmenter(
                    img, np.array([[90.0, 140.0, 210.0, 200.0]], np.float32)
                )
                health["segmenter_ok"] = bool(np.asarray(masks).shape[0] == 1)
                health["segmenter_ms"] = (_time.perf_counter() - t0) * 1e3
                Log(f"SAM warmup OK in {health['segmenter_ms']:.0f} ms")
            except Exception as e:
                health["segmenter_ok"] = False
                Log(f"WARNING: SAM warmup FAILED ({type(e).__name__}: {e}) "
                    "— box masks degrade to rectangles")
        return health

    def set_scene_from_config(self, config: dict) -> None:
        st = config.get("dynamic_filtering", {}).get("scene_type")
        if st:
            self.prompt_manager.set_scene(st)

    # -------------------------------------------------------------- pipeline

    def get_static_mask_for_gaussian_init(
        self, image, frame_idx: int = 0
    ) -> np.ndarray:
        """(3, H, W) float or (H, W, 3) uint8 image -> (H, W) bool static mask.

        Reference utils/slam_frontend.py:1151-1166 / detect_and_segment :832."""
        img_u8 = self._to_u8_hwc(image)
        H, W = img_u8.shape[:2]

        dynamic = np.zeros((H, W), bool)
        detected = False
        boxes = scores = None
        gd_mask = sam_mask = motion_mask = None
        if self.detector is not None:
            try:
                boxes, scores = self.detector(
                    img_u8, self.prompt_manager.get_dynamic_prompt()
                )
                keep = scores >= self.box_threshold
                boxes, scores = boxes[keep], scores[keep]
                if len(boxes) > 32:
                    # score-ranked cap: realistic scenes have < 10 dynamic
                    # objects; an untrained/misfiring detector can emit
                    # hundreds, and box count drives SAM's compile buckets
                    order = np.argsort(-scores)[:32]
                    boxes, scores = boxes[order], scores[order]
                if len(boxes):
                    dynamic, gd_mask, sam_mask = self._boxes_to_mask(
                        img_u8, boxes
                    )
                detected = True
            except Exception:
                detected = False

        if not detected:
            # fallback ladder: flow-only motion mask, and a conservative
            # color heuristic on the first frame (reference :570-671)
            if self.use_flow:
                motion_mask = self._flow_motion_mask(img_u8)
                dynamic = dynamic | motion_mask
            if frame_idx == 0 and self.detector is None:
                dynamic = dynamic | self._first_frame_heuristic(img_u8)
            if not self._warned:
                self._warned = True
        else:
            if self.use_flow:
                motion_mask = self._flow_motion_mask(img_u8)
                dynamic = self._refine_with_motion(img_u8, dynamic, motion_mask)

        if dynamic.mean() > self.max_dynamic_ratio:
            self.saturated_frames += 1
            # hallucination failsafe: a detector claiming most of the frame
            # is moving is almost certainly wrong (untrained/broken weights,
            # prompt mismatch), and acting on it starves seeding/covisibility
            # and collapses the map. Reject the RAW per-frame mask BEFORE
            # it enters the temporal-median history — otherwise one
            # hallucinated frame biases the median vote of the next
            # temporal_window-1 frames. The health-warning ladder in
            # SLAM._fused_keyframe_depth still surfaces marginal cases.
            if not self._warned_saturated:
                self._warned_saturated = True
                Log(
                    f"WARNING: dynamic mask covers {dynamic.mean():.0%} "
                    f"(> {self.max_dynamic_ratio:.0%}) — rejecting as "
                    "detector hallucination; frame treated as static"
                )
            dynamic = np.zeros_like(dynamic)

        dynamic = self._temporal_consistency(dynamic)
        self._update_flow_state(img_u8)

        if self.use_ground_segmentation:
            # ground is always static; also trims vehicle-shadow bleed into
            # the road (reference slam_frontend_0817.py:1779-1790)
            try:
                ground = segment_ground(img_u8)
                dynamic = dynamic & ~ground
            except Exception:
                pass

        static = ~dynamic
        if self.save_images:
            self._save_detection_results(
                img_u8, static, frame_idx,
                gd_mask=gd_mask, sam_mask=sam_mask, motion_mask=motion_mask,
                final_mask=dynamic, boxes=boxes, scores=scores,
            )
        return static

    # alias used by SLAM system
    def get_static_mask(self, image, frame_idx: int = 0) -> np.ndarray:
        return self.get_static_mask_for_gaussian_init(image, frame_idx)

    # ------------------------------------------------------------- internals

    @staticmethod
    def _to_u8_hwc(image) -> np.ndarray:
        if hasattr(image, "detach"):  # a tensor, possibly on the card
            image = image.detach().cpu().numpy()
        img = np.asarray(image)
        if img.ndim == 3 and img.shape[0] in (1, 3):
            img = img.transpose(1, 2, 0)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return img

    def _boxes_to_mask(self, img_u8: np.ndarray, boxes: np.ndarray):
        """-> (dynamic, gd_box_mask, sam_mask|None) so the dump harness can
        record each stage separately (reference save_detection_results)."""
        H, W = img_u8.shape[:2]
        box_mask = np.zeros((H, W), bool)
        for x0, y0, x1, y1 in boxes.astype(int):
            box_mask[max(y0, 0) : min(y1, H), max(x0, 0) : min(x1, W)] = True
        if self.segmenter is not None and self.use_sam:
            try:
                masks = self.segmenter(img_u8, boxes)  # (N, H, W) bool
                sam_mask = np.any(masks, axis=0)
                return sam_mask, box_mask, sam_mask
            except Exception:
                pass
        return box_mask, box_mask, None

    def _flow_motion_mask(self, img_u8: np.ndarray, thresh: float = 2.0) -> np.ndarray:
        """Farneback flow magnitude thresholding (reference :1116,:651-671)."""
        gray = cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY)
        if self._prev_gray is None or self._prev_gray.shape != gray.shape:
            return np.zeros(gray.shape, bool)
        flow = cv2.calcOpticalFlowFarneback(
            self._prev_gray, gray, None, 0.5, 3, 15, 3, 5, 1.2, 0
        )
        mag = np.linalg.norm(flow, axis=-1)
        med = np.median(mag)
        moving = mag > max(thresh, med * 2.5)  # motion above ego-motion median
        moving = cv2.morphologyEx(
            moving.astype(np.uint8), cv2.MORPH_OPEN, np.ones((5, 5), np.uint8)
        ).astype(bool)
        return moving

    def _refine_with_motion(self, img_u8: np.ndarray, dynamic: np.ndarray,
                            motion: np.ndarray | None = None) -> np.ndarray:
        """Keep detected regions only when coherent with motion, but stay
        conservative: union with strongly-moving regions (reference
        _refine_with_motion :1106-1149)."""
        if motion is None:
            motion = self._flow_motion_mask(img_u8)
        return dynamic | (motion & ~dynamic)

    def _first_frame_heuristic(self, img_u8: np.ndarray) -> np.ndarray:
        """Conservative first-frame mask: strong dark/saturated blobs low in
        the image (vehicle-like) — reference
        _create_conservative_first_frame_mask :570-633."""
        if cv2 is None:
            return np.zeros(img_u8.shape[:2], bool)
        hsv = cv2.cvtColor(img_u8, cv2.COLOR_RGB2HSV)
        H, W = img_u8.shape[:2]
        sat = hsv[..., 1].astype(np.float32) / 255.0
        val = hsv[..., 2].astype(np.float32) / 255.0
        candidate = ((sat > 0.55) | (val < 0.18)) & (
            np.arange(H)[:, None] > 0.4 * H
        )
        candidate = cv2.morphologyEx(
            candidate.astype(np.uint8), cv2.MORPH_OPEN, np.ones((7, 7), np.uint8)
        )
        # keep only medium-sized connected components (vehicle-ish)
        n, labels, stats, _ = cv2.connectedComponentsWithStats(candidate, 8)
        mask = np.zeros((H, W), bool)
        for i in range(1, n):
            area = stats[i, cv2.CC_STAT_AREA]
            if 0.002 * H * W < area < 0.2 * H * W:
                mask |= labels == i
        return mask

    def _temporal_consistency(self, dynamic: np.ndarray) -> np.ndarray:
        """Median vote over the recent mask history (reference :1168-1183)."""
        self._mask_history.append(dynamic)
        if len(self._mask_history) < 3:
            return dynamic
        stack = np.stack(list(self._mask_history), axis=0)
        return np.median(stack.astype(np.float32), axis=0) > 0.5

    def _update_flow_state(self, img_u8: np.ndarray) -> None:
        if cv2 is not None:
            self._prev_gray = cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY)

    def _imwrite(self, category: str, frame_idx: int, img_rgb_or_gray) -> None:
        path = os.path.join(self.save_dir, category, f"frame_{frame_idx:06d}.jpg")
        arr = np.asarray(img_rgb_or_gray)
        if arr.dtype == bool:
            arr = arr.astype(np.uint8) * 255
        if cv2 is not None:
            if arr.ndim == 3:
                arr = cv2.cvtColor(arr, cv2.COLOR_RGB2BGR)
            cv2.imwrite(path, arr)
        else:  # pragma: no cover - cv2 is present in the env
            from PIL import Image

            Image.fromarray(arr).save(path.replace(".jpg", ".png"))

    def _save_detection_results(
        self, img_u8, static, frame_idx, *, gd_mask=None, sam_mask=None,
        motion_mask=None, final_mask=None, boxes=None, scores=None,
    ) -> None:
        """Per-stage mask dumps + detection-analysis record — the
        reference's primary visual-QA mechanism
        (utils/slam_frontend.py:698-717 directory layout, :806-823 analysis
        text)."""
        try:
            self._imwrite("original", frame_idx, img_u8)
            if boxes is not None and len(boxes) and cv2 is not None:
                det = img_u8.copy()
                for bi, (x0, y0, x1, y1) in enumerate(boxes.astype(int)):
                    cv2.rectangle(det, (x0, y0), (x1, y1), (255, 0, 0), 2)
                    if scores is not None and bi < len(scores):
                        cv2.putText(
                            det, f"{scores[bi]:.2f}", (x0, max(y0 - 4, 10)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 0), 1,
                        )
                self._imwrite("grounding_dino_detections", frame_idx, det)
            if gd_mask is not None:
                self._imwrite("grounding_dino_masks", frame_idx, gd_mask)
            if sam_mask is not None:
                self._imwrite("sam_masks", frame_idx, sam_mask)
            if motion_mask is not None:
                self._imwrite("motion_masks", frame_idx, motion_mask)
            if final_mask is not None:
                self._imwrite("final_masks", frame_idx, final_mask)
            overlay = img_u8.copy()
            overlay[~static] = (
                0.5 * overlay[~static] + np.array([255, 0, 0]) * 0.5
            ).astype(np.uint8)
            self._imwrite("masked_overlay", frame_idx, overlay)
            static_only = img_u8.copy()
            static_only[~static] = 0
            self._imwrite("static_only", frame_idx, static_only)

            if boxes is not None:
                path = os.path.join(
                    self.save_dir, "detection_analysis",
                    f"frame_{frame_idx:06d}.txt",
                )
                prompt = self.prompt_manager.get_dynamic_prompt()
                with open(path, "w") as f:
                    f.write(f"Frame {frame_idx} Detection Analysis\n")
                    f.write(f"Scene Type: {self.prompt_manager.current_scene}\n")
                    f.write(f"Prompt Used: {prompt}\n")
                    f.write(f"Total Detections: {len(boxes)}\n\n")
                    for i, box in enumerate(boxes):
                        score = float(scores[i]) if scores is not None and i < len(scores) else 0.0
                        f.write(f"Detection {i + 1}:\n")
                        f.write(f"  Confidence: {score:.3f}\n")
                        f.write(
                            f"  Box: [{box[0]:.1f}, {box[1]:.1f}, "
                            f"{box[2]:.1f}, {box[3]:.1f}]\n\n"
                        )
        except Exception:
            pass

    def save_keyframe_overlay(self, image, static, kf_idx: int) -> None:
        """Keyframe mask overlay dump (reference
        utils/slam_frontend.py:1538-1577); called by the SLAM system on
        keyframe creation when save_masked_images is on."""
        if not self.save_images:
            return
        try:
            img_u8 = self._to_u8_hwc(image)
            if hasattr(static, "detach"):  # the camera's mask, on the card
                static = static.detach().cpu().numpy()
            static = np.asarray(static, bool)
            overlay = img_u8.copy()
            overlay[~static] = (
                0.5 * overlay[~static] + np.array([0, 255, 0]) * 0.5
            ).astype(np.uint8)
            self._imwrite("keyframes", kf_idx, overlay)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# 0817-era stretch surface (reference utils/slam_frontend_0817.py, SURVEY.md
# §2.5: ground segmentation, shadow repair, colorful class visualization,
# the HF-transformers GroundingDINO fallback)


def segment_ground(img_u8: np.ndarray) -> np.ndarray:
    """Traditional ground segmentation (reference slam_frontend_0817.py:
    1388-1443 `_traditional_ground_segmentation`): in the lower 40% of the
    image, combine low texture (Sobel gradient below the 30th percentile)
    with color consistency around the region mean, clean up morphologically,
    then extend upward along color-similar connected rows. Returns an
    (H, W) bool ground mask."""
    if cv2 is None:
        h, w = img_u8.shape[:2]
        out = np.zeros((h, w), bool)
        out[int(h * 0.6):] = True
        return out
    h, w = img_u8.shape[:2]
    gray = cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY)
    y0 = int(h * 0.6)
    lower = img_u8[y0:].astype(np.float32)
    lower_gray = gray[y0:]

    blur = cv2.GaussianBlur(lower_gray, (15, 15), 0)
    gx = cv2.Sobel(blur, cv2.CV_64F, 1, 0, ksize=3)
    gy = cv2.Sobel(blur, cv2.CV_64F, 0, 1, ksize=3)
    grad = np.sqrt(gx**2 + gy**2)
    # <= + eps: on perfectly flat synthetic ground the 30th percentile is
    # exactly 0 and a strict < would select nothing
    smooth = grad <= np.percentile(grad, 30) + 1e-6

    mean_color = lower.mean(axis=(0, 1))
    cdist = np.linalg.norm(lower - mean_color, axis=2)
    color_ok = cdist < cdist.std() * 1.5

    combined = np.logical_and(smooth, color_ok).astype(np.uint8)
    kernel = np.ones((5, 5), np.uint8)
    combined = cv2.morphologyEx(combined, cv2.MORPH_CLOSE, kernel)
    combined = cv2.morphologyEx(combined, cv2.MORPH_OPEN, kernel)

    ground = np.zeros((h, w), np.uint8)
    ground[y0:] = combined

    # upward extension along color-similar rows (reference :1445-1478)
    if combined.sum() > 0:
        gp = img_u8[ground > 0].astype(np.float32)
        mean_g = gp.mean(axis=0)
        std_g = gp.std(axis=0) + 1e-6
        for y in range(y0 - 1, max(int(h * 0.3), 0), -1):
            row = img_u8[y].astype(np.float32)
            similar = (np.abs(row - mean_g) < 2.0 * std_g).all(axis=-1)
            below = ground[y + 1] > 0
            dilated = cv2.dilate(
                below.reshape(1, -1).astype(np.uint8), np.ones((1, 3), np.uint8)
            ).reshape(-1) > 0
            connected = np.logical_and(similar, dilated)
            if not connected.any():
                break
            ground[y] = connected.astype(np.uint8)
    return ground > 0


def repair_ground_shadows(
    img_u8: np.ndarray, vehicle_mask: np.ndarray, ground_mask: np.ndarray,
    inpaint_radius: int = 5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Inpaint vehicle shadows on the ground (reference slam_frontend_0817.py:
    1485-1514 `repair_ground_shadows`): dilate the vehicle∩ground region,
    clip to ground, TELEA-inpaint. Returns (repaired_rgb_u8, shadow_mask)."""
    shadow = np.logical_and(vehicle_mask, ground_mask)
    if cv2 is None or not shadow.any():
        return img_u8.copy(), shadow
    expanded = cv2.dilate(shadow.astype(np.uint8), np.ones((7, 7), np.uint8)) > 0
    final = np.logical_and(expanded, ground_mask)
    try:
        repaired = cv2.inpaint(
            img_u8, (final * 255).astype(np.uint8), inpaint_radius, cv2.INPAINT_TELEA
        )
    except Exception:
        repaired = img_u8.copy()
        if ground_mask.any():
            fill = img_u8[ground_mask & ~final].mean(axis=0)
            repaired[final] = fill.astype(np.uint8)
    return repaired, final


class ColorfulSegmentationVisualizer:
    """Per-class colored mask overlays (reference slam_frontend_0817.py:
    65-140 `ColorfulSegmentationVisualizer`): warm colors for dynamic
    classes, cool colors for static context, deterministic fallback hues
    for unknown labels."""

    DYNAMIC_COLORS = {
        "person": (255, 0, 0), "pedestrian": (255, 0, 0), "human": (255, 0, 0),
        "car": (255, 165, 0), "vehicle": (255, 165, 0),
        "truck": (255, 255, 0), "bus": (255, 0, 255),
        "bicycle": (255, 0, 128), "bike": (255, 0, 128),
        "motorcycle": (128, 0, 255), "scooter": (255, 128, 0),
        "skateboard": (255, 64, 0), "animal": (255, 96, 32),
        "dog": (255, 96, 32), "cat": (255, 96, 32),
    }
    STATIC_COLORS = {
        "building": (64, 128, 128), "wall": (96, 96, 96), "road": (64, 64, 64),
        "tree": (0, 128, 0), "vegetation": (0, 128, 0),
        "pole": (0, 96, 160), "traffic light": (0, 160, 160),
        "sign": (0, 128, 192), "fence": (80, 112, 96), "bench": (96, 128, 160),
    }

    def color_for(self, label: str, dynamic: bool) -> Tuple[int, int, int]:
        label = label.lower().strip()
        table = self.DYNAMIC_COLORS if dynamic else self.STATIC_COLORS
        for key, c in table.items():
            if key in label:
                return c
        # deterministic fallback hue per label
        hval = abs(hash(label)) % 360
        base = 255 if dynamic else 160
        return (
            int(base * (0.5 + 0.5 * np.cos(np.radians(hval)))),
            int(base * (0.5 + 0.5 * np.cos(np.radians(hval + 120)))),
            int(base * (0.5 + 0.5 * np.cos(np.radians(hval + 240)))),
        )

    def render(
        self,
        img_u8: np.ndarray,
        masks: List[np.ndarray],
        labels: List[str],
        dynamic_flags: List[bool],
        alpha: float = 0.45,
    ) -> np.ndarray:
        """Overlay per-instance masks in class colors; returns RGB uint8."""
        out = img_u8.astype(np.float32).copy()
        for m, lbl, dyn in zip(masks, labels, dynamic_flags):
            color = np.array(self.color_for(lbl, dyn), np.float32)
            mm = m.astype(bool)
            out[mm] = (1 - alpha) * out[mm] + alpha * color
        return out.clip(0, 255).astype(np.uint8)


class HFGroundingDINODetector:
    """GroundingDINO through HuggingFace `transformers`: the reference's
    fallback when the native package or .pth is unavailable
    (slam_frontend_0817.py:12-63, 955-975 `_load_hf_grounding_dino`).

    The model must be cached locally (`HF_HOME`, or `model_id` a path); it
    runs on `device` (the card when None). Construction degrades
    gracefully: a model that does not load, or a missing device, gives a
    detector that finds nothing (`ok` False)."""

    def __init__(self, model_id: str = "IDEA-Research/grounding-dino-tiny",
                 box_threshold: float = 0.35, text_threshold: float = 0.25, device=None):
        self.ok = False
        self.box_threshold = box_threshold
        self.text_threshold = text_threshold
        try:
            # hub lookups probe the network even with local_files_only:
            # offline mode up front
            os.environ.setdefault("HF_HUB_OFFLINE", "1")
            os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
            from transformers import AutoModelForZeroShotObjectDetection, AutoProcessor

            from ..slam.system import resolve_device

            self.device = resolve_device(device)
            self.processor = AutoProcessor.from_pretrained(model_id, local_files_only=True)
            self.model = AutoModelForZeroShotObjectDetection.from_pretrained(
                model_id, local_files_only=True).to(self.device).eval()
            self.ok = True
        except Exception as e:
            Log(f"WARNING: HF GroundingDINO {model_id!r} did not load ({type(e).__name__}: {e})")
            self.processor = self.model = None

    def __call__(self, img_u8: np.ndarray, prompt: str):
        """-> (boxes_xyxy (N, 4), scores (N,)), empty when not loaded."""
        if not self.ok:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
        import torch

        inputs = self.processor(images=img_u8, text=prompt, return_tensors="pt").to(self.device)
        with torch.no_grad():
            outputs = self.model(**inputs)
        res = self.processor.post_process_grounded_object_detection(
            outputs, inputs["input_ids"], threshold=self.box_threshold,
            text_threshold=self.text_threshold, target_sizes=[img_u8.shape[:2]])[0]
        return (res["boxes"].cpu().numpy().astype(np.float32),
                res["scores"].cpu().numpy().astype(np.float32))


class IntervalMasker:
    """Keyframe-cadence adapter over a masker: run the full ladder every
    `interval`-th frame and reuse the latest mask in between.

    The reference runs GroundingDINO+SAM per KEYFRAME, not per frame
    (utils/slam_frontend.py:1425); SLAM's masker hook fires per frame
    (before the keyframe decision), so an interval equal to kf_interval
    restores the reference's detection cost profile while every keyframe
    still carries an at-most-(interval-1)-frames-stale mask.

    `image_provider` (optional, frame_idx -> HWC uint8) lets callers feed
    host-cached frames, skipping the device->host image fetch SLAM would
    otherwise pay per call (`provides_images` advertises this to SLAM).
    """

    def __init__(self, masker, interval: int = 5, image_provider=None):
        self.masker = masker
        self.interval = max(1, int(interval))
        self.image_provider = image_provider
        self.provides_images = image_provider is not None
        self._last: Optional[np.ndarray] = None

    @property
    def save_images(self) -> bool:
        return getattr(self.masker, "save_images", False)

    def _image(self, image, frame_idx: int):
        if self.image_provider is not None:
            return self.image_provider(frame_idx)
        return image

    def get_static_mask(self, image, frame_idx: int = 0) -> np.ndarray:
        if self._last is None or frame_idx % self.interval == 0:
            self._last = self.masker.get_static_mask(
                self._image(image, frame_idx), frame_idx
            )
        return self._last

    def get_static_mask_for_gaussian_init(self, image, frame_idx: int = 0):
        self._last = self.masker.get_static_mask_for_gaussian_init(
            self._image(image, frame_idx), frame_idx
        )
        return self._last

    def save_keyframe_overlay(self, image, static, kf_idx: int) -> None:
        if hasattr(self.masker, "save_keyframe_overlay"):
            self.masker.save_keyframe_overlay(
                self._image(image, kf_idx), static, kf_idx
            )
