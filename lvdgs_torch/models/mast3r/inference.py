"""MASt3R inference glue: preprocessing, the checkpoint load, the pose,
depth and scale priors (PyTorch port of
``lvdgs_tpu/models/mast3r/inference.py``).

- preprocess_image: resize the long edge to 512, crop centred to
  16-pixel-aligned sides, normalise to [-1, 1] (through uint8 and cv2, as
  the reference does).
- get_pose: descriptor matching between the last keyframe and the current
  frame, the map's median depth rendered from the keyframe at the network's
  resolution and unprojected at the matched pixels, PnP-RANSAC (SQPnP, 100
  iterations, 5 px) -> the relative world-to-camera pose; identity where it
  fails.
- get_depth: the pointmap's z, resized (nearest) to the frame.
- find_scale: the cross-keyframe matched-depth ratio, the scale remedy of
  process_depth.

The factories return the callables that SLAM(pose_prior=..,
depth_prior=.., scale_remedy=..) takes. The network runs on its module's
device; matching runs on the device of the descriptors it is given (the
map's, for host descriptors in the pose prior); PnP and the resizes run on
the host through OpenCV, which these functions require: where the
reference returns an identity pose without cv2, they raise.
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np
import torch

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

from ...core.camera import Intrinsics
from ...ops.rasterizer import rasterize_median_depth
from .model import MASt3R, MASt3RConfig, mast3r_forward, mast3r_forward_fused
from .matching import fast_reciprocal_nns

# keys of the official checkpoint's state_dict that its converter does not
# read and that no parameter of MASt3R holds: the DPT scratch's
# `layer_rn` list aliases layer1_rn..layer4_rn (the same tensors)
IGNORED_KEYS = frozenset(
    f"downstream_head{h}.dpt.scratch.layer_rn.{i}.weight" for h in (1, 2) for i in range(4)
)


def _cv2():
    if cv2 is None:
        raise RuntimeError("the MASt3R priors need OpenCV (cv2) for resizing and PnP")
    return cv2


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a host array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def preprocessed_shape(H: int, W: int, size: int = 512) -> Tuple[int, int]:
    """(H', W') that preprocess_image gives an H x W image."""
    scale = size / max(H, W)
    newW, newH = int(round(W * scale)), int(round(H * scale))
    return (2 * (newH // 2)) // 16 * 16, (2 * (newW // 2)) // 16 * 16


def preprocess_image(img, size: int = 512) -> Tuple[np.ndarray, Tuple[int, int]]:
    """(3, H, W) float in [0, 1] -> (3, H', W') in [-1, 1] with the long
    edge `size` and both sides cropped to multiples of 16, and (H', W')."""
    img = _host(img)
    _, H, W = img.shape
    scale = size / max(H, W)
    newW, newH = int(round(W * scale)), int(round(H * scale))
    # the reference round-trips through uint8, which also clamps the
    # resampling's overshoot
    hwc = (np.clip(np.transpose(img, (1, 2, 0)), 0, 1) * 255).astype(np.uint8)
    cv = _cv2()
    interp = cv.INTER_LANCZOS4 if scale < 1 else cv.INTER_CUBIC
    hwc = cv.resize(hwc, (newW, newH), interpolation=interp).astype(np.float32) / 255.0
    cx, cy = newW // 2, newH // 2
    halfw, halfh = (2 * cx) // 16 * 8, (2 * cy) // 16 * 8
    crop = hwc[cy - halfh:cy + halfh, cx - halfw:cx + halfw]
    out = (np.transpose(crop, (2, 0, 1)).astype(np.float32) - 0.5) / 0.5
    return out, crop.shape[:2]


def load_checkpoint(path: str, cfg: Optional[MASt3RConfig] = None, device=None) -> MASt3R:
    """The official checkpoint (or a file of the same layout: a state_dict,
    or a dict holding it under "model") as a MASt3R on `device` (CUDA by
    default). It is read with weights_only=True, allowing the one class
    the official file pickles besides tensors, argparse.Namespace (its
    "args"). The IGNORED_KEYS are dropped; every other key must name a
    parameter, and every parameter must be given."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    sd = {k: v for k, v in sd.items() if k not in IGNORED_KEYS}
    with torch.device("meta"):
        model = MASt3R(cfg or MASt3RConfig())
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(torch.device("cuda" if device is None else device)).eval()


class MASt3RInference:
    """The network on its device, fed host images."""

    def __init__(self, model: MASt3R, size: int = 512):
        self.model = model
        self.cfg = model.cfg
        self.size = size

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[MASt3RConfig] = None, device=None):
        return cls(load_checkpoint(path, cfg, device))

    def fits(self, img) -> bool:
        """Whether `img` (3, H, W) keeps at least one patch each way once
        preprocessed (at size 512, a crop of 32:1 or thinner does not)."""
        return min(preprocessed_shape(img.shape[-2], img.shape[-1], self.size)) >= self.cfg.patch_size

    def _batch(self, img):
        p, shape = preprocess_image(img, self.size)
        return torch.as_tensor(p, device=self.device)[None], shape

    def infer_pair(self, img1, img2):
        """imgs (3, H, W) in [0, 1]. Returns (pred1, pred2, (H', W'))."""
        x1, shape = self._batch(img1)
        x2, _ = self._batch(img2)
        pred1, pred2 = mast3r_forward(self.model, x1, x2)
        return pred1, pred2, shape

    def infer_fused(self, img_kf, img_cur):
        """One fused forward for a tracked frame's pose and depth priors.
        Returns (pose_pred1, pose_pred2, depth_pred1, (H', W'))."""
        x1, shape = self._batch(img_kf)
        x2, _ = self._batch(img_cur)
        pose1, pose2, depth1 = mast3r_forward_fused(self.model, x1, x2)
        return pose1, pose2, depth1, shape


def depth_to_3d(depth_map: np.ndarray, K: np.ndarray, dist_coeffs: np.ndarray):
    """Distortion-aware unprojection of a depth map to camera points."""
    if depth_map.ndim == 3:
        depth_map = depth_map[0]
    h, w = depth_map.shape
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    if np.any(dist_coeffs):
        pix = np.stack((u, v), axis=-1).reshape(-1, 2).astype(np.float32)
        und = _cv2().undistortPoints(pix, K, dist_coeffs, P=K).reshape(h, w, 2)
        u, v = und[..., 0], und[..., 1]
    Z = depth_map
    X = (u - K[0, 2]) * Z / K[0, 0]
    Y = (v - K[1, 2]) * Z / K[1, 1]
    return np.stack((X, Y, Z), axis=-1)


def get_pose(model, img1, img2, intr: Intrinsics, dist_coeffs, gmap, last_kf_R, last_kf_T, rcfg):
    """The relative world-to-camera pose of img2 with respect to img1's
    keyframe, by matching and PnP. Returns (pose (4, 4), render_depth)."""
    pred1, pred2, shape = model.infer_pair(img1, img2)
    return _pose_from_preds(pred1, pred2, shape, intr, dist_coeffs, gmap, last_kf_R, last_kf_T, rcfg)


def _pose_from_preds(pred1, pred2, shape, intr, dist_coeffs, gmap, last_kf_R, last_kf_T, rcfg):
    """Matching, the rendered median depth unprojected at the matches, and
    PnP-RANSAC on one pair's predictions."""
    H1, W1 = shape
    m1, m2 = fast_reciprocal_nns(pred1["desc"][0], pred2["desc"][0], device=gmap.device)
    sub_intr = intr.scaled(W1, H1)
    # the transmittance-median (front-surface) depth: the alpha-mean depth's
    # shallow bias would scale every PnP translation
    f32 = dict(dtype=torch.float32, device=gmap.device)
    md, _mo = rasterize_median_depth(gmap.params(), gmap.active, torch.as_tensor(last_kf_R, **f32),
                                     torch.as_tensor(last_kf_T, **f32), sub_intr, rcfg)
    render_depth = md[0].cpu().numpy()
    K_new = sub_intr.K.astype(np.float64)
    pts3d = depth_to_3d(render_depth, K_new, dist_coeffs)

    identity = np.eye(4)
    if len(m1) < 6:
        return identity, render_depth
    obj = pts3d[m1[:, 1], m1[:, 0]].astype(np.float32)
    imgp = m2.astype(np.float32)
    valid = obj[:, 2] > 0
    if valid.sum() < 6:
        return identity, render_depth
    cv = _cv2()
    try:
        success, rvec, tvec, _ = cv.solvePnPRansac(
            obj[valid], imgp[valid], K_new, dist_coeffs,
            iterationsCount=100, reprojectionError=5, flags=cv.SOLVEPNP_SQPNP,
        )
    except cv.error:
        return identity, render_depth
    if not success:
        return identity, render_depth
    Rm, _ = cv.Rodrigues(rvec)
    pose = np.eye(4)
    pose[:3, :3] = Rm
    pose[:3, 3] = tvec[:, 0]
    return pose, render_depth


def _resize_nearest(z, out_hw) -> np.ndarray:
    H, W = out_hw
    cv = _cv2()
    return cv.resize(_host(z), (W, H), interpolation=cv.INTER_NEAREST)


def get_depth(model, img, out_hw: Tuple[int, int]) -> np.ndarray:
    """Mono depth: the pointmap's z of the (img, img) pair."""
    pred1, _pred2, _ = model.infer_pair(img, img)
    return _resize_nearest(pred1["pts3d"][0, ..., 2], out_hw)


def find_scale(model, img1, img2, depth1, depth2) -> float:
    """The matched-depth ratio mean(depth1) / mean(depth2) over the pair's
    reciprocal matches, each depth resized (bilinear) to the network's
    resolution. Host descriptors are matched on the device of the depths
    (the SLAM's)."""
    pred1, pred2, (H1, W1) = model.infer_pair(img1, img2)
    device = depth1.device if isinstance(depth1, torch.Tensor) else None
    m1, m2 = fast_reciprocal_nns(pred1["desc"][0], pred2["desc"][0], device=device)
    cv = _cv2()
    d1 = cv.resize(_host(depth1), (W1, H1), interpolation=cv.INTER_LINEAR)
    d2 = cv.resize(_host(depth2), (W1, H1), interpolation=cv.INTER_LINEAR)
    dv_cur = d2[m2[:, 1], m2[:, 0]]
    dv_prev = d1[m1[:, 1], m1[:, 0]]
    ok = (dv_cur > 0) & np.isfinite(dv_cur) & (dv_prev > 0) & np.isfinite(dv_prev)
    if ok.sum() == 0:
        return 1.0
    return float(dv_prev[ok].mean() / dv_cur[ok].mean())


# ---------------------------------------------------------------------------
# SLAM plug-ins


def make_scale_remedy(model):
    """scale_remedy(cam, last_kf_cam) for SLAM: the cross-keyframe matched
    depth ratio, asked when patch alignment finds too few accurate
    pixels."""

    def scale_remedy(cam, last_kf_cam) -> float:
        return find_scale(model, last_kf_cam.image, cam.image, last_kf_cam.mono_depth, cam.mono_depth)

    return scale_remedy


def make_depth_prior(model, intr: Intrinsics):
    def depth_prior(image) -> np.ndarray:
        return get_depth(model, image, (intr.height, intr.width))

    return depth_prior


def make_fused_priors(model, intr: Intrinsics, dist_coeffs=None):
    """(depth_prior, pose_prior) sharing one fused forward per frame.

    The SLAM loop asks depth_prior first (building the camera) and
    pose_prior second (the seed), within the same frame. depth_prior, given
    the last keyframe's camera (it is marked `wants_kf`), runs the fused
    forward and caches the pose pair's predictions; pose_prior takes the
    cache, or runs get_pose afresh where the cache is not of its
    keyframe."""
    dist = np.zeros(5) if dist_coeffs is None else np.asarray(dist_coeffs)
    cache: dict = {}

    def depth_prior(image, last_kf_cam=None) -> np.ndarray:
        if last_kf_cam is None:
            cache.clear()
            return get_depth(model, image, (intr.height, intr.width))
        pose1, pose2, depth1, shape = model.infer_fused(last_kf_cam.image, image)
        cache["kf_uid"] = int(last_kf_cam.uid)
        cache["preds"] = (pose1, pose2, shape)
        return _resize_nearest(depth1["pts3d"][0, ..., 2], (intr.height, intr.width))

    depth_prior.wants_kf = True

    def pose_prior(cam, last_kf_cam, slam):
        if last_kf_cam is None:
            return None
        R, T = _host(last_kf_cam.R), _host(last_kf_cam.T)
        if cache.get("kf_uid") == int(last_kf_cam.uid):
            pred1, pred2, shape = cache.pop("preds")
            cache.clear()
            rel, _ = _pose_from_preds(pred1, pred2, shape, intr, dist, slam.gmap, R, T, slam.rcfg)
        else:
            rel, _ = get_pose(model, last_kf_cam.image, cam.image, intr, dist, slam.gmap, R, T, slam.rcfg)
        return _compose_seed(rel, cam, last_kf_cam, slam)

    return depth_prior, pose_prior


def _compose_seed(rel, cam, last_kf_cam, slam):
    """A PnP relative pose composed onto the estimated keyframe pose; the
    previous frame's pose where PnP failed (identity)."""
    pose_last = np.eye(4)
    pose_last[:3, :3] = _host(last_kf_cam.R)
    pose_last[:3, 3] = _host(last_kf_cam.T)
    if np.allclose(rel, np.eye(4), atol=1e-6):
        prev = slam.frames.get(int(cam.uid) - 1)
        if prev is not None:
            return prev["R"], prev["T"]
    seed = rel @ pose_last
    return seed[:3, :3], seed[:3, 3]


def make_pose_prior(model, intr: Intrinsics, dist_coeffs=None):
    dist = np.zeros(5) if dist_coeffs is None else np.asarray(dist_coeffs)

    def pose_prior(cam, last_kf_cam, slam):
        if last_kf_cam is None:
            return None
        rel, _ = get_pose(model, last_kf_cam.image, cam.image, intr, dist, slam.gmap,
                          _host(last_kf_cam.R), _host(last_kf_cam.T), slam.rcfg)
        return _compose_seed(rel, cam, last_kf_cam, slam)

    return pose_prior
