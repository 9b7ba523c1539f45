"""Oracle MASt3R: a ground-truth stand-in for MASt3RInference (port of
``lvdgs_tpu/models/mast3r/oracle.py``), host NumPy.

With no MASt3R checkpoint, the real per-frame prior path (make_fused_priors
-> fast_reciprocal_nns -> PnP-RANSAC -> _compose_seed) runs end to end on
predictions made from the dataset's ground truth:

- descriptors: random-Fourier features of each pixel's world point (GT
  depth unprojected, moved by the GT camera pose). Two views of the same
  surface point get the same descriptor, so reciprocal NN matching finds
  true correspondences; occluded and moving pixels mismatch and fall to
  PnP-RANSAC's outlier handling, as real descriptors would.
- pointmaps and depth: GT depth, optionally scaled (MASt3R's non-metric
  mono scale, which the patch alignment must recover).

Only the two network forwards are stand-ins; matching, PnP, seed
composition, the fused forward's cache and the depth resize run the
production code. The dataset's frames may be device tensors: they reach
this host-side model through `.cpu()`.
"""
from __future__ import annotations

import numpy as np

from .inference import _host


class OracleMASt3R:
    """Interface-compatible with MASt3RInference as the prior factories use
    it (infer_pair / infer_fused returning pred dicts with "desc" and
    "pts3d" at `shape` resolution)."""

    def __init__(self, dataset, intr, desc_dim: int = 24, depth_scale: float = 1.0, seed: int = 0):
        self.dataset = dataset
        self.intr = intr
        self.depth_scale = float(depth_scale)
        rng = np.random.default_rng(seed)
        half = desc_dim // 2
        dirs = rng.normal(size=(half, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        # log-spaced spatial frequencies: coarse components tell far-apart
        # points apart, fine ones localise below a decimetre
        freqs = np.logspace(-0.6, 0.9, half)
        self._F = (dirs * freqs[:, None]).astype(np.float32)  # (half, 3)
        self._fp: dict = {}
        self._scan_upto = 0

    # ------------------------------------------------------------- internals
    def _index_of(self, img) -> int:
        """The dataset frame behind an image (the prior closures pass
        images, not indices), found by a subsampled fingerprint."""
        key = np.ascontiguousarray(_host(img)[..., ::7, ::11]).tobytes()
        while key not in self._fp:
            if self._scan_upto >= len(self.dataset):
                raise KeyError("OracleMASt3R: image not found in dataset")
            i = self._scan_upto
            self._scan_upto += 1
            image = self.dataset[i][0]
            self._fp.setdefault(np.ascontiguousarray(_host(image)[..., ::7, ::11]).tobytes(), i)
        return self._fp[key]

    def _frame_geometry(self, idx: int):
        """(pts_cam (H, W, 3), pts_world (H, W, 3)) from GT depth and pose."""
        _, depth, pose, _ = self.dataset[idx]
        d = _host(depth).astype(np.float32)
        H, W = d.shape
        K = self.intr
        u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
        X = (u - K.cx) * d / K.fx
        Y = (v - K.cy) * d / K.fy
        pts_cam = np.stack([X, Y, d], axis=-1)
        pose = _host(pose)
        R, T = pose[:3, :3], pose[:3, 3]
        pts_world = (pts_cam.reshape(-1, 3) - T) @ R  # R^T (x - T), row form
        return pts_cam, pts_world.reshape(H, W, 3).astype(np.float32)

    def _desc(self, pts_world: np.ndarray) -> np.ndarray:
        ang = pts_world @ self._F.T  # (H, W, half)
        desc = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
        n = np.linalg.norm(desc, axis=-1, keepdims=True)
        return (desc / np.maximum(n, 1e-8)).astype(np.float32)

    def _pred(self, idx: int, scale: float = 1.0):
        pts_cam, pts_world = self._frame_geometry(idx)
        return {"desc": self._desc(pts_world)[None], "pts3d": (pts_cam * scale)[None]}

    # ------------------------------------------------------------- interface
    def infer_pair(self, img1, img2):
        p1 = self._pred(self._index_of(img1), self.depth_scale)
        p2 = self._pred(self._index_of(img2), self.depth_scale)
        return p1, p2, p1["pts3d"].shape[1:3]

    def infer_fused(self, img_kf, img_cur):
        """(pose_pred_kf, pose_pred_cur, depth_pred_cur, shape), as
        MASt3RInference.infer_fused returns them."""
        ik, ic = self._index_of(img_kf), self._index_of(img_cur)
        pose1 = self._pred(ik)
        return pose1, self._pred(ic), self._pred(ic, self.depth_scale), pose1["pts3d"].shape[1:3]
