"""Camera state and projection conventions (PyTorch).

Port of ``lvdgs_tpu/core/camera.py``. Poses are world-to-camera,
x_cam = R @ x_world + T; pixels are u = fx*x/z + cx, v = fy*y/z + cy.
Per-frame learnable state is an affine exposure (a, b) with
image_ab = exp(a) * image + b. ``Camera`` is a plain dataclass of tensors;
``Intrinsics`` is hashable and static.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """Static pinhole intrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def fovx(self) -> float:
        return focal2fov(self.fx, self.width)

    @property
    def fovy(self) -> float:
        return focal2fov(self.fy, self.height)

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    def scaled(self, width: int, height: int) -> "Intrinsics":
        """Intrinsics for a resized image."""
        sw = width / self.width
        sh = height / self.height
        return Intrinsics(
            fx=self.fx * sw, fy=self.fy * sh, cx=self.cx * sw, cy=self.cy * sh,
            width=width, height=height, znear=self.znear, zfar=self.zfar,
        )


def projection_matrix(intr: Intrinsics) -> np.ndarray:
    """OpenGL-style perspective matrix with principal-point offset (kept for
    API parity; the rasterizer projects with fx/fy/cx/cy directly)."""
    n, f = intr.znear, intr.zfar
    left = -(intr.cx) * n / intr.fx
    right = (intr.width - intr.cx) * n / intr.fx
    top = -(intr.cy) * n / intr.fy
    bottom = (intr.height - intr.cy) * n / intr.fy

    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * n / (right - left)
    P[1, 1] = 2.0 * n / (bottom - top)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (bottom + top) / (bottom - top)
    P[3, 2] = 1.0
    P[2, 2] = f / (f - n)
    P[2, 3] = -(f * n) / (f - n)
    return P


@dataclasses.dataclass
class Camera:
    """Per-frame camera state. All tensors live on one device."""

    uid: int
    image: torch.Tensor  # (3, H, W) float32 in [0, 1]
    R: torch.Tensor  # (3, 3) w2c rotation
    T: torch.Tensor  # (3,) w2c translation
    R_gt: torch.Tensor  # (3, 3)
    T_gt: torch.Tensor  # (3,)
    exposure_a: torch.Tensor  # () learnable
    exposure_b: torch.Tensor  # () learnable
    depth: torch.Tensor  # (H, W) sensor depth (zeros if none)
    mono_depth: torch.Tensor  # (H, W) monocular depth
    grad_mask: torch.Tensor  # (H, W) bool edge mask
    static_mask: torch.Tensor  # (H, W) bool, True = static scene
    has_static_mask: bool = False

    @classmethod
    def create(
        cls,
        uid: int,
        image: torch.Tensor,
        intr: Intrinsics,
        gt_R: Optional[torch.Tensor] = None,
        gt_T: Optional[torch.Tensor] = None,
        depth: Optional[torch.Tensor] = None,
        mono_depth: Optional[torch.Tensor] = None,
    ) -> "Camera":
        H, W = intr.height, intr.width
        dev = image.device
        f32 = dict(dtype=torch.float32, device=dev)
        eye = torch.eye(3, **f32)
        zeros3 = torch.zeros(3, **f32)
        return cls(
            uid=int(uid),
            image=image.to(torch.float32),
            R=eye,
            T=zeros3,
            R_gt=eye if gt_R is None else gt_R.to(**f32),
            T_gt=zeros3 if gt_T is None else gt_T.to(**f32),
            exposure_a=torch.zeros((), **f32),
            exposure_b=torch.zeros((), **f32),
            depth=torch.zeros((H, W), **f32) if depth is None else depth.to(**f32),
            mono_depth=torch.zeros((H, W), **f32)
            if mono_depth is None else mono_depth.to(**f32),
            grad_mask=torch.ones((H, W), dtype=torch.bool, device=dev),
            static_mask=torch.ones((H, W), dtype=torch.bool, device=dev),
        )

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def update_RT(self, R: torch.Tensor, T: torch.Tensor) -> "Camera":
        return self.replace(R=R, T=T)

    @property
    def w2c(self) -> torch.Tensor:
        out = torch.eye(4, dtype=self.R.dtype, device=self.R.device)
        out[:3, :3] = self.R
        out[:3, 3] = self.T
        return out

    @property
    def camera_center(self) -> torch.Tensor:
        return -(self.R.T @ self.T)

    def exposure_apply(self, image: torch.Tensor) -> torch.Tensor:
        """Affine exposure compensation exp(a) * I + b."""
        return torch.exp(self.exposure_a) * image + self.exposure_b
