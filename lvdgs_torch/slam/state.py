"""SLAM state on the device: the keyframe buffer (PyTorch).

Port of ``lvdgs_tpu/slam/state.py``: a fixed-capacity buffer of keyframes so
the windowed mapping (with random historical replay) reads every keyframe
from device memory. Images are stored as uint8. The fill count is a host
integer, as every reader of it is host control flow.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.camera import Camera
from ..core.log import sync


@dataclasses.dataclass
class KeyframeBuffer:
    frame_idx: torch.Tensor  # (M,) int32, -1 = empty
    images_u8: torch.Tensor  # (M, 3, H, W) uint8
    R: torch.Tensor  # (M, 3, 3)
    T: torch.Tensor  # (M, 3)
    exposure_ab: torch.Tensor  # (M, 2)
    mono_depth: torch.Tensor  # (M, H, W) float32
    grad_mask: torch.Tensor  # (M, H, W) bool
    static_mask: torch.Tensor  # (M, H, W) bool
    has_static: torch.Tensor  # (M,) bool
    count: int

    @property
    def capacity(self) -> int:
        return self.frame_idx.shape[0]

    def replace(self, **kw) -> "KeyframeBuffer":
        return dataclasses.replace(self, **kw)


def create_keyframe_buffer(capacity: int, height: int, width: int, device) -> KeyframeBuffer:
    M, H, W = capacity, height, width
    f32 = dict(dtype=torch.float32, device=device)
    return KeyframeBuffer(
        frame_idx=torch.full((M,), -1, dtype=torch.int32, device=device),
        images_u8=torch.zeros((M, 3, H, W), dtype=torch.uint8, device=device),
        R=torch.eye(3, **f32).repeat(M, 1, 1),
        T=torch.zeros((M, 3), **f32),
        exposure_ab=torch.zeros((M, 2), **f32),
        mono_depth=torch.zeros((M, H, W), **f32),
        grad_mask=torch.zeros((M, H, W), dtype=torch.bool, device=device),
        static_mask=torch.ones((M, H, W), dtype=torch.bool, device=device),
        has_static=torch.zeros((M,), dtype=torch.bool, device=device),
        count=0,
    )


@torch.no_grad()
def add_keyframe(buf: KeyframeBuffer, cam: Camera) -> int:
    """Append a camera in place; returns its slot. Overwrites the last slot
    when full."""
    slot = min(buf.count, buf.capacity - 1)
    # fill_ takes the host scalar as a kernel argument: no copy, no wait
    buf.frame_idx[slot].fill_(cam.uid)
    buf.images_u8[slot] = torch.clamp(cam.image * 255.0 + 0.5, 0, 255).to(torch.uint8)
    buf.R[slot] = cam.R
    buf.T[slot] = cam.T
    buf.exposure_ab[slot, 0] = cam.exposure_a
    buf.exposure_ab[slot, 1] = cam.exposure_b
    buf.mono_depth[slot] = cam.mono_depth
    buf.grad_mask[slot] = cam.grad_mask
    buf.static_mask[slot] = cam.static_mask
    buf.has_static[slot].fill_(cam.has_static_mask)
    buf.count = min(buf.count + 1, buf.capacity)
    return slot


def camera_from_slot(buf: KeyframeBuffer, slot: int) -> Camera:
    """A Camera view of one buffer slot."""
    s = min(max(int(slot), 0), buf.capacity - 1)
    with sync():
        uid, has_static = int(buf.frame_idx[s]), bool(buf.has_static[s])
    return Camera(
        uid=uid,
        image=buf.images_u8[s].to(torch.float32) / 255.0,
        R=buf.R[s],
        T=buf.T[s],
        R_gt=buf.R[s],
        T_gt=buf.T[s],
        exposure_a=buf.exposure_ab[s, 0],
        exposure_b=buf.exposure_ab[s, 1],
        depth=torch.zeros_like(buf.mono_depth[s]),
        mono_depth=buf.mono_depth[s],
        grad_mask=buf.grad_mask[s],
        static_mask=buf.static_mask[s],
        has_static_mask=has_static,
    )
