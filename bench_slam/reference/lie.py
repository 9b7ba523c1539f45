"""SE(3) exponential and the left-multiplicative pose update of the
benchmark's plain reference: a frozen copy of the port's float32 plain
version (world-to-camera [R | t], tau = (rho, theta), T <- exp(tau) @ T)."""
from __future__ import annotations

import torch

import torch

_EPS = 1e-5


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector."""
    x, y, z = v[0], v[1], v[2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y]),
            torch.stack([z, zero, -x]),
            torch.stack([-y, x, zero]),
        ]
    )


def _angle_terms(theta: torch.Tensor):
    W = hat(theta)
    W2 = W @ W
    sq = (theta * theta).sum()
    small = sq < _EPS * _EPS
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    a = torch.sqrt(sq_safe)
    return W, W2, sq, small, sq_safe, a


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with a 2nd-order Taylor branch near zero."""
    W, W2, sq, small, sq_safe, a = _angle_terms(theta)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    sin_term = torch.where(small, 1.0 - sq / 6.0, torch.sin(a) / a)
    cos_term = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(a)) / sq_safe)
    return eye + sin_term * W + cos_term * W2


def so3_left_jacobian(theta: torch.Tensor) -> torch.Tensor:
    """V(theta) such that t = V @ rho."""
    W, W2, sq, small, sq_safe, a = _angle_terms(theta)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    c1 = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(a)) / sq_safe)
    c2 = torch.where(small, 1.0 / 6.0 - sq / 120.0, (a - torch.sin(a)) / (sq_safe * a))
    return eye + c1 * W + c2 * W2


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential of tau = (rho[3], theta[3]) -> 4x4 matrix."""
    rho, theta = tau[:3], tau[3:]
    R = so3_exp(theta)
    t = so3_left_jacobian(theta) @ rho
    return rt_to_mat(R, t)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of a rotation matrix -> axis-angle 3-vector."""
    cos_angle = torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    angle = torch.arccos(cos_angle)
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    small = angle < _EPS
    a = torch.where(small, torch.ones_like(angle), angle)
    scale = torch.where(small, torch.full_like(a, 0.5), a / (2.0 * torch.sin(a)))
    return scale * w


def apply_delta(R: torch.Tensor, t: torch.Tensor, tau: torch.Tensor):
    """Left-multiplicative pose update: [R'|t'] = exp(tau) @ [R|t]. The
    renderer consumes (R', t') with tau a learned zero, so autograd through
    the renderer gives d(loss)/d(tau)."""
    dT = se3_exp(tau)
    return dT[:3, :3] @ R, dT[:3, :3] @ t + dT[:3, 3]


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous matrix from rotation and translation."""
    # the bottom row from eye on the device: a tensor built from a Python
    # list would be a host-to-device copy, which waits for the stream
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    return torch.cat([torch.cat([R, t[:, None]], 1), bottom], 0)
