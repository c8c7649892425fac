"""SE(3) / SO(3) utilities (port of vo_tpu/geometry/se3.py).

Angle-axis (Rodrigues) conversions follow Ceres/OpenCV conventions.
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], -1),
            torch.stack([wz, zero, -wx], -1),
            torch.stack([-wy, wx, zero], -1),
        ],
        -2,
    )


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation matrix (..., 3, 3), Rodrigues."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)[..., None]
    K = hat(w / torch.clamp(theta[..., 0], min=1e-12))
    I = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    R = I + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta < 1e-6, I + hat(w), R)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> angle-axis (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )
    th = theta[..., None]
    scale = torch.where(
        th < 1e-6,
        0.5 + th**2 / 12.0,
        th / torch.clamp(2.0 * torch.sin(th), min=1e-12),
    )
    return v * scale


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4) homogeneous transform."""
    T = R.new_zeros(R.shape[:-2] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_se3(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (4, 4) to (..., 3) points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def project(K: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of camera-frame points (..., 3) -> (..., 2) px."""
    z = pts_cam[..., 2:3]
    uv = pts_cam[..., :2] / torch.where(z.abs() > 1e-12, z,
                                        torch.full_like(z, 1e-12))
    return torch.stack(
        [uv[..., 0] * K[0, 0] + K[0, 2], uv[..., 1] * K[1, 1] + K[1, 2]], -1
    )
