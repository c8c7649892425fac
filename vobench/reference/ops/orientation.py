"""Intensity-centroid keypoint orientations (port of
vo_tpu/ops/orientation.py; Orientations.cu:23-62)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .conv import conv2d_valid


def moment_maps(img: torch.Tensor, patch_size: int = 31):
    """Dense (m10, m01): m10(y, x) = sum dx * I(y+dy, x+dx) over the patch,
    as separable ones x ramp correlations over a zero-padded image."""
    r = patch_size // 2
    ones = np.ones(patch_size)
    ramp = np.arange(-r, r + 1).astype(np.float64)
    padded = F.pad(img, (r, r, r, r))
    m10 = conv2d_valid(conv2d_valid(padded, ramp.reshape(1, -1)),
                       ones.reshape(-1, 1))
    m01 = conv2d_valid(conv2d_valid(padded, ones.reshape(1, -1)),
                       ramp.reshape(-1, 1))
    return m10, m01


def orientations_at(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    patch_size: int = 31, rect=None) -> torch.Tensor:
    """Per-keypoint angle (radians); 0 where the patch leaves the image or
    the keypoint's level rectangle `rect` = (x0, y0, x1, y1)."""
    H, W = img.shape[-2:]
    r = patch_size // 2
    m10, m01 = moment_maps(img, patch_size)
    yi = ys.long()
    xi = xs.long()
    ang = torch.atan2(m01[yi, xi], m10[yi, xi])
    x0, y0, x1, y1 = (0, 0, W, H) if rect is None else rect
    inb = (xi >= x0 + r) & (xi < x1 - r) & (yi >= y0 + r) & (yi < y1 - r)
    return torch.where(inb, ang, torch.zeros_like(ang))
