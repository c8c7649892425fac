"""Same-size separable blur: the plain version of kernel B2, on any device.

Correlation with odd row taps kx and column taps ky, reflect-101 borders
(periodic where a radius reaches past the axis), f32 accumulation, batched
over leading dims: a row pass then a column pass of shifted slices.
"""

from __future__ import annotations

import numpy as np
import torch

from . import conv


def separable_blur_reference(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """A row pass then a column pass of shifted slices over reflect-101
    padded copies."""
    ky = np.asarray(ky, np.float64).reshape(-1)
    kx = np.asarray(kx, np.float64).reshape(-1)
    out = conv.conv2d_valid(conv.reflect_pad(img, 0, kx.size // 2),
                            kx.reshape(1, -1))
    return conv.conv2d_valid(conv.reflect_pad(out, ky.size // 2, 0),
                             ky.reshape(-1, 1))


def separable_blur(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Blur (..., H, W) f32 with odd 1-D taps ky (columns) and kx (rows)."""
    return separable_blur_reference(img, ky, kx)
