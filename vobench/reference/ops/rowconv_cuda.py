"""Same-size 1-D correlation along one axis or both: the plain version of
kernel B4, on any device. Odd taps (radius <= 64), reflect-101 borders
(periodic where the radius reaches past the axis), batched over leading
dims: shifted slices over a reflect-101 copy, zero taps skipped, sums in
tap order."""

from __future__ import annotations

import numpy as np
import torch

from . import conv

MAX_RADIUS = 64


def _taps(taps) -> np.ndarray:
    t = np.asarray(taps, np.float64).reshape(-1)
    if t.size % 2 == 0:
        raise ValueError("row_conv: taps must have odd length")
    if t.size // 2 > MAX_RADIUS:
        raise ValueError(f"row_conv: radius above {MAX_RADIUS}")
    return t


def conv_reference(img: torch.Tensor, taps, along_cols: bool
                   ) -> torch.Tensor:
    """Correlation along the columns (`along_cols`) or the rows."""
    t = _taps(taps)
    r = t.size // 2
    if along_cols:
        return conv.conv2d_valid(conv.reflect_pad(img, r, 0), t.reshape(-1, 1))
    return conv.conv2d_valid(conv.reflect_pad(img, 0, r), t.reshape(1, -1))


def conv_rows_cols_reference(img: torch.Tensor, taps):
    """(along the rows, along the columns)."""
    return conv_reference(img, taps, False), conv_reference(img, taps, True)


def conv_rows(img: torch.Tensor, taps) -> torch.Tensor:
    return conv_reference(img, taps, False)


def conv_cols(img: torch.Tensor, taps) -> torch.Tensor:
    return conv_reference(img, taps, True)


conv_rows_cols = conv_rows_cols_reference
