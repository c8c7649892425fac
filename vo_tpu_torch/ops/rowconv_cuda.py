"""Same-size 1-D correlation along one axis: kernel B4 and its plain version.

`conv_rows` and `conv_cols` replace vo_tpu/ops/pallas_conv.py:
conv_rows_pallas and conv_cols_pallas (the Pallas `_row_conv_kernel`):
correlation of (..., H, W) f32 with odd taps (radius <= 64) along the last
axis or along the one before it, reflect-101 borders (periodic where the
radius reaches past the axis), batched over leading dims. On a CUDA tensor
each launches ``csrc/row_conv.cu`` once, the column pass included (vo_tpu
transposes around a row pass); on a CPU tensor each runs `conv_reference`,
shifted slices over a reflect-101 copy as in vo_tpu/ops/conv.py. The kernel
sums in the plain version's order, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import conv

MAX_RADIUS = 64
launches = 0  # kernel launches, for proving that a run went through B4


def _taps(taps) -> np.ndarray:
    t = np.asarray(taps, np.float64).reshape(-1)
    if t.size % 2 == 0:
        raise ValueError("row_conv: taps must have odd length")
    if t.size // 2 > MAX_RADIUS:
        raise ValueError(f"row_conv: radius above {MAX_RADIUS}")
    return t


def conv_reference(img: torch.Tensor, taps, along_cols: bool
                   ) -> torch.Tensor:
    """Plain PyTorch version: shifted slices over a reflect-101 padded copy
    (zero taps skipped, sums in tap order)."""
    t = _taps(taps)
    r = t.size // 2
    if along_cols:
        return conv.conv2d_valid(conv.reflect_pad(img, r, 0), t.reshape(-1, 1))
    return conv.conv2d_valid(conv.reflect_pad(img, 0, r), t.reshape(1, -1))


def _conv(img: torch.Tensor, taps, along_cols: bool) -> torch.Tensor:
    global launches
    t = _taps(taps)
    if img.dim() < 2:
        raise ValueError("row_conv: input must be (..., H, W)")
    if img.device.type == "cpu":
        return conv_reference(img, t, along_cols)
    if img.device.type != "cuda":
        raise RuntimeError(f"row_conv: no kernel for {img.device}")
    if img.dtype != torch.float32:
        raise TypeError(f"row_conv: needs float32, got {img.dtype}")
    H, W = img.shape[-2:]
    x = img.reshape(-1, H, W).contiguous()
    B = x.shape[0]
    if B > 65535:
        raise ValueError("row_conv: more than 65535 planes")
    y = torch.empty_like(x)
    # host taps: the C entry point copies them into the launch's parameters
    ht = np.ascontiguousarray(t, np.float32)
    lib = _lib()
    code = lib.row_conv_f32(x.data_ptr(), y.data_ptr(), B, H, W,
                            ht.ctypes.data, t.size // 2, int(along_cols),
                            _build.stream_ptr(img.device))
    _build.check(lib, code, "row_conv_f32")
    launches += 1
    return y.reshape(img.shape)


def conv_rows(img: torch.Tensor, taps) -> torch.Tensor:
    """Same-size correlation of (..., H, W) along each row (the last axis)."""
    return _conv(img, taps, along_cols=False)


def conv_cols(img: torch.Tensor, taps) -> torch.Tensor:
    """Same-size correlation of (..., H, W) along each column."""
    return _conv(img, taps, along_cols=True)


def _lib():
    lib = _build.load("row_conv")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.row_conv_f32.argtypes = [p, p, i, i, i, p, i, i, p]
        lib.row_conv_f32.restype = ctypes.c_int
        lib._typed = True
    return lib
