"""Same-size 1-D correlation along one axis or both: kernel B4 and its plain
version.

`conv_rows` and `conv_cols` replace vo_tpu/ops/pallas_conv.py:
conv_rows_pallas and conv_cols_pallas (the Pallas `_row_conv_kernel`):
correlation of (..., H, W) f32 with odd taps (radius <= 64) along the last
axis or along the one before it, reflect-101 borders (periodic where the
radius reaches past the axis), batched over leading dims.
`conv_rows_cols` computes both from one read of the input (radius <= 4;
SIFT's gradient maps). On a CUDA tensor each launches ``csrc/row_conv.cu``
once, the column pass included (vo_tpu transposes around a row pass), and
nothing for an empty input; on a CPU tensor each runs its plain version,
shifted slices over a reflect-101 copy as in vo_tpu/ops/conv.py. The
kernel sums in the plain version's order, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import conv

MAX_RADIUS = 64
MAX_PAIR_RADIUS = 4  # conv_rows_cols: the register kernel's widest radius
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


def conv_rows_cols_reference(img: torch.Tensor, taps):
    """Plain PyTorch version of `conv_rows_cols`: the two plain passes."""
    return conv_reference(img, taps, False), conv_reference(img, taps, True)


def _prepare(what: str, img: torch.Tensor, taps):
    """The checked taps and, for a CUDA tensor, the (B, H, W) input that the
    kernel reads (contiguous and 16-byte aligned: it loads float4s); None
    for a CPU tensor."""
    t = _taps(taps)
    if img.dim() < 2:
        raise ValueError(f"{what}: input must be (..., H, W)")
    if img.device.type == "cpu":
        return t, None
    if img.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for {img.device}")
    if img.dtype != torch.float32:
        raise TypeError(f"{what}: needs float32, got {img.dtype}")
    H, W = img.shape[-2:]
    x = img.reshape(-1, H, W).contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    if x.shape[0] > 65535:
        raise ValueError(f"{what}: more than 65535 planes")
    return t, x


def _conv(img: torch.Tensor, taps, along_cols: bool) -> torch.Tensor:
    global launches
    t, x = _prepare("row_conv", img, taps)
    if x is None:
        return conv_reference(img, t, along_cols)
    B, H, W = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y.reshape(img.shape)
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


def conv_rows_cols(img: torch.Tensor, taps):
    """(conv_rows(img, taps), conv_cols(img, taps)) from one read of img, in
    one launch; radius <= MAX_PAIR_RADIUS."""
    global launches
    t, x = _prepare("conv_rows_cols", img, taps)
    if t.size // 2 > MAX_PAIR_RADIUS:
        raise ValueError(f"conv_rows_cols: radius above {MAX_PAIR_RADIUS}")
    if x is None:
        return conv_rows_cols_reference(img, t)
    B, H, W = x.shape
    yr, yc = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        ht = np.ascontiguousarray(t, np.float32)
        lib = _lib()
        code = lib.row_conv_pair_f32(x.data_ptr(), yr.data_ptr(),
                                     yc.data_ptr(), B, H, W, ht.ctypes.data,
                                     t.size // 2,
                                     _build.stream_ptr(img.device))
        _build.check(lib, code, "row_conv_pair_f32")
        launches += 1
    return yr.reshape(img.shape), yc.reshape(img.shape)


def _lib():
    lib = _build.load("row_conv")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.row_conv_f32.argtypes = [p, p, i, i, i, p, i, i, p]
        lib.row_conv_f32.restype = ctypes.c_int
        lib.row_conv_pair_f32.argtypes = [p, p, p, i, i, i, p, i, p]
        lib.row_conv_pair_f32.restype = ctypes.c_int
        lib._typed = True
    return lib
