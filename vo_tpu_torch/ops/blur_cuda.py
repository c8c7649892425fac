"""Same-size separable blur: kernel B2 and its plain version.

`separable_blur` replaces vo_tpu/ops/pallas_blur.py:pallas_separable_blur
(the Pallas `_blur_kernel`): correlation with odd row taps kx and column
taps ky (radius <= 64), reflect-101 borders (periodic where a radius reaches
past the axis, as jnp.pad(mode="reflect") gives on SIFT's smallest octaves),
f32 accumulation, batched over leading dims. On a CUDA tensor it launches ``csrc/separable_blur.cu`` once
for the whole batch; on a CPU tensor it runs `separable_blur_reference`,
the shift-add path of vo_tpu/ops/conv.py.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import conv

MAX_RADIUS = 64
launches = 0  # kernel launches, for proving that a run went through B2


def separable_blur_reference(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Plain PyTorch version: a row pass then a column pass of shifted
    slices over reflect-101 padded copies."""
    ky = np.asarray(ky, np.float64).reshape(-1)
    kx = np.asarray(kx, np.float64).reshape(-1)
    out = conv.conv2d_valid(conv.reflect_pad(img, 0, kx.size // 2),
                            kx.reshape(1, -1))
    return conv.conv2d_valid(conv.reflect_pad(out, ky.size // 2, 0),
                             ky.reshape(-1, 1))


def separable_blur(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Blur (..., H, W) f32 with odd 1-D taps ky (columns) and kx (rows)."""
    global launches
    ky = np.asarray(ky, np.float64).reshape(-1)
    kx = np.asarray(kx, np.float64).reshape(-1)
    if ky.size % 2 == 0 or kx.size % 2 == 0:
        raise ValueError("separable_blur: taps must have odd length")
    ry, rx = ky.size // 2, kx.size // 2
    if max(ry, rx) > MAX_RADIUS:
        raise ValueError(f"separable_blur: radius above {MAX_RADIUS}")
    if img.dim() < 2:
        raise ValueError("separable_blur: input must be (..., H, W)")
    H, W = img.shape[-2:]
    if img.device.type == "cpu":
        return separable_blur_reference(img, ky, kx)
    if img.device.type != "cuda":
        raise RuntimeError(f"separable_blur: no kernel for {img.device}")
    if img.dtype != torch.float32:
        raise TypeError(f"separable_blur: needs float32, got {img.dtype}")
    x = img.reshape(-1, H, W).contiguous()
    B = x.shape[0]
    if B > 65535:
        raise ValueError("separable_blur: more than 65535 planes")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y.reshape(img.shape)
    # host taps: the C entry point copies them into the launch's parameters
    hky = np.ascontiguousarray(ky, np.float32)
    hkx = np.ascontiguousarray(kx, np.float32)
    lib = _lib()
    code = lib.separable_blur_f32(
        x.data_ptr(), y.data_ptr(), B, H, W, hky.ctypes.data, ry,
        hkx.ctypes.data, rx, _build.stream_ptr(img.device),
    )
    _build.check(lib, code, "separable_blur_f32")
    launches += 1
    return y.reshape(img.shape)


def _lib():
    lib = _build.load("separable_blur")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.separable_blur_f32.argtypes = [p, p, i, i, i, p, i, p, i, p]
        lib.separable_blur_f32.restype = ctypes.c_int
        lib._typed = True
    return lib
