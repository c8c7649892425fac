"""Image pyramids (port of vo_tpu/ops/pyramid.py).

ORB's scale pyramid resamples every level from level 0 with cv2
INTER_LINEAR's half-pixel bilinear convention; LK's halving pyramid is a
5-tap binomial blur (reflect-101) fused with 2x decimation. Both are
banded matrix products, left to torch.matmul (fp32, TF32 off).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def pyramid_shapes(
    shape: tuple[int, int], n_levels: int = 8, scale_factor: float = 1.2
) -> list[tuple[int, int]]:
    """Static per-level (H, W): level l is round(dim / scale_factor**l)."""
    H, W = shape
    return [
        (max(8, round(H / scale_factor**l)), max(8, round(W / scale_factor**l)))
        for l in range(n_levels)
    ]


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Dense (n_out, n_in) half-pixel bilinear sampling matrix (cv2
    INTER_LINEAR, no anti-aliasing): src = (dst + 0.5) * s - 0.5, clamped."""
    s = n_in / n_out
    src = (np.arange(n_out) + 0.5) * s - 0.5
    src = np.clip(src, 0.0, n_in - 1.0)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = src - i0
    M = np.zeros((n_out, n_in), dtype=np.float32)
    M[np.arange(n_out), i0] += 1.0 - w1
    M[np.arange(n_out), i1] += w1
    return M


@functools.lru_cache(maxsize=None)
def _down2_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Dense (n_out, n_in) band fusing a 5-tap binomial blur (reflect-101
    borders) with 2x decimation: out[i] = sum_k taps[k] x[reflect(2i+k-2)]."""
    taps = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
    M = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        for k in range(5):
            j = 2 * i + k - 2
            if j < 0:
                j = -j
            elif j > n_in - 1:
                j = 2 * (n_in - 1) - j
            M[i, j] += taps[k]
    return M


@functools.lru_cache(maxsize=None)
def _on_device(build, n_out: int, n_in: int, device: torch.device):
    """A band matrix on `device`, copied there once per shape."""
    return torch.from_numpy(build(n_out, n_in)).to(device)


def resize_bilinear(img: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W) f32 as two banded products."""
    H_out, W_out = shape
    H_in, W_in = img.shape[-2:]
    My = _on_device(_interp_matrix, H_out, H_in, img.device)
    Mx = _on_device(_interp_matrix, W_out, W_in, img.device)
    return torch.matmul(torch.matmul(My, img), Mx.T)


def build_pyramid(
    img: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2
) -> list[torch.Tensor]:
    """n_levels images, level 0 = input; every level is resampled from
    level 0 (as cv::resize(pyramid[0], ...), orb.cpp:116-119)."""
    shapes = pyramid_shapes(tuple(img.shape[-2:]), n_levels, scale_factor)
    return [img] + [resize_bilinear(img, s) for s in shapes[1:]]


def _binomial_down2(img: torch.Tensor) -> torch.Tensor:
    """binomial_blur5(img)[..., ::2, ::2] with reflect-101 borders, as two
    banded products in f32; the result keeps img's dtype."""
    H, W = img.shape[-2:]
    Ho, Wo = -(-H // 2), -(-W // 2)
    My = _on_device(_down2_matrix, Ho, H, img.device)
    Mx = _on_device(_down2_matrix, Wo, W, img.device)
    out = torch.matmul(torch.matmul(My, img.float()), Mx.T)
    return out.to(img.dtype)


def build_halving_pyramid(
    img: torch.Tensor, n_levels: int, dtype=None
) -> list[torch.Tensor]:
    """Power-of-2 pyramid for LK (cv::buildOpticalFlowPyramid semantics).
    Level 0 is the input unchanged; `dtype` applies to levels 1+ (and to
    the input of the first decimation)."""
    levels = [img]
    cur = img if dtype is None else img.to(dtype)
    for _ in range(n_levels - 1):
        cur = _binomial_down2(cur)
        levels.append(cur)
    return levels
