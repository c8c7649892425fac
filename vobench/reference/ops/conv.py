"""2-D convolution primitives (port of vo_tpu/ops/conv.py).

Correlation (no kernel flip) with host-side numpy taps, expressed as sums
of shifted slices; reflect-101 borders everywhere. Every odd-tap separable
correlation goes through kernel B2 (`blur_cuda.separable_blur`), as
vo_tpu routes it to its Pallas blur on the TPU.
"""

from __future__ import annotations

import numpy as np
import torch

from . import blur_cuda

SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float64)
SOBEL_Y = SOBEL_X.T.copy()
BINOMIAL_5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def opencv_gaussian_sigma(ksize: int) -> float:
    """OpenCV's default sigma heuristic (GaussianBlur.cpp:13-16)."""
    return 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8


def gaussian_kernel_1d(ksize: int, sigma: float | None = None) -> np.ndarray:
    """Normalized 1-D Gaussian taps (host-side constant)."""
    if sigma is None or sigma <= 0:
        sigma = opencv_gaussian_sigma(ksize)
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return k / k.sum()


def reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    """Periodic reflect-101 of indices into [0, n): index mod 2(n-1), then
    mirrored, so a pad wider than the axis reflects again and again, as
    numpy's and jnp.pad's mode="reflect" do (n == 1 maps to 0)."""
    if n == 1:
        return torch.zeros_like(i)
    i = torch.remainder(i, 2 * (n - 1))
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    return reflect101(torch.arange(-r, n + r, device=device), n)


def reflect_pad(img: torch.Tensor, ry: int, rx: int | None = None
                ) -> torch.Tensor:
    """Reflect-101 pad the last two axes by (ry, rx), periodically where a
    pad is wider than its axis."""
    if rx is None:
        rx = ry
    H, W = img.shape[-2:]
    if ry:
        img = img.index_select(-2, _reflect_index(H, ry, img.device))
    if rx:
        img = img.index_select(-1, _reflect_index(W, rx, img.device))
    return img


def conv2d_valid(img: torch.Tensor, kernel) -> torch.Tensor:
    """Valid correlation of (..., H, W) with a host-side (kh, kw) kernel,
    as a sum of shifted slices in raster tap order (zero taps skipped)."""
    k = np.asarray(kernel, np.float64)
    kh, kw = k.shape
    Ho, Wo = img.shape[-2] - kh + 1, img.shape[-1] - kw + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            t = float(np.float32(k[i, j]))
            if t == 0.0:
                continue
            term = img[..., i:i + Ho, j:j + Wo] * t
            out = term if out is None else out + term
    if out is None:
        out = img.new_zeros(img.shape[:-2] + (Ho, Wo))
    return out


def separable_conv_same(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Same-size separable correlation (row taps kx, column taps ky),
    reflect-101 borders. Odd taps go to kernel B2 on a CUDA tensor."""
    if np.size(ky) % 2 == 1 and np.size(kx) % 2 == 1:
        return blur_cuda.separable_blur(img, ky, kx)
    return blur_cuda.separable_blur_reference(img, ky, kx)


def gaussian_blur(img: torch.Tensor, ksize: int = 5,
                  sigma: float | None = None) -> torch.Tensor:
    """Separable Gaussian blur, OpenCV sigma heuristic, reflect-101."""
    k = gaussian_kernel_1d(ksize, sigma)
    return separable_conv_same(img, k, k)


def binomial_blur5(img: torch.Tensor) -> torch.Tensor:
    """The reference's fixed 5-tap binomial blur (GaussianBlur1D.cu), on
    kernel B2 for a CUDA tensor."""
    return separable_conv_same(img, BINOMIAL_5, BINOMIAL_5)


def sobel(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Same-size Sobel gradients (Ix, Iy), reflect-101 borders."""
    padded = reflect_pad(img, 1, 1)
    return conv2d_valid(padded, SOBEL_X), conv2d_valid(padded, SOBEL_Y)
