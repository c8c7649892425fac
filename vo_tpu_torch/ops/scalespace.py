"""Gaussian scale space and DoG pyramid for SIFT (port of
vo_tpu/ops/scalespace.py; Lowe 2004 / OpenCV layout).

Optional 2x upsample with the base blur sqrt(sigma^2 - 4 * 0.5^2); each
octave holds n_layers + 3 Gaussian images made by incremental separable
blurs (kernel B2 through `conv.separable_conv_same`, periodic reflect-101
where a blur is wider than a small octave); the next octave is layer
n_layers decimated by 2; DoG = adjacent differences.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .conv import gaussian_kernel_1d, separable_conv_same
from .pyramid import resize_bilinear


def blur_sigma(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with OpenCV's kernel-size rule
    (ksize = 2 * round(4 * sigma) + 1 for f32 images)."""
    if sigma <= 0:
        return img
    ksize = 2 * int(round(4.0 * sigma)) + 1
    k = gaussian_kernel_1d(ksize, sigma).astype(np.float32)
    return separable_conv_same(img, k, k)


def n_octaves_for(shape: tuple[int, int], upsample: bool) -> int:
    """OpenCV: up to log2(min dim) - 2 octaves (the smallest >= ~8 px)."""
    h, w = shape
    if upsample:
        h, w = h * 2, w * 2
    return max(1, int(round(math.log2(min(h, w)))) - 2)


def build_scale_space(img: torch.Tensor, n_layers: int = 3,
                      sigma: float = 1.6, upsample: bool = True,
                      assumed_blur: float = 0.5):
    """(gauss, dogs): lists over octaves of (n_layers+3, Ho, Wo) and
    (n_layers+2, Ho, Wo) stacks."""
    if upsample:
        H, W = img.shape
        base = resize_bilinear(img, (2 * H, 2 * W))
        sig_diff = math.sqrt(max(sigma * sigma - (2.0 * assumed_blur) ** 2,
                                 0.01))
    else:
        base = img
        sig_diff = math.sqrt(max(sigma * sigma - assumed_blur * assumed_blur,
                                 0.01))
    base = blur_sigma(base, sig_diff)

    n_oct = n_octaves_for(tuple(img.shape), upsample)
    k = 2.0 ** (1.0 / n_layers)
    # incremental sigmas between successive layers (OpenCV's sig[] array)
    sig_prev = sigma
    inc = []
    for i in range(1, n_layers + 3):
        sig_total = sigma * (k**i)
        inc.append(math.sqrt(sig_total**2 - sig_prev**2))
        sig_prev = sig_total

    gauss, dogs = [], []
    cur = base
    for _ in range(n_oct):
        layers = [cur]
        for i in range(n_layers + 2):
            layers.append(blur_sigma(layers[-1], inc[i]))
        g = torch.stack(layers)  # (n_layers+3, Ho, Wo)
        gauss.append(g)
        dogs.append(g[1:] - g[:-1])
        cur = layers[n_layers][::2, ::2]  # sigma doubled: the next octave
    return gauss, dogs


@functools.lru_cache(maxsize=None)
def octave_meta(shape: tuple[int, int], upsample: bool):
    """Per octave, the scale from octave to input coordinates."""
    n_oct = n_octaves_for(shape, upsample)
    base = 0.5 if upsample else 1.0
    return [base * (2.0**o) for o in range(n_oct)]
