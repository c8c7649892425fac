"""Rotated BRIEF descriptors (port of vo_tpu/ops/brief.py; Brief.cu:40-94).

The 256 pairs of the learned pattern (OpenCV's public `bit_pattern_31_`,
kept as this package's own ``brief_pattern.npy``) are rotated by each
keypoint's angle with round-half-to-even, compared on the 5x5 box-summed
image, and packed LSB-first into 32 bytes. A pair with a sample outside
[2, dim-3] of the keypoint's level rectangle gives bit 0.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .integral import box_filter5

_PATTERN_PATH = os.path.join(os.path.dirname(__file__), "brief_pattern.npy")
BRIEF_PATTERN = np.load(_PATTERN_PATH)  # (256, 4) int32: x1, y1, x2, y2


@functools.lru_cache(maxsize=None)
def _pattern(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(BRIEF_PATTERN.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def _pack_weights(device: torch.device) -> torch.Tensor:
    return (2 ** torch.arange(8, device=device)).to(torch.int32)


def brief_bits(smoothed: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
               angles: torch.Tensor, rect=None) -> torch.Tensor:
    """(K, 256) uint8 bit planes: bit i = 1 iff smoothed(p1_i) <
    smoothed(p2_i), by direct gathers (the reference's windowed sampling
    is bit-exact with them)."""
    H, W = smoothed.shape[-2:]
    rx0, ry0, rx1, ry1 = (0, 0, W, H) if rect is None else rect
    pat = _pattern(smoothed.device)
    px1, py1, px2, py2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
    cos = torch.cos(angles)[:, None]
    sin = torch.sin(angles)[:, None]
    dx1 = torch.round(cos * px1 - sin * py1).long()
    dy1 = torch.round(sin * px1 + cos * py1).long()
    dx2 = torch.round(cos * px2 - sin * py2).long()
    dy2 = torch.round(sin * px2 + cos * py2).long()
    xi = xs.long()[:, None]
    yi = ys.long()[:, None]
    cx1, cy1, cx2, cy2 = xi + dx1, yi + dy1, xi + dx2, yi + dy2

    def col(v):
        return torch.as_tensor(v, device=smoothed.device)[..., None]

    bx0, by0, bx1, by1 = col(rx0), col(ry0), col(rx1), col(ry1)

    def inb(cx, cy):
        return (cx >= bx0 + 2) & (cx <= bx1 - 3) & (cy >= by0 + 2) \
            & (cy <= by1 - 3)

    ok = inb(cx1, cy1) & inb(cx2, cy2)
    s1 = smoothed[cy1.clamp(0, H - 1), cx1.clamp(0, W - 1)]
    s2 = smoothed[cy2.clamp(0, H - 1), cx2.clamp(0, W - 1)]
    return (ok & (s1 < s2)).to(torch.uint8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) {0,1} -> (K, 32) uint8, LSB-first within each byte."""
    w = _pack_weights(bits.device)
    k = bits.shape[0]
    return (bits.reshape(k, 32, 8).to(torch.int32) * w).sum(-1).to(torch.uint8)


def brief_descriptors(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                      angles: torch.Tensor, rect=None):
    """Smooth + bits + packed. Returns (bits (K, 256), packed (K, 32))."""
    bits = brief_bits(box_filter5(img), ys, xs, angles, rect)
    return bits, pack_bits(bits)
