"""Dense FAST-9 corner scoring (port of vo_tpu/ops/fast.py).

Circle offsets and comparisons as Fast.cu:23-28: >= / <= threshold, early
reject unless >= 3 of circle pixels {0, 4, 8, 12} are brighter or darker,
contiguity of n circle pixels (mod 16), score = sum |Ip - circle_i|,
3-pixel border excluded.
"""

from __future__ import annotations

import numpy as np
import torch

# (offx, offy) pairs, Fast.cu:23-28 order (12 o'clock, clockwise)
CIRCLE_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1),
        (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1),
        (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int64,
)
RADIUS = 3
CHECK_IDX = (0, 4, 8, 12)


def _edge_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    H, W = img.shape[-2:]
    ys = torch.arange(-r, H + r, device=img.device).clamp(0, H - 1)
    xs = torch.arange(-r, W + r, device=img.device).clamp(0, W - 1)
    return img.index_select(-2, ys).index_select(-1, xs)


def _circle_views(img: torch.Tensor) -> torch.Tensor:
    """(16, ..., H, W): circle sample i at every pixel (edge padding)."""
    H, W = img.shape[-2:]
    p = _edge_pad(img, RADIUS)
    return torch.stack(
        [p[..., RADIUS + oy:RADIUS + oy + H, RADIUS + ox:RADIUS + ox + W]
         for ox, oy in CIRCLE_OFFSETS.tolist()],
        0,
    )


def fast_score(img: torch.Tensor, threshold: float = 20.0, n: int = 9
               ) -> torch.Tensor:
    """(H, W) FAST corner score map; 0 where not a corner."""
    H, W = img.shape[-2:]
    circ = _circle_views(img)
    bright = circ >= img[None] + threshold
    dark = circ <= img[None] - threshold

    n_bright = sum(bright[i].to(torch.int32) for i in CHECK_IDX)
    n_dark = sum(dark[i].to(torch.int32) for i in CHECK_IDX)
    early_ok = torch.maximum(n_bright, n_dark) >= 3

    def has_run(mask):
        m = torch.cat([mask, mask[: n - 1]], 0).to(torch.int32)
        c = torch.cumsum(m, 0)
        c = torch.cat([torch.zeros_like(c[:1]), c], 0)
        return ((c[n:] - c[:-n]) == n).any(0)

    is_corner = early_ok & (has_run(bright) | has_run(dark))
    score = (img[None] - circ).abs().sum(0)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    interior = (ys >= RADIUS) & (ys < H - RADIUS) & (xs >= RADIUS) \
        & (xs < W - RADIUS)
    return torch.where(is_corner & interior, score, torch.zeros_like(score))
