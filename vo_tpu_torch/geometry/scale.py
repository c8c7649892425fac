"""Relative scale from consecutive 3D point clouds (port of
vo_tpu/geometry/scale.py): median of distance ratios between consecutive
valid points, clipped to [0.1, 5.0], 1.0 when empty
(feature_tracking.cpp:244-310). Medians are the upper median
(std::nth_element at count/2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SCALE_MIN = 0.1
SCALE_MAX = 5.0
EPS = 1e-6


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Upper median (index count//2 of the ascending sort) over masked
    entries; 1.0 when none are valid."""
    order = torch.sort(torch.where(mask, x, torch.finfo(x.dtype).max)).values
    count = mask.sum()
    idx = torch.clamp(count // 2, 0, x.shape[0] - 1).reshape(1)
    med = order.index_select(0, idx)[0]  # a 0-d index would sync the host
    return torch.where(count > 0, med, torch.ones_like(med))


def compact_valid(pts: torch.Tensor, valid: torch.Tensor):
    """Stable-compact rows so valid entries come first, in order."""
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    return pts[order], valid[order]


def consecutive_distances(pts: torch.Tensor, valid: torch.Tensor):
    """Distances between consecutive valid points (after compaction):
    (dists (N-1,), pair_valid (N-1,))."""
    p, v = compact_valid(pts, valid)
    d = torch.linalg.vector_norm(p[1:] - p[:-1], dim=1)
    return d, v[1:] & v[:-1]


@functools.lru_cache(maxsize=None)
def _scatter_perm_np(n: int) -> np.ndarray:
    h = (np.arange(n, dtype=np.uint64) * np.uint64(2654435761)) % np.uint64(
        2**32
    )
    return np.argsort(h)


@functools.lru_cache(maxsize=None)
def _scatter_perm(n: int, device: torch.device) -> torch.Tensor:
    """Fixed pseudo-random slot permutation (Knuth multiplicative hash),
    identical to vo_tpu's: scatters the consecutive-pair set so pair
    distances are lateral-dominated (vo_tpu/geometry/scale.py:58-77)."""
    return torch.from_numpy(_scatter_perm_np(n)).to(device)


def relative_scale_matched(prev_pts: torch.Tensor, cur_pts: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Scale from matched clouds: row i of prev corresponds to row i of
    cur, one shared validity mask (the tracking path)."""
    perm = _scatter_perm(prev_pts.shape[0], prev_pts.device)
    prev_pts, cur_pts, valid = prev_pts[perm], cur_pts[perm], valid[perm]
    dp, vp = consecutive_distances(prev_pts, valid)
    dc, _ = consecutive_distances(cur_pts, valid)
    s = masked_median(dp / (dc + EPS), vp)
    return torch.clamp(s, SCALE_MIN, SCALE_MAX)
