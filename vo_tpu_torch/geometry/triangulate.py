"""Closed-form two-view depths (port of vo_tpu/geometry/triangulate.py:
triangulate_depths; the DLT comes with bundle adjustment)."""

from __future__ import annotations

import torch


def triangulate_depths(R: torch.Tensor, t: torch.Tensor, pts1n: torch.Tensor,
                       pts2n: torch.Tensor):
    """(z1, z2) minimizing ||z1 R x1 + t - z2 x2||^2 for bearings
    x_i = [u, v, 1]; one 2x2 solve per point. R (..., 3, 3) and t (..., 3)
    may carry leading batch dims (the four pose candidates); returns
    (..., N) depths."""
    ones = torch.ones_like(pts1n[:, :1])
    x1 = torch.cat([pts1n, ones], dim=1)  # (N, 3)
    x2 = torch.cat([pts2n, ones], dim=1)
    a = torch.einsum("...ij,nj->...ni", R, x1)  # R x1
    aa = (a * a).sum(-1)
    bb = (x2 * x2).sum(-1)
    ab = (a * x2).sum(-1)
    at = torch.einsum("...ni,...i->...n", a, t)
    bt = torch.einsum("ni,...i->...n", x2, t)
    det = aa * bb - ab * ab
    det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    z1 = (-at * bb + ab * bt) / det
    z2 = (-ab * at + aa * bt) / det
    return z1, z2
