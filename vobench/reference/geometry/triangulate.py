"""Two-view triangulation (port of vo_tpu/geometry/triangulate.py): the
closed-form depths of the pose chain, and the linear DLT of the reference's
get_scale (cv::triangulatePoints, feature_tracking.cpp:269).
"""

from __future__ import annotations

import torch


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, pts1: torch.Tensor,
                    pts2: torch.Tensor) -> torch.Tensor:
    """(N, 3) points from (N, 2) observations under projection matrices
    P1, P2 (3, 4): per point the smallest eigenvector of A^T A of the
    row-normalised 4x4 DLT system (a batched symmetric eigh)."""
    u1, v1 = pts1[:, 0:1], pts1[:, 1:2]
    u2, v2 = pts2[:, 0:1], pts2[:, 1:2]
    A = torch.stack([u1 * P1[2] - P1[0], v1 * P1[2] - P1[1],
                     u2 * P2[2] - P2[0], v2 * P2[2] - P2[1]], dim=1)
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=2, keepdim=True),
                        min=1e-12)
    _, vecs = torch.linalg.eigh(torch.einsum("nij,nik->njk", A, A))
    X = vecs[:, :, 0]  # eigenvector of the smallest eigenvalue
    w = X[:, 3:4]
    w = torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))
    return X[:, :3] / w


def triangulate_normalized(R: torch.Tensor, t: torch.Tensor,
                           pts1n: torch.Tensor, pts2n: torch.Tensor
                           ) -> torch.Tensor:
    """DLT from normalised coordinates with P1 = [I|0], P2 = [R|t] (points
    in camera 1's frame)."""
    P1 = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device),
                    R.new_zeros((3, 1))], 1)
    P2 = torch.cat([R, t.reshape(3, 1)], 1)
    return triangulate_dlt(P1, P2, pts1n, pts2n)


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


def triangulate_fast(R: torch.Tensor, t: torch.Tensor, pts1n: torch.Tensor,
                     pts2n: torch.Tensor) -> torch.Tensor:
    """(N, 3) camera-1 points from the closed-form depths (z1 * x1)."""
    z1, _ = triangulate_depths(R, t, pts1n, pts2n)
    return z1[:, None] * torch.cat([pts1n, torch.ones_like(pts1n[:, :1])], 1)
