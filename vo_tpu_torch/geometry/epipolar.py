"""Essential-matrix estimation: batched 5-point LO-RANSAC and pose
recovery (port of vo_tpu/geometry/epipolar.py).

Convention: E satisfies p2^T E p1 = 0 in normalized coordinates; the
recovered (R, t) map camera-1 coordinates to camera-2: x2 = R x1 + t.
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import torch

from .linalg3 import det3x3, nullspace_jacobi, svd3x3
from .triangulate import triangulate_depths


def normalize_pixels(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixel -> normalized camera coordinates."""
    return torch.stack(
        [(pts[..., 0] - K[0, 2]) / K[0, 0], (pts[..., 1] - K[1, 2]) / K[1, 1]],
        -1,
    )


def _epipolar_rows(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """(..., N, 9) rows a with a . vec(E) = p2^T E p1."""
    x1, y1 = pts1[..., 0], pts1[..., 1]
    x2, y2 = pts2[..., 0], pts2[..., 1]
    one = torch.ones_like(x1)
    return torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], -1
    )


@functools.lru_cache(maxsize=None)
def _const(name: str, dtype: torch.dtype, device: torch.device):
    """Small constant matrices, copied to the device once (a copy per call
    would wait for the device)."""
    values = {
        "sv": [1.0, 1.0, 0.0],
        "W": [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
    }[name]
    return torch.tensor(values, dtype=dtype, device=device)


def project_to_essential(F: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto the essential manifold: sv -> (1, 1, 0)."""
    U, _, Vt = svd3x3(F)
    return (U * _const("sv", F.dtype, F.device)[..., None, :]) @ Vt


def _hartley(pts: torch.Tensor, weights: torch.Tensor):
    """Weighted Hartley normalization: (points with weighted centroid 0 and
    weighted mean radius sqrt(2), T (..., 3, 3))."""
    w = weights[..., None]
    wsum = torch.clamp(w.sum(-2, keepdim=True), min=1e-12)
    mu = (pts * w).sum(-2, keepdim=True) / wsum
    d = (torch.linalg.vector_norm(pts - mu, dim=-1, keepdim=True) * w).sum(
        -2, keepdim=True) / wsum
    s = (2.0**0.5) / torch.clamp(d, min=1e-9)
    q = (pts - mu) * s
    s0 = s[..., 0, 0]
    T = pts.new_zeros(pts.shape[:-2] + (3, 3))
    T[..., 0, 0] = s0
    T[..., 1, 1] = s0
    T[..., 0, 2] = -s0 * mu[..., 0, 0]
    T[..., 1, 2] = -s0 * mu[..., 0, 1]
    T[..., 2, 2] = 1.0
    return q, T


def fit_essential_ls(pts1: torch.Tensor, pts2: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares essential fit: Hartley-normalize, Jacobi
    nullspace, denormalize, project onto the essential manifold."""
    q1, T1 = _hartley(pts1, weights)
    q2, T2 = _hartley(pts2, weights)
    e = nullspace_jacobi(_epipolar_rows(q1, q2) * weights[..., None])
    F = e.reshape(e.shape[:-1] + (3, 3))
    return project_to_essential(T2.transpose(-1, -2) @ F @ T1)


def sampson_sq(E: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor):
    """Squared Sampson distance: E (..., 3, 3), pts (N, 2) -> (..., N)."""
    p1 = torch.cat([pts1, torch.ones_like(pts1[:, :1])], -1)
    p2 = torch.cat([pts2, torch.ones_like(pts2[:, :1])], -1)
    Ep1 = torch.einsum("...ij,nj->...ni", E, p1)
    Etp2 = torch.einsum("...ji,nj->...ni", E, p2)
    num = torch.einsum("ni,...ni->...n", p2, Ep1) ** 2
    den = (Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2
           + Etp2[..., 0] ** 2 + Etp2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


class EssentialResult(NamedTuple):
    E: torch.Tensor  # (3, 3)
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int


def draw_slots(n_valid: torch.Tensor, n_iters: int, generator=None,
               m: int = 5) -> torch.Tensor:
    """(n_iters, m) uniform slots in [0, n_valid), drawn on the device of
    n_valid without a host sync."""
    u = torch.rand((n_iters, m), generator=generator, device=n_valid.device)
    return torch.minimum((u * n_valid).long(), n_valid - 1)


def ransac_essential(pts1n: torch.Tensor, pts2n: torch.Tensor,
                     valid: torch.Tensor, threshold: float,
                     n_iters: int = 512, generator=None,
                     slot: torch.Tensor | None = None) -> EssentialResult:
    """Fully batched 5-point MSAC over normalized correspondences, then two
    LO refits (wide gather, then the final threshold).

    Minimal samples are slots into the valid-first ordering of the points:
    `slot` (n_iters, 5) when given (tests feed the reference's draws),
    else uniform draws from `generator`. `threshold` is the Sampson bound
    in normalized coordinates (pixel threshold / fx)."""
    from .fivepoint import five_point_essential

    n_valid = torch.clamp(valid.sum(), min=5)
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    if slot is None:
        slot = draw_slots(n_valid, n_iters, generator)
    idx = order[slot.to(order.device).long()]  # (S, 5)
    E_all, ok = five_point_essential(pts1n[idx], pts2n[idx])
    E_cand = E_all.reshape(-1, 3, 3)
    cand_ok = ok.reshape(-1)

    errs = sampson_sq(E_cand, pts1n, pts2n)
    errs = torch.where(torch.isfinite(errs), errs, torch.inf)
    thr2 = torch.as_tensor(threshold, dtype=pts1n.dtype,
                           device=pts1n.device) ** 2
    msac = torch.where(valid[None, :], torch.minimum(errs, thr2), thr2).sum(1)
    best = torch.argmin(torch.where(cand_ok, msac, torch.inf))

    def classify(E):
        return (sampson_sq(E, pts1n, pts2n) < thr2) & valid

    E_best = E_cand.index_select(0, best.reshape(1))[0]  # no host sync
    inl_best = classify(E_best)
    n_best = inl_best.sum()
    for mult in (2.0, 1.0):
        gather = (sampson_sq(E_best, pts1n, pts2n) < mult * thr2) & valid
        E_new = fit_essential_ls(pts1n, pts2n, gather.to(pts1n.dtype))
        inl_new = classify(E_new)
        n_new = inl_new.sum()
        better = n_new >= n_best
        E_best = torch.where(better, E_new, E_best)
        inl_best = torch.where(better, inl_new, inl_best)
        n_best = torch.maximum(n_new, n_best)
    return EssentialResult(E=E_best, inliers=inl_best, n_inliers=n_best)


class PoseResult(NamedTuple):
    R: torch.Tensor  # (3, 3) x2 = R x1 + t
    t: torch.Tensor  # (3,) unit norm
    mask: torch.Tensor  # (N,) bool: inliers passing cheirality
    votes: torch.Tensor  # () int


def recover_pose(E: torch.Tensor, pts1n: torch.Tensor, pts2n: torch.Tensor,
                 valid: torch.Tensor, max_depth: float = 1e6) -> PoseResult:
    """4-way decomposition + cheirality vote (cv::recoverPose)."""
    U, _, Vt = svd3x3(E)
    U = U * torch.sign(det3x3(U))
    Vt = Vt * torch.sign(det3x3(Vt))
    W = _const("W", E.dtype, E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[:, 2]
    Rs = torch.stack([Ra, Ra, Rb, Rb])
    ts = torch.stack([t, -t, t, -t])
    z1, z2 = triangulate_depths(Rs, ts, pts1n, pts2n)  # (4, N)
    masks = (
        (z1 > 0) & (z2 > 0) & (z1 < max_depth) & (z2 < max_depth)
        & torch.isfinite(z1) & torch.isfinite(z2) & valid
    )
    votes = masks.sum(1)
    k = torch.argmax(votes).reshape(1)  # select on the device, no host sync
    return PoseResult(R=Rs.index_select(0, k)[0], t=ts.index_select(0, k)[0],
                      mask=masks.index_select(0, k)[0],
                      votes=votes.index_select(0, k)[0])
