"""Batched PnP pose refinement against a landmark map (port of
vo_tpu/geometry/pnp.py).

A Gauss-Newton solve of the 6-dof world->cam pose over every visible map
point, with IRLS Huber weights: the residual/Jacobian grid is one dense
(L, 2) block (ba/schur.py's camera blocks with W = 1), and the iteration
is a fixed number of damped 6x6 solves, each update taken or refused by a
select, with no host read inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .se3 import exp_so3, exp_so3_jacobian, log_so3


class PnPResult(NamedTuple):
    pose6: torch.Tensor  # (6,) world->cam [angle-axis | translation]
    n_inliers: torch.Tensor  # () int32: residual < inlier_px at the end
    ok: torch.Tensor  # () bool: enough inliers to trust the refinement
    rmse: torch.Tensor  # () rmse over the inliers (px)


def _res_jac(pose6, X, obs, K):
    """r (L, 2), J (L, 2, 6) for r = project(K, R X + t) - obs."""
    aa, t = pose6[:3], pose6[3:]
    R = exp_so3(aa)
    dR = exp_so3_jacobian(aa)  # (3, 3, 3): dR[a, b, k]
    p = X @ R.T + t
    z = torch.where(p[:, 2].abs() > 1e-9, p[:, 2],
                    torch.full_like(p[:, 2], 1e-9))
    fx, fy = K[0, 0], K[1, 1]
    u = fx * p[:, 0] / z + K[0, 2]
    v = fy * p[:, 1] / z + K[1, 2]
    r = torch.stack([u - obs[:, 0], v - obs[:, 1]], -1)
    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    A = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * p[:, 0] * inv_z * inv_z], -1),
        torch.stack([zero, fy * inv_z, -fy * p[:, 1] * inv_z * inv_z], -1),
    ], -2)  # (L, 2, 3)
    dp_daa = torch.einsum("abk,lb->lak", dR, X)
    J = torch.cat([torch.einsum("lra,lak->lrk", A, dp_daa), A], -1)
    return r, J


def pnp_refine(X: torch.Tensor, obs: torch.Tensor, valid: torch.Tensor,
               K: torch.Tensor, T_wc_init: torch.Tensor, iters: int = 8,
               huber_px: float = 2.0, inlier_px: float = 4.0,
               min_inliers: int = 30, damping: float = 1e-6) -> PnPResult:
    """Refine a world->cam pose (4, 4) against map landmarks X (L, 3)
    observed at obs (L, 2) px; `valid` (L,) marks landmarks mapped and
    tracked this frame. Masked landmarks contribute zero rows."""
    pose6 = torch.cat([log_so3(T_wc_init[:3, :3]), T_wc_init[:3, 3]])
    Xs = torch.where(valid[:, None], X, torch.zeros_like(X))
    obs_s = torch.where(valid[:, None], obs, torch.zeros_like(obs))
    eye6 = torch.eye(6, dtype=pose6.dtype, device=pose6.device)
    for _ in range(iters):
        r, J = _res_jac(pose6, Xs, obs_s, K)
        rn = torch.sqrt(torch.clamp((r * r).sum(-1), min=1e-18))
        w = torch.where(rn <= huber_px, torch.ones_like(rn), huber_px / rn)
        w = torch.where(valid, w, torch.zeros_like(w))[:, None]
        Jw = J * w[..., None]
        H = torch.einsum("lri,lrj->ij", Jw, J)
        g = torch.einsum("lri,lr->i", Jw, r)
        H = H + damping * eye6 * (1.0 + torch.diagonal(H))
        delta = torch.linalg.solve_ex(H, -g, check_errors=False).result
        # a divergent solve (near-singular H) must not yank the pose
        okstep = (torch.isfinite(delta).all()
                  & (torch.linalg.vector_norm(delta[:3]) < 0.5)
                  & (torch.linalg.vector_norm(delta[3:]) < 10.0))
        pose6 = torch.where(okstep, pose6 + delta, pose6)
    r, _ = _res_jac(pose6, Xs, obs_s, K)
    r2 = (r * r).sum(-1)
    inl = valid & (r2 < inlier_px ** 2)
    n_inl = inl.sum()
    rmse = torch.sqrt(torch.where(inl, r2, torch.zeros_like(r2)).sum()
                      / torch.clamp(n_inl, min=1))
    return PnPResult(pose6=pose6, n_inliers=n_inl.to(torch.int32),
                     ok=n_inl >= min_inliers, rmse=rmse)
