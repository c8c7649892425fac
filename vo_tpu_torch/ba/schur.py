"""Windowed bundle adjustment: Levenberg-Marquardt with an explicit Schur
complement (port of vo_tpu/ba/schur.py, single device).

The reference solves with Ceres (with_bundle_adjustment.cpp: residual
:27-68, problem :616-669, SPARSE_SCHUR :672-679). As vo_tpu does, this
solver uses the bipartite structure of a window:

- residual r_{w,l} = project(K, R(aa_w) X_l + t_w) - obs_{w,l}, Huber(1.0)
  by IRLS square-root weights (Ceres HuberLoss, :661);
- Jacobians by the chain rule over the dense (W, L) grid, with R and
  dR/d(aa) computed once per pose;
- normal equations in Schur form: U (W,6,6), V (L,3,3), W_{w,l} (6,3); the
  landmarks are marginalised with closed-form 3x3 inverses and the reduced
  camera system (6W x 6W, W <= 8) is solved densely;
- a fixed number of LM steps, each accepted or refused by a select: no
  value is read back to the host inside the solve.

Poses are world->cam [angle-axis | translation] 6-vectors, as the
reference optimises the inverted poses (:596-600, :713).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.linalg3 import inv3x3
from ..geometry.se3 import exp_so3, exp_so3_jacobian


class BAConfig(NamedTuple):
    max_iters: int = 20
    huber_delta: float = 1.0  # px (with_bundle_adjustment.cpp:661)
    lambda_init: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.5
    # damping floor: along the near-flat monocular gauge direction the
    # step is ~ gradient noise / lambda, so a lambda decaying towards 0
    # turns f32 cancellation noise into null-space drift
    lambda_min: float = 1e-4
    gauge_fix_first: bool = True  # first pose constant (:669)
    # soft prior pinning a scale observable to its initial value (the
    # monocular 7th gauge freedom); sqrt-weight in pixel-residual units
    scale_gauge_weight: float = 100.0
    # "traj_len" pins the window's total path length, "baseline0" only
    # the frame-0/1 distance
    scale_gauge_mode: str = "traj_len"


class BAResult(NamedTuple):
    poses: torch.Tensor  # (W, 6) world->cam [aa | t]
    points: torch.Tensor  # (L, 3)
    cost0: torch.Tensor  # () initial robust cost
    cost: torch.Tensor  # () final robust cost
    n_obs: torch.Tensor  # () active observations


def _residual(pose6, X, obs, K):
    """One reprojection residual (2,) (with_bundle_adjustment.cpp:34-56):
    p = R(aa) X + t, pinhole K."""
    p = exp_so3(pose6[:3]) @ X + pose6[3:]
    z = torch.where(p[2].abs() > 1e-9, p[2], torch.full_like(p[2], 1e-9))
    u = K[0, 0] * p[0] / z + K[0, 2]
    v = K[1, 1] * p[1] / z + K[1, 2]
    return torch.stack([u - obs[0], v - obs[1]])


def _res_and_jac(poses, points, obs, K):
    """Residuals and Jacobians over the dense (W, L) grid: r (W, L, 2),
    Jc (W, L, 2, 6), Jp (W, L, 2, 3)."""
    aa, t = poses[:, :3], poses[:, 3:]
    R = exp_so3(aa)  # (W, 3, 3)
    dR = exp_so3_jacobian(aa)  # (W, 3, 3, 3): dR[w, a, b, k]
    p = torch.einsum("wab,lb->wla", R, points) + t[:, None, :]
    z = p[..., 2]
    z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    fx, fy = K[0, 0], K[1, 1]
    u = fx * p[..., 0] / z + K[0, 2]
    v = fy * p[..., 1] / z + K[1, 2]
    r = torch.stack([u - obs[..., 0], v - obs[..., 1]], -1)
    zero = torch.zeros_like(z)
    inv_z = 1.0 / z
    A = torch.stack([  # d residual / d p, (W, L, 2, 3)
        torch.stack([fx * inv_z, zero, -fx * p[..., 0] * inv_z * inv_z], -1),
        torch.stack([zero, fy * inv_z, -fy * p[..., 1] * inv_z * inv_z], -1),
    ], -2)
    dp_daa = torch.einsum("wabk,lb->wlak", dR, points)
    Jc = torch.cat([torch.einsum("wlra,wlak->wlrk", A, dp_daa), A], -1)
    Jp = torch.einsum("wlra,wab->wlrb", A, R)
    return r, Jc, Jp


def _huber_sqrt_weight(r2, delta):
    """IRLS sqrt-weight for Huber on the squared residual norm r2."""
    rn = torch.sqrt(torch.clamp(r2, min=1e-18))
    return torch.where(rn <= delta, torch.ones_like(rn), torch.sqrt(delta / rn))


def _robust_cost(r2, mask, delta):
    """Sum of Huber rho(||r||) over active observations (Ceres' rho: r2
    where ||r|| <= d, else 2 d ||r|| - d^2)."""
    rn = torch.sqrt(torch.clamp(r2, min=1e-18))
    rho = torch.where(rn <= delta, r2, 2.0 * delta * rn - delta * delta)
    return torch.where(mask, rho, torch.zeros_like(rho)).sum()


def _gauge_obs(poses, mode: str):
    """The scale observable the gauge prior pins, and its gradient
    (W, 6) in closed form: the path length through the camera centres
    c_i = -R_i^T t_i ("traj_len"), or only its first segment
    ("baseline0")."""
    R = exp_so3(poses[:, :3])
    t = poses[:, 3:]
    c = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    D = c[1:] - c[:-1] + 1e-12
    d = torch.linalg.vector_norm(D, dim=-1)
    u = D / d[:, None]  # d |D_i| / d D_i
    if mode == "baseline0":
        u = torch.cat([u[:1], torch.zeros_like(u[1:])])
    zero = torch.zeros_like(u[:1])
    g = torch.cat([zero, u]) - torch.cat([u, zero])  # d obs / d c_i
    # c_i = -R_i^T t_i: d/dt_i = -R_i g_i, d/daa_k = -t_i^T dR_k g_i
    dR = exp_so3_jacobian(poses[:, :3])
    grad = torch.cat([-torch.einsum("wa,wabk,wb->wk", t, dR, g),
                      -(R @ g[..., None])[..., 0]], -1)
    return (d[0] if mode == "baseline0" else d.sum()), grad


def bundle_adjust(poses: torch.Tensor, points: torch.Tensor, obs: torch.Tensor,
                  obs_mask: torch.Tensor, point_mask: torch.Tensor,
                  K: torch.Tensor, config: BAConfig = BAConfig(),
                  return_trace: bool = False,
                  point_prior_w: torch.Tensor | None = None):
    """Joint pose and structure refinement on a fixed window.

    poses (W, 6) world->cam; points (L, 3); obs (W, L, 2) px; obs_mask
    (W, L) observation (w, l) takes part; point_mask (L,) landmark is
    real. `point_prior_w` (L,), where given, adds the residual
    w * (X - X_init) for landmarks with w > 0 (the cross-window map
    anchor of ba/window.py): landmark-diagonal, so it adds to V and gp
    only. With `return_trace`, also returns each LM step's (accept,
    lambda, candidate cost), stacked over the steps."""
    W = poses.shape[0]
    dt = poses.dtype
    mask = obs_mask & point_mask[None, :]
    # hard-zero masked landmark rows: a huge or non-finite coordinate
    # overflows the Jacobian products to inf, and 0 * inf = NaN
    points = torch.where(point_mask[:, None] & torch.isfinite(points), points,
                         torch.zeros_like(points))
    X_anchor = points
    pw2 = None if point_prior_w is None else torch.where(
        point_mask, point_prior_w, torch.zeros_like(point_prior_w)) ** 2
    free = torch.ones(W, dtype=dt, device=poses.device)
    if config.gauge_fix_first:
        free[0] = 0.0
    eye3 = torch.eye(3, dtype=dt, device=poses.device)
    eye6 = torch.eye(6, dtype=dt, device=poses.device)

    d_target, _ = _gauge_obs(poses, config.scale_gauge_mode)

    def scale_residual(poses_):
        """The gauge prior's residual and its Jacobian (W, 6)."""
        obs_, grad = _gauge_obs(poses_, config.scale_gauge_mode)
        return (config.scale_gauge_weight * (obs_ - d_target),
                config.scale_gauge_weight * grad)

    def normal_eqs(poses_, points_):
        r, Jc, Jp = _res_and_jac(poses_, points_, obs, K)
        r2 = (r * r).sum(-1)
        sw = _huber_sqrt_weight(r2, config.huber_delta)
        sw = torch.where(mask, sw, torch.zeros_like(sw))[..., None]
        rw = r * sw
        Jcw = Jc * sw[..., None] * free[:, None, None, None]
        Jpw = Jp * sw[..., None]
        U = torch.einsum("wlri,wlrj->wij", Jcw, Jcw)
        V = torch.einsum("wlri,wlrj->lij", Jpw, Jpw)
        Wm = torch.einsum("wlri,wlrj->wlij", Jcw, Jpw)
        gc = -torch.einsum("wlri,wlr->wi", Jcw, rw)
        gp = -torch.einsum("wlri,wlr->li", Jpw, rw)
        cost = _robust_cost(r2, mask, config.huber_delta)
        if pw2 is not None:
            dX = points_ - X_anchor
            V = V + pw2[:, None, None] * eye3
            gp = gp - pw2[:, None] * dX
            cost = cost + (pw2 * (dX * dX).sum(-1)).sum()
        rs, _ = scale_residual(poses_)
        return U, V, Wm, gc, gp, cost + rs * rs

    def solve(poses_, U, V, Wm, gc, gp, lam):
        # Marquardt damping lam * diag(H), plus a tiny identity floor
        du = eye6 * torch.diagonal(U, dim1=-2, dim2=-1)[..., None, :]
        Ud = U + lam * du + (lam * 1e-6) * eye6
        # padding landmarks get an identity V (their gp is zero)
        dv = eye3 * torch.diagonal(V, dim1=-2, dim2=-1)[..., None, :]
        Vd = torch.where(point_mask[:, None, None],
                         V + lam * dv + (lam * 1e-6) * eye3, eye3)
        Vinv = inv3x3(Vd)
        Y = torch.einsum("wlij,ljk->wlik", Wm, Vinv)
        S = -torch.einsum("wlik,vljk->wvij", Y, Wm)
        S = S + torch.einsum("wv,wij->wvij",
                             torch.eye(W, dtype=dt, device=U.device), Ud)
        rhs = gc - torch.einsum("wlik,lk->wi", Y, gp)
        # gauge: the fixed pose's rows and columns zero, identity diagonal
        f = (free[:, None] * torch.ones(1, 6, dtype=dt, device=U.device)
             ).reshape(-1)
        Sd = S.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
        Sd = Sd * f[:, None] * f[None, :] + torch.diag(1.0 - f)
        rhsd = rhs.reshape(-1) * f
        # scale-gauge prior: a rank-1 update of the reduced system
        rs, Js = scale_residual(poses_)
        Jf = Js.reshape(-1) * f
        Sd = Sd + torch.outer(Jf, Jf)
        rhsd = rhsd - Jf * rs
        dc = torch.linalg.solve_ex(Sd, rhsd, check_errors=False
                                   ).result.reshape(W, 6)
        dp = torch.einsum("lij,lj->li", Vinv,
                          gp - torch.einsum("wlij,wi->lj", Wm, dc))
        return dc, torch.where(point_mask[:, None], dp, torch.zeros_like(dp))

    eqs = normal_eqs(poses, points)
    cost0 = eqs[-1]
    lam = torch.full((), config.lambda_init, dtype=dt, device=poses.device)
    cur = (poses, points) + eqs[:-1]
    cost = cost0
    trace = []
    for _ in range(config.max_iters):
        poses_, points_, U, V, Wm, gc, gp = cur
        dc, dp = solve(poses_, U, V, Wm, gc, gp, lam)
        cand = (poses_ + dc, points_ + dp)
        cand_eqs = normal_eqs(*cand)
        cand_cost = cand_eqs[-1]
        accept = cand_cost < cost
        trace.append((accept, lam, cand_cost))
        cur = tuple(torch.where(accept, a, b)
                    for a, b in zip(cand + cand_eqs[:-1], cur))
        cost = torch.where(accept, cand_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * config.lambda_down,
                                      lam * config.lambda_up),
                          config.lambda_min, 1e8)
    res = BAResult(poses=cur[0], points=cur[1], cost0=cost0, cost=cost,
                   n_obs=mask.sum())
    if not return_trace:
        return res
    return res, tuple(torch.stack(x) for x in zip(*trace))


def reprojection_rmse(poses, points, obs, obs_mask, point_mask, K):
    """Unrobust RMSE in pixels over active observations (diagnostic)."""
    r, _, _ = _res_and_jac(poses, points, obs, K)
    m = (obs_mask & point_mask[None, :])[..., None]
    n = torch.clamp(m.sum(), min=1)
    return torch.sqrt(torch.where(m, r * r, torch.zeros_like(r)).sum() / n)
