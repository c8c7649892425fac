"""Sliding-window state and BA problem assembly for the BA pipeline (port
of vo_tpu/ba/window.py).

Reference semantics (with_bundle_adjustment.cpp): a window of the last
WINDOW_SIZE = 5 frames (:281-285), BA on every 10th frame with a full
window (:228), landmarks from the window's tracks (:502-575) with a
0.1-100 m baseline gate (:515-516) and cheirality (:555-572), per-pose
accept gates (:699-717).

As in vo_tpu, the tracker keeps slot identity across frames, so the window
stacks each frame's (K, 2) points and validity: tracks come free, no image
is kept, and the window is a fixed-shape set of tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..geometry.linalg3 import nullspace_jacobi
from ..geometry.se3 import exp_so3, inv_se3, log_so3, make_se3
from .schur import BAConfig, _lsum, _robust_cost, bundle_adjust


class WindowConfig(NamedTuple):
    window_size: int = 5  # WINDOW_SIZE (with_bundle_adjustment.cpp:282)
    ba_every: int = 10  # trigger cadence (:228)
    min_baseline: float = 0.1  # (:515)
    max_baseline: float = 100.0  # (:516)
    min_landmarks: int = 20
    # per-pose accept gates: vo_tpu's tight defaults (the reference's are
    # 0.5 rad / 50 m, :708-709)
    max_rot_update: float = 0.03  # rad
    max_trans_update: float = 1.0  # m
    # landmark gates beyond the reference's z > 0: positive depth below
    # max_depth and a reprojection within max_init_px in every observing
    # view
    max_depth: float = 2000.0
    max_init_px: float = 5.0
    # cross-window landmark reuse: landmarks solved in the previous window
    # and re-observed here start from their solved position and carry a
    # soft prior of this weight (px cost per metre)
    map_prior_weight: float = 3.0
    map_gate_px: float = 5.0  # reuse reprojection gate (all views)
    use_map: bool = True
    # adaptive accept: every holdout_every-th candidate landmark stays out
    # of the solve, and the solve applies only if their re-triangulated
    # cost does not worsen; 0 disables
    holdout_every: int = 5
    min_holdout: int = 8  # fewer held-out points than this: pass
    ba: BAConfig = BAConfig()


class WindowState(NamedTuple):
    """Chronological ring of the last `window_size` frames (index -1 =
    current frame), fixed shape; `count` tracks the fill."""

    poses: torch.Tensor  # (W, 4, 4) cam->world, chained estimates
    obs: torch.Tensor  # (W, K, 2) pixel positions per slot
    valid: torch.Tensor  # (W, K) slot observed in that frame
    count: torch.Tensor  # () int32 frames held (<= W)


def window_init(window_size: int, capacity: int, device=None) -> WindowState:
    return WindowState(
        poses=torch.eye(4, device=device).repeat(window_size, 1, 1),
        obs=torch.zeros((window_size, capacity, 2), device=device),
        valid=torch.zeros((window_size, capacity), dtype=torch.bool,
                          device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def window_push(st: WindowState, pose: torch.Tensor, pts: torch.Tensor,
                valid: torch.Tensor) -> WindowState:
    """Shift in the newest frame (the oldest drops out once full)."""
    return WindowState(
        poses=torch.cat([st.poses[1:], pose[None]]),
        obs=torch.cat([st.obs[1:], pts[None]]),
        valid=torch.cat([st.valid[1:], valid[None]]),
        count=torch.clamp(st.count + 1, max=st.poses.shape[0]),
    )


def window_reset(st: WindowState) -> WindowState:
    """Invalidate the window."""
    return st._replace(count=torch.zeros_like(st.count),
                       valid=torch.zeros_like(st.valid))


def window_remap(st: WindowState, old_idx: torch.Tensor, ok: torch.Tensor
                 ) -> WindowState:
    """Re-key the slots across a re-detect: new slot j inherits the
    history of old slot old_idx[j] where ok[j], else starts with none.
    The count is kept, so BA runs on across re-detects (two new slots
    mapping to one old slot both inherit its history)."""
    return WindowState(poses=st.poses, obs=st.obs[:, old_idx],
                       valid=st.valid[:, old_idx] & ok[None, :],
                       count=st.count)


def triangulate_window(T_wc: torch.Tensor, obs: torch.Tensor,
                       valid: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Masked multi-view DLT: (L, 3) world points from every valid
    observation in the window (invalid views' rows zeroed), the smallest
    right-singular vector by one-sided Jacobi."""
    P = torch.einsum("ij,wjk->wik", K, T_wc[:, :3])  # (W, 3, 4)
    u, v = obs[..., 0], obs[..., 1]
    r1 = u[..., None] * P[:, None, 2] - P[:, None, 0]  # (W, L, 4)
    r2 = v[..., None] * P[:, None, 2] - P[:, None, 1]
    A = torch.stack([r1, r2], 2)  # (W, L, 2, 4)
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True),
                        min=1e-12)
    A = A * valid[..., None, None]
    rows = A.permute(1, 0, 2, 3).reshape(A.shape[1], -1, 4)
    X = nullspace_jacobi(rows)  # (L, 4)
    w = X[..., 3:]
    return X[..., :3] / torch.where(w.abs() > 1e-12, w,
                                    torch.full_like(w, 1e-12))


def _reproject(T_wc, K, X):
    """Camera-frame depth (W, L) and pixel position (W, L, 2) of X in
    every view."""
    pc = torch.einsum("wij,lj->wli", T_wc[:, :3, :3], X) \
        + T_wc[:, None, :3, 3]
    z = pc[..., 2]
    zsafe = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    proj = pc[..., :2] / zsafe[..., None]
    f = torch.stack([K[0, 0], K[1, 1]])
    c = torch.stack([K[0, 2], K[1, 2]])
    return z, proj * f + c


def _gate_points(T_wc, obs, valid, K, X, px: float, max_depth: float):
    """(L,) acceptance: X keeps a positive bounded depth in every
    observing view and reprojects within `px` there, with >= 2 views."""
    z, uv = _reproject(T_wc, K, X)
    err2 = ((uv - obs) ** 2).sum(-1)
    view_ok = (z > 0.0) & (z < max_depth) & (err2 < px ** 2)
    ok_all = (view_ok | ~valid).all(0)
    return (valid.sum(0) >= 2) & ok_all & torch.isfinite(X).all(1)


def build_landmarks(T_wc, obs, valid, K, cfg: WindowConfig):
    """(X (L, 3), point_ok (L,)): windowed triangulation and its gates."""
    X = triangulate_window(T_wc, obs, valid, K)
    return X, _gate_points(T_wc, obs, valid, K, X, cfg.max_init_px,
                           cfg.max_depth)


def _holdout_cost(T_wc, obs, valid, K, hold, delta: float, group=None
                  ) -> torch.Tensor:
    """Huber reprojection cost of the held-out landmarks, each
    re-triangulated from the poses under test (a similarity of the whole
    window leaves it unchanged: it scores consistency)."""
    v = valid & hold[None, :]
    z, uv = _reproject(T_wc, K, triangulate_window(T_wc, obs, v, K))
    r2 = ((uv - obs) ** 2).sum(-1)
    good = v & (z > 0.0) & torch.isfinite(uv).all(-1)
    # a view gone degenerate under these poses is charged the clamp
    worst = torch.full_like(r2, 1e6)
    r2 = torch.where(good, torch.clamp(r2, max=1e6),
                     torch.where(v, worst, torch.zeros_like(r2)))
    return _lsum(_robust_cost(r2, v, delta), group)


def run_window_ba(st: WindowState, K: torch.Tensor, cfg: WindowConfig,
                  lmap=None, group=None):
    """Assemble and solve the window's BA; returns (new_poses (W, 4, 4),
    applied (W,) bool, info dict of 0-d tensors), and the updated map
    (map_X, map_ok) when `lmap` = (map_X (K, 3), map_ok (K,)) is given.

    Poses are optimised world->cam and gated per pose against runaway
    updates before they are written back. With `lmap`, map points that
    pass the gates against this window replace the fresh triangulation
    and carry a soft position prior.

    With `group` (a process group), the slot axis of `st.obs`, `st.valid`
    and `lmap` is this rank's shard of equal-sized shards in rank order:
    the gate counts, hold-out costs and the solve's landmark sums are
    all-reduced over it and the hold-out picks slots by global index, so
    the poses and the info come out replicated."""
    W, Kcap = st.valid.shape
    T_wc = inv_se3(st.poses)
    pose6 = torch.cat([log_so3(T_wc[:, :3, :3]), T_wc[:, :3, 3]], 1)
    X, point_ok = build_landmarks(T_wc, st.obs, st.valid, K, cfg)

    prior_w = reuse = None
    if lmap is not None:
        map_X, map_ok = lmap
        reuse = map_ok & _gate_points(T_wc, st.obs, st.valid, K, map_X,
                                      cfg.map_gate_px, cfg.max_depth)
        X = torch.where(reuse[:, None], map_X, X)
        point_ok = point_ok | reuse
        prior_w = torch.where(reuse, cfg.map_prior_weight, 0.0).to(X.dtype)

    # every holdout_every-th candidate validates the solve instead
    gidx = torch.arange(Kcap, device=X.device)
    if group is not None:
        gidx = gidx + dist.get_rank(group) * Kcap
    if cfg.holdout_every > 0:
        hold = point_ok & (gidx % cfg.holdout_every == 0)
    else:
        hold = torch.zeros_like(point_ok)
    solve_ok = point_ok & ~hold

    baseline = torch.linalg.vector_norm(st.poses[1, :3, 3]
                                        - st.poses[0, :3, 3])
    ba_ok = ((st.count >= W) & (baseline > cfg.min_baseline)
             & (baseline < cfg.max_baseline)
             & (_lsum(solve_ok.sum(), group) >= cfg.min_landmarks))
    solve_ok = solve_ok & ba_ok  # an empty problem when gated off

    res = bundle_adjust(pose6, torch.where(torch.isfinite(X), X,
                                           torch.zeros_like(X)),
                        st.obs, st.valid, solve_ok, K, config=cfg.ba,
                        point_prior_w=prior_w, group=group)

    # per-pose accept gates (:699-717)
    dR = exp_so3(res.poses[:, :3]) @ exp_so3(pose6[:, :3]).transpose(-1, -2)
    drot = torch.linalg.vector_norm(log_so3(dR), dim=-1)
    dtrans = torch.linalg.vector_norm(res.poses[:, 3:] - pose6[:, 3:], dim=-1)
    pose_ok = (ba_ok & (res.cost < res.cost0) & (drot < cfg.max_rot_update)
               & (dtrans < cfg.max_trans_update))
    new_T_wc = make_se3(exp_so3(res.poses[:, :3]), res.poses[:, 3:])

    # adaptive accept: the held-out landmarks must not get worse
    n_hold = _lsum(hold.sum(), group)
    if cfg.holdout_every > 0:
        d = cfg.ba.huber_delta
        c_old = _holdout_cost(T_wc, st.obs, st.valid, K, hold, d, group)
        c_new = _holdout_cost(new_T_wc, st.obs, st.valid, K, hold, d, group)
        pose_ok = pose_ok & ((c_new <= c_old) | (n_hold < cfg.min_holdout))
    else:
        c_old = c_new = torch.zeros((), device=X.device)

    new_poses = torch.where(pose_ok[:, None, None], inv_se3(new_T_wc),
                            st.poses)
    info = {
        "ba_ran": ba_ok,
        "ba_cost0": res.cost0,
        "ba_cost": res.cost,
        "ba_landmarks": _lsum(solve_ok.sum(), group),
        "ba_accepted": pose_ok.sum(),
        "ba_holdout_cost0": c_old,
        "ba_holdout_cost": c_new,
        "ba_holdout_n": n_hold,
    }
    if lmap is None:
        return new_poses, pose_ok, info
    # the map moves only on an applied solve: solved landmarks take their
    # refined positions, the rest age out
    applied = pose_ok.any()
    map_X, map_ok = lmap
    new_map = (torch.where((solve_ok & applied)[:, None], res.points, map_X),
               torch.where(applied, solve_ok, map_ok))
    info["ba_reused"] = _lsum((reuse & solve_ok).sum(), group)
    return new_poses, pose_ok, info, new_map
