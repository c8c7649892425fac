"""Trajectory evaluation metrics.

Same metric definitions as the reference's ``metric.py:5-45`` (ATE RMSE,
RPE RMSE at delta, mean scale-drift ratio, KITTI segment drift %), verified
against the reference's shipped ``results/*/{gt,est}_path.txt`` fixtures.

Paths are (N, 2) arrays of KITTI ground-plane positions (x, z).
"""

from __future__ import annotations

import numpy as np


def compute_ate(gt: np.ndarray, est: np.ndarray) -> tuple[float, np.ndarray]:
    """Absolute trajectory error RMSE over per-frame position errors."""
    gt = np.asarray(gt, dtype=np.float64)
    est = np.asarray(est, dtype=np.float64)
    errors = np.linalg.norm(gt - est, axis=1)
    return float(np.sqrt(np.mean(errors**2))), errors


def compute_rpe(
    gt: np.ndarray, est: np.ndarray, delta: int = 1
) -> tuple[float, np.ndarray]:
    """Relative pose (translation) error RMSE over frame pairs (i, i+delta)."""
    gt = np.asarray(gt, dtype=np.float64)
    est = np.asarray(est, dtype=np.float64)
    gt_rel = gt[delta:] - gt[:-delta]
    est_rel = est[delta:] - est[:-delta]
    rpe = np.linalg.norm(gt_rel - est_rel, axis=1)
    return float(np.sqrt(np.mean(rpe**2))), rpe


def compute_scale_drift(scale: np.ndarray) -> tuple[float, np.ndarray]:
    """Mean of est/gt per-frame scale ratios; input is (N, 2) [gt, est]."""
    scale = np.asarray(scale, dtype=np.float64)
    ratio = scale[:, 1] / scale[:, 0]
    return float(np.mean(ratio)), ratio


def kitti_drift(
    gt: np.ndarray,
    est: np.ndarray,
    segment_lengths: tuple[int, ...] = (100,),
) -> dict[int, float]:
    """KITTI-style segment drift: mean % translation error over all
    subsequences whose ground-truth arc length first exceeds L metres."""
    gt = np.asarray(gt, dtype=np.float64)
    est = np.asarray(est, dtype=np.float64)
    dist = np.cumsum(np.linalg.norm(gt[1:] - gt[:-1], axis=1))

    results: dict[int, float] = {}
    for L in segment_lengths:
        drift_list = []
        for i in range(len(dist)):
            end = int(np.searchsorted(dist, dist[i] + L))
            if end >= len(gt):
                break
            trans_error = np.linalg.norm((gt[end] - gt[i]) - (est[end] - est[i]))
            drift_list.append(100.0 * trans_error / L)
        results[L] = float(np.mean(drift_list)) if drift_list else float("nan")
    return results


def evaluate_paths(
    gt: np.ndarray,
    est: np.ndarray,
    scale: np.ndarray | None = None,
    segment_lengths: tuple[int, ...] = (50, 100, 200),
) -> dict:
    """Full evaluation bundle matching the reference's metric report."""
    ate, _ = compute_ate(gt, est)
    rpe, _ = compute_rpe(gt, est, delta=1)
    out = {
        "ate_rmse": ate,
        "rpe_rmse": rpe,
        "kitti_drift": kitti_drift(gt, est, segment_lengths),
    }
    if scale is not None and len(scale):
        out["scale_drift"], _ = compute_scale_drift(scale)
    return out
