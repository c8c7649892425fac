"""Headless rendering of the reference's evaluation figures (a copy of
vo_tpu/utils/plots.py; matplotlib is imported only when a figure is drawn).

metric.py:63-88 renders `metrics.png` (2x2: ATE per frame, RPE per pair,
scale gt-vs-est, drift-per-segment bars) and `path_visualization.png`
(gt vs est x/z trajectories). Same layouts, Agg backend (the reference
also pops a live cv2 canvas every frame, feature_tracking.cpp:312-328 —
replaced by these offline artifacts + structured per-frame stats)."""

from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_paths(gt: np.ndarray, est: np.ndarray, out_file: str) -> None:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(gt[:, 0], gt[:, 1], label="ground truth")
    ax.plot(est[:, 0], est[:, 1], label="estimated")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title("trajectory (x/z)")
    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    fig.savefig(out_file, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_metrics(
    gt: np.ndarray,
    est: np.ndarray,
    scales: np.ndarray | None,
    out_file: str,
    segment_lengths: tuple[int, ...] = (50, 100, 200),
) -> None:
    from .metrics import compute_ate, compute_rpe, kitti_drift

    plt = _plt()
    _, ate_err = compute_ate(gt, est)
    _, rpe_err = compute_rpe(gt, est, delta=1)
    drift = kitti_drift(gt, est, segment_lengths)

    fig, axes = plt.subplots(2, 2, figsize=(12, 9))
    axes[0, 0].plot(ate_err)
    axes[0, 0].set_title("ATE per frame (m)")
    axes[0, 1].plot(rpe_err)
    axes[0, 1].set_title("RPE per pair (m)")
    if scales is not None and len(scales):
        axes[1, 0].plot(scales[:, 0], label="gt")
        axes[1, 0].plot(scales[:, 1], label="est")
        axes[1, 0].legend()
    axes[1, 0].set_title("per-frame scale")
    ls = [str(k) for k in drift]
    axes[1, 1].bar(ls, [drift[k] for k in drift])
    axes[1, 1].set_title("KITTI drift % per segment length (m)")
    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    fig.savefig(out_file, dpi=120, bbox_inches="tight")
    plt.close(fig)
