"""Path/scale dump IO in the reference's exact text formats (a copy of
vo_tpu/utils/io.py: the files are byte-identical for the same arrays).

The reference dumps `gt_path.txt` / `est_path.txt` as one `x z` pair per line
and `scale.txt` as one `gt_scale est_scale` pair per line
(feature_tracking.cpp:330-357); `metric.py` reloads them with np.loadtxt.
"""

from __future__ import annotations

import os

import numpy as np


def save_path(path: np.ndarray, filename: str) -> None:
    """Write an (N, 2) x/z path, one 'x z' pair per line."""
    path = np.asarray(path, dtype=np.float64)
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as f:
        for x, z in path:
            f.write(f"{x} {z}\n")


def load_path(filename: str) -> np.ndarray:
    return np.loadtxt(filename, dtype=np.float64).reshape(-1, 2)


def save_scales(scales: np.ndarray, filename: str) -> None:
    """Write (N, 2) [gt_scale, est_scale] pairs, one per line."""
    save_path(np.asarray(scales, dtype=np.float64), filename)


def load_scales(filename: str) -> np.ndarray:
    return load_path(filename)


def save_results(
    out_dir: str,
    gt_path: np.ndarray,
    est_path: np.ndarray,
    scales: np.ndarray | None = None,
) -> None:
    """Dump the reference's full result bundle layout into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    save_path(gt_path, os.path.join(out_dir, "gt_path.txt"))
    save_path(est_path, os.path.join(out_dir, "est_path.txt"))
    if scales is not None:
        save_scales(scales, os.path.join(out_dir, "scale.txt"))
