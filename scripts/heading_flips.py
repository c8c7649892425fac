"""Heading change of an estimated path across the hard sequence's
texture-poor stretches, from result bundles (est_path.txt, gt_path.txt)
of scripts/eval_synthetic.py or scripts/eval_torch_synthetic.py.

    python3 scripts/heading_flips.py results_tpu/matching_orb_3d_correspond \
        results_gpu/seed1/matching_orb_3d_correspond ...

The heading of a path at step i is the direction of its 20-step chord
(x/z from step i to i + 20); its error is that of the estimate less that
of the ground truth. For each stretch [a, b) of
SyntheticSequence.generate_hard (k = N // 10: [3k, 3.5k), [6k, 6.33k),
[8k, 8.5k)) it prints the error's change from the chord ending at a to
the chord starting at b + 10, in degrees: how far the path turned away
from the truth while crossing the stretch. It also prints each bundle's
ATE from its metrics.json.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

CHORD = 20


def headings(path: np.ndarray) -> np.ndarray:
    """Unwrapped heading (degrees) of each CHORD-step chord of an x/z path."""
    chord = path[CHORD:] - path[:-CHORD]
    return np.degrees(np.unwrap(np.arctan2(chord[:, 0], chord[:, 1])))


def stretches(n: int) -> list[tuple[int, int]]:
    k = n // 10
    return [(3 * k, 3 * k + k // 2), (6 * k, 6 * k + k // 3),
            (8 * k, 8 * k + k // 2)]


def flips(bundle: str) -> list[float]:
    est = np.loadtxt(os.path.join(bundle, "est_path.txt"))
    gt = np.loadtxt(os.path.join(bundle, "gt_path.txt"))
    err = headings(est) - headings(gt)
    last = len(err) - 1
    return [float(err[min(b + 10, last)] - err[a - CHORD])
            for a, b in stretches(len(est))]


def main(argv) -> int:
    for bundle in argv:
        with open(os.path.join(bundle, "metrics.json")) as f:
            ate = json.load(f)["ate_rmse"]
        turns = ", ".join(f"{t:+.1f}" for t in flips(bundle))
        print(f"{bundle}: ATE {ate} m, heading change across the stretches "
              f"{turns} deg", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
