"""ATE of vo_tpu, the JAX reference, on chip_smoke.py's pipeline sequence
(tracking_orb, 60 synthetic frames at 376x1241 with bench.py's real-motion
parameters) with no textureless frame, with frame 30 textureless and with
frame 45 textureless. chip_smoke.py prints the PyTorch port's ATE for the
same three sequences.

    JAX_PLATFORMS=cpu python3 scripts/eval_ref_blank_frame.py

vo_tpu runs under the port's definition of LK termination (lanes layout,
exit_mult = N + 1: a point stops on its own, never by the global early
exit) and the sync re-detect gate. Prints one line per sequence: ATE and
its share of the path length, the re-detect steps, and the estimated step
length over the ground truth's around the blank frame.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vo_tpu.data.synthetic import SyntheticSequence  # noqa: E402
from vo_tpu.frontend.orb import level_budgets  # noqa: E402
from vo_tpu.ops.lk import LKConfig  # noqa: E402
from vo_tpu.runtime.presets import get_preset  # noqa: E402
from vo_tpu.utils.metrics import compute_ate  # noqa: E402


def main() -> int:
    preset = get_preset("tracking_orb")
    n_cap = sum(level_budgets(preset.config.orb))
    cfg = preset.config._replace(
        lk=LKConfig(layout="lanes", exit_mult=n_cap + 1),
        fallback_gate="sync",
    )
    for blank in (None, 30, 45):
        seq = SyntheticSequence.generate(
            n_frames=60, shape=(376, 1241), n_points=4000, yaw_amplitude=0.3,
            n_turns=2.0, dropout_keep=0.0,
            dropouts=() if blank is None else ((blank, blank + 1),),
        )
        t0 = time.perf_counter()
        est, gt, _, stats = preset.run(seq, preset.make(seq.K, cfg))
        ate, _ = compute_ate(gt, est)
        path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
        step = (np.linalg.norm(np.diff(est, axis=0), axis=1)
                / np.linalg.norm(np.diff(gt, axis=0), axis=1))
        near = {} if blank is None else {
            i + 1: round(float(step[i]), 3)
            for i in range(blank - 2, min(blank + 3, len(step)))}
        print(f"vo_tpu tracking_orb, frame {blank} blank: ATE {ate:.4f} on "
              f"a {path:.2f} path ({100 * ate / path:.2f} %), re-detects at "
              f"steps {[i for i, s in enumerate(stats) if s.get('fallback')]}"
              f", est/gt step length near the blank {near} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
