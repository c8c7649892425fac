"""ATE of vo_tpu, the JAX reference, for the tracking_sift preset on
chip_smoke.py's pipeline sequence (60 synthetic frames at 376x1241 with
bench.py's real-motion parameters), with no textureless frame and with
frame 45 textureless. chip_smoke.py runs the PyTorch port's tracking_sift on
the same sequence and holds its ATE to a limit set from these figures.

    JAX_PLATFORMS=cpu python3 scripts/eval_ref_tracking_sift.py
    JAX_PLATFORMS=cpu python3 scripts/eval_ref_tracking_sift.py --seeds 1 2 3

vo_tpu runs under the port's definition of LK termination (lanes layout,
exit_mult = N + 1: a point stops on its own, never by the global early
exit) and the sync re-detect gate. Prints one line per run: ATE and its
share of the path length, the same over the frames before the first
re-detect, the re-detect steps, the SIFT keypoints on frame 0 and the
median association count. With --seeds it runs the sequence without the
textureless frame once per RANSAC seed (the key of `TrackingVO.init`), as
scripts/eval_torch_tracking_sift.py runs the port.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vo_tpu.data.synthetic import SyntheticSequence  # noqa: E402
from vo_tpu.frontend.sift import sift_detect_and_compute  # noqa: E402
from vo_tpu.ops.lk import LKConfig  # noqa: E402
from vo_tpu.runtime.presets import get_preset  # noqa: E402
from vo_tpu.utils.metrics import compute_ate  # noqa: E402


def ate_share(gt, est) -> tuple[float, float]:
    """ATE and its share of the ground-truth path length."""
    ate, _ = compute_ate(gt, est)
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return ate, ate / path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=None)
    args = ap.parse_args()
    runs = ([(None, s) for s in args.seeds] if args.seeds
            else [(None, 0), (45, 0)])

    preset = get_preset("tracking_sift")
    n_cap = preset.config.sift.nfeatures
    cfg = preset.config._replace(
        lk=LKConfig(layout="lanes", exit_mult=n_cap + 1),
        fallback_gate="sync",
    )
    for blank, seed in runs:
        seq = SyntheticSequence.generate(
            n_frames=60, shape=(376, 1241), n_points=4000, yaw_amplitude=0.3,
            n_turns=2.0, dropout_keep=0.0,
            dropouts=() if blank is None else ((blank, blank + 1),),
        )
        t0 = time.perf_counter()
        n_kp = int(sift_detect_and_compute(
            np.asarray(seq.frame(0), np.float32), cfg.sift).valid.sum())
        vo = preset.make(seq.K, cfg)
        vo.init = functools.partial(vo.init, seed=seed)
        est, gt, _, stats = preset.run(seq, vo)
        redetects = [i for i, s in enumerate(stats) if s.get("fallback")]
        ate, share = ate_share(gt, est)
        first = redetects[0] if redetects else len(gt)
        _, share_before = ate_share(gt[:first], est[:first])
        print(f"vo_tpu tracking_sift, frame {blank} blank, seed {seed}: ATE "
              f"{ate:.4f} ({100 * share:.2f} %), over frames 0..{first - 1} "
              f"{100 * share_before:.2f} %, re-detects at steps {redetects}, "
              f"{n_kp} SIFT keypoints on frame 0, median n_assoc "
              f"{int(np.median([s['n_assoc'] for s in stats[1:]]))} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
