"""ATE of vo_tpu, the JAX reference, for the matching presets and the
windowed-BA preset on chip_smoke.py's pipeline sequence (60 synthetic
frames at 376x1241 with bench.py's real-motion parameters, no textureless
frame). chip_smoke.py runs the PyTorch port's matching_orb, matching_sift,
matching_orb_3d_correspond and tracking_sift_ba on the same sequence and
holds each ATE to a limit set from these figures.

    JAX_PLATFORMS=cpu python3 scripts/eval_ref_matching.py
    JAX_PLATFORMS=cpu python3 scripts/eval_ref_matching.py \
        --presets matching_sift --seeds 0 1 2

vo_tpu runs under the port's definition of LK termination (lanes layout,
exit_mult = N + 1: a point stops on its own, never by the global early
exit) and the sync re-detect gate; only tracking_sift_ba tracks with LK.
Prints one line per run: ATE and its share of the path length, the median
association count, the re-detect steps and, for tracking_sift_ba, the BA
runs, the poses they accepted and the cost before and after each solve.
--seeds runs each preset once per RANSAC seed (the key of `init`).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vo_tpu.data.synthetic import SyntheticSequence  # noqa: E402
from vo_tpu.models.vo import _feature_capacity  # noqa: E402
from vo_tpu.ops.lk import LKConfig  # noqa: E402
from vo_tpu.runtime.presets import get_preset  # noqa: E402
from vo_tpu.utils.metrics import compute_ate  # noqa: E402

PRESETS = ("matching_orb", "matching_sift", "matching_orb_3d_correspond",
           "tracking_sift_ba")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--presets", nargs="+", default=list(PRESETS),
                    choices=PRESETS)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args()

    seq = SyntheticSequence.generate(
        n_frames=60, shape=(376, 1241), n_points=4000, yaw_amplitude=0.3,
        n_turns=2.0,
    )
    for name in args.presets:
        preset = get_preset(name)
        n_cap = _feature_capacity(preset.config)
        preset = dataclasses.replace(preset, config=preset.config._replace(
            lk=LKConfig(layout="lanes", exit_mult=n_cap + 1),
            fallback_gate="sync",
        ))
        for seed in args.seeds:
            t0 = time.perf_counter()
            vo = preset.build(seq.K)
            vo.init = functools.partial(vo.init, seed=seed)
            est, gt, _, stats = preset.run(seq, vo)
            ate, _ = compute_ate(gt, est)
            path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
            redetects = [i for i, s in enumerate(stats) if s.get("fallback")]
            line = (f"vo_tpu {name}, seed {seed}: ATE {ate:.4f} "
                    f"({100 * ate / path:.2f} % of a {path:.2f} path), median "
                    f"n_assoc {int(np.median([s['n_assoc'] for s in stats[1:]]))}"
                    f", re-detects at steps {redetects}")
            ba = [(i, s) for i, s in enumerate(stats) if s.get("ba_ran")]
            if preset.window is not None:
                line += (f", BA runs {len(ba)} at steps {[i for i, _ in ba]}, "
                         f"poses accepted {[s['ba_accepted'] for _, s in ba]}"
                         f", cost {[(round(s['ba_cost0'], 1), round(s['ba_cost'], 1)) for _, s in ba]}")
            print(f"{line} ({time.perf_counter() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
