"""ATE of the PyTorch port for the matching presets and the windowed-BA
presets on chip_smoke.py's pipeline sequence (60 synthetic frames at
376x1241, no textureless frame), with the sync re-detect gate: the port's
side of scripts/eval_ref_matching.py, which runs vo_tpu (the JAX
reference) on the same frames and prints the same lines.

    python3 scripts/eval_torch_matching.py --presets tracking_orb_ba \
        --seeds 0 1 2

Needs a CUDA card. Prints one line per run: ATE and its share of the path
length, the median association count, the re-detect steps and, for the
BA presets, the BA runs, the poses each solve accepted and the cost before
and after each solve. --seeds runs each preset once per RANSAC seed (the
seed of `init`).
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vo_tpu_torch.data.synthetic import SyntheticSequence  # noqa: E402
from vo_tpu_torch.runtime.presets import get_preset  # noqa: E402
from vo_tpu_torch.utils.metrics import compute_ate  # noqa: E402

PRESETS = ("matching_orb", "matching_sift", "matching_orb_3d_correspond",
           "tracking_sift_ba", "tracking_orb_ba")


class _Staged:
    """The sequence with its frames already on the card."""

    def __init__(self, seq, device):
        import torch

        self.poses, self.K = seq.poses, seq.K
        self.frames = [torch.from_numpy(seq.frame(i)).to(device)
                       for i in range(len(seq))]

    def __len__(self):
        return len(self.frames)

    def frame(self, i):
        return self.frames[i]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--presets", nargs="+", default=list(PRESETS),
                    choices=PRESETS)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    seq = _Staged(SyntheticSequence.generate(
        n_frames=60, shape=(376, 1241), n_points=4000, yaw_amplitude=0.3,
        n_turns=2.0), torch.device("cuda"))
    for name in args.presets:
        preset = get_preset(name)
        cfg = preset.config._replace(fallback_gate="sync")
        for seed in args.seeds:
            t0 = time.perf_counter()
            vo = (preset.make(seq.K, cfg, preset.window) if preset.window
                  else preset.make(seq.K, cfg))
            vo.init = functools.partial(vo.init, seed=seed)
            est, gt, _, stats = preset.run(seq, vo)
            ate, _ = compute_ate(gt, est)
            path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
            redetects = [i for i, s in enumerate(stats) if s.get("fallback")]
            line = (f"port {name}, seed {seed}: ATE {ate:.4f} "
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
