"""ATE of the PyTorch port's tracking_sift on chip_smoke.py's pipeline
sequence (60 synthetic frames at 376x1241, no textureless frame), over
several RANSAC seeds, with the sync re-detect gate (as
scripts/eval_ref_tracking_sift.py runs vo_tpu, the JAX reference).

    python3 scripts/eval_torch_tracking_sift.py [--seeds 0 1 2 ...]

Needs a CUDA card. Prints one line per seed: ATE and its share of the path
length, the same over the frames before the first re-detect, the re-detect
steps and the median association count; then the spread over the seeds.
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


def ate_share(gt, est) -> tuple[float, float]:
    """ATE and its share of the ground-truth path length."""
    ate, _ = compute_ate(gt, est)
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return ate, ate / path


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--gate", choices=("sync", "async"), default="sync")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    preset = get_preset("tracking_sift")
    cfg = preset.config._replace(fallback_gate=args.gate)
    seq = _Staged(SyntheticSequence.generate(
        n_frames=60, shape=(376, 1241), n_points=4000, yaw_amplitude=0.3,
        n_turns=2.0), torch.device("cuda"))
    shares = []
    for seed in args.seeds:
        vo = preset.make(seq.K, cfg)
        vo.init = functools.partial(vo.init, seed=seed)
        t0 = time.perf_counter()
        est, gt, _, stats = preset.run(seq, vo)
        redetects = [i for i, s in enumerate(stats) if s.get("fallback")]
        ate, share = ate_share(gt, est)
        first = redetects[0] if redetects else len(seq)
        _, share_before = ate_share(gt[:first], est[:first])
        shares.append(share)
        print(f"port tracking_sift, seed {seed}, {args.gate} gate: ATE "
              f"{ate:.4f} ({100 * share:.2f} %), over frames 0..{first - 1} "
              f"{100 * share_before:.2f} %, re-detects at steps {redetects}, "
              f"median n_assoc "
              f"{int(np.median([s['n_assoc'] for s in stats[1:]]))} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    print(f"port tracking_sift over seeds {args.seeds}: ATE share min "
          f"{100 * min(shares):.2f} %, median {100 * np.median(shares):.2f} %, "
          f"max {100 * max(shares):.2f} %", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
