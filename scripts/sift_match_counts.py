"""SIFT keypoints and L2 ratio matches between consecutive frames of the
1000-frame eval's sequences, in vo_tpu (JAX) and in the port (PyTorch),
both on the CPU: what a tracking_sift re-detect associates.

    JAX_PLATFORMS=cpu python3 scripts/sift_match_counts.py \
        [--sequence hard|clean] [--seed 0] [--frames 0 62 100]

For each frame i it prints, per package, the keypoints of frames i and
i + 1 (the preset's SiftConfig) and their knn2 ratio matches (the preset's
match_ratio), the association count of a re-detect into i + 1.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import torch  # noqa: E402

import vo_tpu  # noqa: E402,F401 (matmul precision)
from vo_tpu.data.synthetic import SyntheticSequence  # noqa: E402
from vo_tpu.frontend import sift as jsift  # noqa: E402
from vo_tpu.models import vo as jvo  # noqa: E402
from vo_tpu.runtime.presets import get_preset as jpreset  # noqa: E402
from vo_tpu_torch.frontend import sift as tsift  # noqa: E402
from vo_tpu_torch.models import vo as tvo  # noqa: E402
from vo_tpu_torch.runtime.presets import get_preset as tpreset  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sequence", choices=("hard", "clean"), default="hard")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, nargs="+", default=[0, 62, 100])
    args = ap.parse_args()
    gen = (SyntheticSequence.generate_hard if args.sequence == "hard"
           else SyntheticSequence.generate_clean)
    seq = gen(1000, seed=args.seed)
    jcfg = jpreset("tracking_sift").config
    tcfg = tpreset("tracking_sift").config
    jdet = jax.jit(lambda im: jsift.sift_detect_and_compute(im, jcfg.sift))
    for i in args.frames:
        a, b = (jax.tree.map(np.asarray, jdet(seq.frame(j)))
                for j in (i, i + 1))
        jm = jvo.match_features(a.desc, b.desc, a.valid, b.valid, jcfg)
        c, d = (tsift.sift_detect_and_compute(torch.from_numpy(seq.frame(j)),
                                              tcfg.sift) for j in (i, i + 1))
        tm = tvo.match_features(c.desc, d.desc, c.valid, d.valid, tcfg)
        print(f"{args.sequence} seed {args.seed}, frames {i}/{i + 1}: vo_tpu "
              f"{int(a.valid.sum())}/{int(b.valid.sum())} keypoints, "
              f"{int(np.asarray(jm.valid).sum())} matches; port "
              f"{int(c.valid.sum())}/{int(d.valid.sum())} keypoints, "
              f"{int(tm.valid.sum())} matches", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
