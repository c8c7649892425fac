"""Differential harness: the port's ORB frontend vs the scalar numpy oracle
(port of vo_tpu/runtime/compare.py).

Equivalent of the reference's `compare` executable (src/compare.cpp:13-109:
runs the CUDA ORB on 000000.png, draws keypoints + orientation arrows, and
holds a commented-out CPU-vs-GPU descriptor Hamming diff). This version
performs the checks the reference left commented out:

    python -m vo_tpu_torch.runtime.compare [--image PATH] [--out PNG] \
        [--full] [--device cuda|cpu]

- detects with the port's ORB canvas path (single level for oracle
  comparability) on `device`;
- re-derives FAST scores, orientations, and BRIEF bits with the scalar
  numpy oracle (`tests/oracles.py`) at the detected keypoints;
- reports score/angle agreement and the descriptor bit-error rate;
- renders keypoints + orientation arrows to a PNG (matplotlib, headless).

Without `--image` it runs on frame 0 of a seeded KITTI-shape synthetic
sequence (376x1241, rounded to 8 bits as a PNG would hold it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synthetic_frame() -> np.ndarray:
    """Frame 0 of the KITTI-shape synthetic sequence with bench.py's
    real-motion parameters, rounded to uint8 values (float32)."""
    from ..data.synthetic import SyntheticSequence

    seq = SyntheticSequence.generate(
        n_frames=1, shape=(376, 1241), n_points=4000, yaw_amplitude=0.3,
        n_turns=2.0,
    )
    return np.clip(np.rint(seq.frame(0)), 0, 255).astype(np.float32)


def run_compare(image_path: str | None, out_png: str | None, full: bool,
                device=None) -> dict:
    import torch

    from .. import resolve_device
    from ..data.kitti import load_gray
    from ..frontend.orb import OrbConfig, orb_detect_and_compute
    from ..ops.brief import BRIEF_PATTERN

    tests_dir = os.path.join(_REPO, "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    from oracles import brief_bits_oracle, fast_score_oracle, orientation_oracle

    dev = resolve_device(device)
    img = load_gray(image_path) if image_path else synthetic_frame()
    cfg = OrbConfig(
        nfeatures=300 if not full else 1000,
        n_levels=1,  # oracle comparability: single level
        fast_threshold=20.0,
    )
    feats = orb_detect_and_compute(torch.from_numpy(img).to(dev), cfg)
    v = feats.valid.cpu().numpy()
    xs = feats.xs.cpu().numpy()[v].astype(int)
    ys = feats.ys.cpu().numpy()[v].astype(int)
    angles = feats.angles.cpu().numpy()[v]
    bits = feats.bits.cpu().numpy()[v]

    # oracle re-derivation at the detected keypoints
    score_map = fast_score_oracle(img, threshold=20.0)
    n_score_pos = int((score_map[ys, xs] > 0).sum())

    ang_err, bit_err = [], []
    pattern = np.asarray(BRIEF_PATTERN)
    for i in range(len(xs)):
        a = orientation_oracle(img, ys[i], xs[i], patch_size=31)
        d = np.angle(np.exp(1j * (angles[i] - a)))
        ang_err.append(abs(d))
        ob = brief_bits_oracle(img, ys[i], xs[i], angles[i], pattern)
        bit_err.append(np.mean(ob != bits[i]))

    report = {
        "image": image_path or "synthetic frame 0",
        "n_keypoints": int(v.sum()),
        "fast_score_positive_at_kp": n_score_pos,
        "orientation_max_err_rad": float(np.max(ang_err)) if ang_err else None,
        "orientation_mean_err_rad": float(np.mean(ang_err)) if ang_err else None,
        "descriptor_bit_error_rate": float(np.mean(bit_err)) if bit_err else None,
    }

    if out_png:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(14, 5))
        ax.imshow(img, cmap="gray")
        ax.scatter(xs, ys, s=10, edgecolors="lime", facecolors="none")
        L = 12.0
        ax.quiver(
            xs, ys, L * np.cos(angles), L * np.sin(angles),
            color="red", angles="xy", scale_units="xy", scale=1, width=0.002,
        )
        ax.set_title(
            f"{report['n_keypoints']} keypoints | "
            f"bit err {report['descriptor_bit_error_rate']:.4f}"
        )
        ax.axis("off")
        fig.savefig(out_png, dpi=110, bbox_inches="tight")
        plt.close(fig)
        report["visualization"] = out_png
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image", default=None,
                    help="PNG to run on (default: synthetic frame 0)")
    ap.add_argument("--out", default=None, help="keypoint visualization PNG")
    ap.add_argument("--full", action="store_true", help="more keypoints")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = run_compare(args.image, args.out, args.full, args.device)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
