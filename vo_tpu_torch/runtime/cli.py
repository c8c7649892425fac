"""Command-line VO runner (port of vo_tpu/runtime/cli.py): preset + dataset
-> the reference's result bundle (gt_path.txt / est_path.txt / scale.txt /
metrics.png / path_visualization.png + a metrics JSON).

Replaces the reference's per-driver hardcoded main() functions
(feature_tracking.cpp:360-367 etc.) with one entry point:

    python -m vo_tpu_torch.runtime.cli --preset tracking_orb \
        --kitti-dir /data/kitti --seq 05 --max-frames 1000 --out results/

    python -m vo_tpu_torch.runtime.cli --preset tracking_orb --synthetic 100

It runs on `--device` (`cuda` unless told otherwise). Timing is reported
like results/timing.txt (wall-clock over the frame loop, excluding
pipeline construction and the first step, closed by a device sync), plus
that first step's time separately as `compile_s`: the kernels' build and
the libraries' set-up, which the reference doesn't have."""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import resolve_device
from ..utils.io import save_results
from ..utils.metrics import evaluate_paths
from .presets import PRESETS, get_preset


def build_sequence(args):
    if args.synthetic:
        from ..data.synthetic import SyntheticSequence

        return SyntheticSequence.generate(
            n_frames=args.synthetic, shape=(240, 320), seed=args.seed
        )
    from ..data.kitti import KittiSequence

    return KittiSequence.open(
        args.kitti_dir, args.seq, max_frames=args.max_frames
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="tracking_orb", choices=sorted(PRESETS))
    ap.add_argument("--kitti-dir", default=None)
    ap.add_argument("--seq", default="05")
    ap.add_argument("--max-frames", type=int, default=1000)
    ap.add_argument(
        "--synthetic", type=int, default=0,
        help="run on an N-frame synthetic sequence instead of KITTI",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="result bundle directory")
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="checkpoint the pipeline state every N frames (resumes from "
        "an existing checkpoint; BA cadence, re-detect gate, and window "
        "rewrites carry across the resume)",
    )
    ap.add_argument("--checkpoint-file", default=None)
    ap.add_argument(
        "--live", action="store_true",
        help="live trajectory canvas during the run (drawPaths/imshow "
        "equivalent, feature_tracking.cpp:312-328; lags the device a few "
        "frames; headless-safe no-op without a display)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if not args.synthetic and args.kitti_dir is None:
        ap.error("need --kitti-dir or --synthetic N")

    device = resolve_device(args.device)  # raises at once without a card
    preset = get_preset(args.preset)
    seq = build_sequence(args)

    t0 = time.perf_counter()
    pipeline = preset.build(seq.K, device=device)
    # one throwaway step pair: builds the kernels, sets up the libraries
    state = pipeline.init(seq.frame(0))
    pipeline.step(state, seq.frame(min(1, len(seq) - 1)))
    _sync(device)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    if args.checkpoint_every > 0:
        from .checkpoint import CheckpointingRunner

        ckpt = args.checkpoint_file or os.path.join(
            args.out or ".", f"{args.preset}.ckpt.npz"
        )
        runner = CheckpointingRunner(
            pipeline, ckpt, every=args.checkpoint_every
        )
        est, gt, scales, stats = runner.run(seq, verbose=args.verbose)
    else:
        on_frame = None
        view = None
        if args.live:
            from ..utils.live import LiveTrajectoryView

            view = LiveTrajectoryView()
            gt_poses = seq.poses

            def on_frame(i, frame):
                pose = frame.pose.numpy()  # the host copy that arrived
                view.update(gt_poses[i][[0, 2], 3], pose[[0, 2], 3])

        est, gt, scales, stats = preset.run(
            seq, pipeline, verbose=args.verbose, on_frame=on_frame
        )
        if view is not None:
            view.close()
    _sync(device)
    run_s = time.perf_counter() - t0

    metrics = evaluate_paths(gt, est, scales)
    report = {
        "preset": args.preset,
        "n_frames": len(seq),
        "runtime_s": round(run_s, 3),
        "fps": round((len(seq) - 1) / max(run_s, 1e-9), 2),
        "compile_s": round(compile_s, 2),
        **{
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in metrics.items()
        },
    }
    print(json.dumps(report))

    if args.out:
        out_dir = os.path.join(args.out, args.preset)
        save_results(out_dir, gt, est, scales)
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(report, f, indent=2)
        if not args.no_plots:
            from ..utils.plots import plot_metrics, plot_paths

            plot_paths(gt, est, os.path.join(out_dir, "path_visualization.png"))
            plot_metrics(gt, est, scales, os.path.join(out_dir, "metrics.png"))
    return report


if __name__ == "__main__":
    main()
