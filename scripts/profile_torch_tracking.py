"""Profile the PyTorch/CUDA port's tracking step on one CUDA card.

    python3 scripts/profile_torch_tracking.py [--preset tracking_orb]
        [--steps 10] [--detect] [--trace PATH]

Builds the preset of vo_tpu_torch (tracking_orb or tracking_sift) at KITTI
shape (376x1241) on a synthetic sequence staged on the card, runs warm-up
steps, then profiles `--steps` tracking steps with torch.profiler (with
`--detect`, that many calls of the preset's detector, the work of a
re-detect step). Prints one JSON line with the wall time per step (host
clock, closed by synchronize), the device-busy share (summed CUDA kernel
time over the profiled wall time), CUDA kernel launches per step, and the
top operators by self CPU time and by self device time. `--trace` also
writes a Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tracking_orb",
                    choices=["tracking_orb", "tracking_sift"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--detect", action="store_true")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vo_tpu_torch.data.synthetic import SyntheticSequence
    from vo_tpu_torch.runtime.presets import get_preset

    if not torch.cuda.is_available():
        print("profile_torch_tracking: no CUDA device", file=sys.stderr)
        return 2
    n = args.steps + 4
    seq = SyntheticSequence.generate(n_frames=n + 1, shape=(376, 1241),
                                     n_points=4000, yaw_amplitude=0.3,
                                     n_turns=2.0)
    frames = [torch.from_numpy(seq.frame(i)).cuda() for i in range(n + 1)]
    vo = get_preset(args.preset).build(seq.K)
    state = vo.init(frames[0])
    for i in range(1, 5):
        state, _ = vo.step(state, frames[i])
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5, n + 1):
            if args.detect:
                vo.detect(frames[i])
            else:
                state, out = vo.step(state, frames[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = n - 4
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kernels)
    avg = prof.key_averages()

    def top(key, k=15):
        rows = sorted(avg, key=lambda e: getattr(e, key), reverse=True)[:k]
        return [{"name": e.key, "count": e.count,
                 "us_per_step": getattr(e, key) / steps} for e in rows]

    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "preset": args.preset,
        "profiled": "detect" if args.detect else "tracking step",
        "steps": steps,
        "ms_per_step": 1e3 * wall / steps,
        "device_busy_share": busy_us * 1e-6 / wall,
        "device_ms_per_step": busy_us * 1e-3 / steps,
        "kernel_launches_per_step": len(kernels) / steps,
        "top_self_cpu": top("self_cpu_time_total"),
        "top_self_device": top("self_device_time_total"),
    }))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
