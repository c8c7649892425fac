"""Scaling harness: frames/s per rank count (port of
vo_tpu/parallel/scaling.py).

Measures the frame-parallel ORB detect (`batched_orb`, weak scaling:
`frames_per_device` frames per rank) and, with ``--step``, the
keypoint-sharded tracking step (strong scaling: one problem over more
ranks), each rank count in its own spawned job:

    python -m vo_tpu_torch.parallel.scaling --cpu 4      # gloo, CPU ranks
    python -m vo_tpu_torch.parallel.scaling --devices    # NCCL, every card

On the CPU the numbers check the mechanism, not a device. Times are host
clock around `n_iters` calls, closed by a collective (and a CUDA
synchronize on cards), the slowest rank's.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device


def _finish(x: torch.Tensor, t0: float) -> float:
    """Seconds since t0 once `x` is computed on every rank, the slowest
    rank's."""
    done = x.float().sum().reshape(1)
    dist.all_reduce(done)
    if done.is_cuda:
        torch.cuda.synchronize()
    dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                      device=done.device)
    dist.all_reduce(dt, op=dist.ReduceOp.MAX)
    return float(dt)


def _detect_rank(rank, world, frames_per_device, shape, nfeatures, n_iters):
    from ..frontend.orb import OrbConfig
    from .frontend import batched_orb
    from .mesh import make_mesh, rank_device, shard_leading

    dev = rank_device()
    mesh = make_mesh(world, axis="frame", device=dev.type)
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.uniform(0, 255, (world * frames_per_device,)
                                         + tuple(shape)).astype(np.float32),
                             device=dev)
    local = shard_leading(mesh, "frame", frames)
    fn = batched_orb(mesh, OrbConfig(nfeatures=nfeatures, n_levels=4))
    _finish(fn(local).xs, time.perf_counter())  # warm-up
    t0 = time.perf_counter()
    for i in range(n_iters):
        out = fn(local + float(i))  # distinct inputs
    return _finish(out.xs, t0) / n_iters


def _step_rank(rank, world, shape, nfeatures, n_iters):
    from ..data.synthetic import SyntheticSequence
    from ..frontend.orb import OrbConfig
    from ..models.vo import TrackingVO, VOConfig
    from .mesh import make_mesh, rank_device
    from .vo_step import make_sharded_tracking_step, pad_capacity, shard_state

    dev = rank_device()
    mesh = make_mesh(world, axis="kp", device=dev.type)
    cfg = VOConfig(orb=OrbConfig(nfeatures=nfeatures, fast_threshold=20.0))
    seq = SyntheticSequence.generate(n_frames=3, shape=tuple(shape),
                                     n_points=4000)
    vo = TrackingVO(seq.K, cfg, device=dev)
    state = vo.init(seq.frame(0))
    state, _ = vo.step(state, seq.frame(1))
    img = vo._image(seq.frame(2))
    fn = make_sharded_tracking_step(mesh, cfg)
    state = shard_state(mesh, cfg, pad_capacity(cfg, state, world))
    state, out = fn(state, img, vo.K)  # warm-up
    _finish(out.pose, time.perf_counter())
    t0 = time.perf_counter()
    for i in range(n_iters):
        state, out = fn(state, img + float(i), vo.K)
    return _finish(out.pose, t0) / n_iters


def measure_detect_scaling(device_counts, frames_per_device: int = 2,
                           shape=(376, 1241), nfeatures: int = 1000,
                           n_iters: int = 10, device="cuda") -> list[dict]:
    """Batched ORB detect, `frames_per_device` frames per rank: frames/s
    and efficiency against the first count's frames/s per rank. NCCL ranks
    on the cards unless `device` is "cpu" (gloo)."""
    from .launch import spawn

    device = resolve_device(device).type
    rows, base = [], None
    for d in device_counts:
        dt = spawn(_detect_rank, d, (frames_per_device, tuple(shape),
                                     nfeatures, n_iters), device=device)[0]
        fps = d * frames_per_device / dt
        base = base or fps / d
        rows.append({"devices": d, "batch": d * frames_per_device,
                     "fps": round(fps, 2),
                     "efficiency": round(fps / (base * d), 3)})
    return rows


def measure_step_scaling(device_counts, shape=(376, 1241),
                         nfeatures: int = 3000, n_iters: int = 5,
                         device="cuda") -> list[dict]:
    """Strong scaling of the keypoint-sharded tracking step
    (parallel/vo_step.py): efficiency t1 / (d t_d). NCCL ranks on the
    cards unless `device` is "cpu" (gloo)."""
    from .launch import spawn

    device = resolve_device(device).type
    rows, t1 = [], None
    for d in device_counts:
        dt = spawn(_step_rank, d, (tuple(shape), nfeatures, n_iters),
                   device=device)[0]
        t1 = t1 or dt * d
        rows.append({"devices": d, "ms_per_step": round(dt * 1e3, 2),
                     "fps": round(1.0 / dt, 2),
                     "efficiency": round(t1 / (d * dt), 3)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", type=int, default=0,
                    help="run up to N gloo ranks on the CPU")
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="NCCL ranks, one per card: these counts (default: "
                         "powers of two up to the card count)")
    ap.add_argument("--shape", type=int, nargs=2, default=(376, 1241))
    ap.add_argument("--nfeatures", type=int, default=1000,
                    help="ORB features per frame, detect and step")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--step", action="store_true",
                    help="also measure the sharded tracking step")
    args = ap.parse_args(argv)
    if args.cpu:
        device, n = "cpu", args.cpu
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("scaling: no CUDA device; pass --cpu N to run "
                               "gloo ranks on the CPU")
        device, n = "cuda", torch.cuda.device_count()
    counts = (args.devices if args.devices and not args.cpu
              else [d for d in (1, 2, 4, 8, 16, 32) if d <= n])
    out = {"backend": "gloo" if device == "cpu" else "nccl",
           "device": "cpu" if device == "cpu"
           else torch.cuda.get_device_name(0),
           "detect": measure_detect_scaling(
               counts, shape=tuple(args.shape), nfeatures=args.nfeatures,
               n_iters=args.iters, device=device)}
    if args.step:
        out["fused_step"] = measure_step_scaling(
            counts, shape=tuple(args.shape), nfeatures=args.nfeatures,
            n_iters=args.iters, device=device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
