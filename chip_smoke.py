"""Drive the PyTorch/CUDA port (vo_tpu_torch) on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. build: nvcc compiles the four kernels (csrc/*.cu) for sm_90a, in
   parallel, and prints each compiled kernel's registers, stack frame and
   spills;
2. kernels: each kernel against its plain PyTorch version on the card, on
   the inputs the two tracking paths give it at KITTI shape (376x1241):
   B1 (LK level) at bf16 and f32 on all four levels of a tracking_orb step
   (2996 tracked points), and at 240x320, with an f64 run of the plain
   version as the witness of which points are rounding-sensitive; B2
   (separable blur) on the 1408x1280 Harris canvas plus an odd shape,
   asymmetric taps and the widest radius, and on every blur of
   tracking_sift's scale space (eight octaves, 752x2482 down to 6x20);
   B3 (window crop) bit for bit, both maps in one launch and one map at a
   time, on SIFT's orientation (S=37) and descriptor (S=79) window pairs,
   on an 8-aligned S=40 case from the Pallas kernel's own domain and on
   windows past every edge of the map; B4 (1-D correlation) bit for bit,
   both passes from one read and each axis alone, on the layer-flattened
   (7056, 2560) Gaussian canvas, and past the edge of a 6x20 plane. Each is
   timed with CUDA events beside its plain version and one PyTorch call
   that computes the same function, B1 also per level (with its mean
   iterations), B2 per SIFT octave (beside the octave's byte bound), B3
   per window size and B4 per entry point (each beside its byte bound);
3. pipelines: tracking_orb over a 60-frame synthetic KITTI-shape sequence
   whose frame 45 is textureless (forcing a re-detect), then tracking_sift,
   matching_orb, matching_sift, matching_orb_3d_correspond and
   tracking_sift_ba over the same sequence without the blank frame
   (tracking_sift's tracks decay below 150 and it re-detects on its own;
   the matching paths detect every frame and never re-detect;
   tracking_sift_ba solves its 5-frame window every 10 frames), each after
   a warm-up (through one BA solve for tracking_sift_ba) and with the
   launch counters zeroed just before and read just after; fps, ATE
   against its limit, re-detects, launches and median associations, and
   for tracking_sift_ba the BA runs, poses accepted and costs (on
   tracking_sift two B3 launches per B4 launch, on matching_sift one B4
   and two B3 per frame); SIFT detect time and window BA time per solve;
4. plain paths: tracking_orb's first 5 steps through the plain versions,
   each from the kernel path's state with the same RANSAC draws, beside
   the pose's own response to a 1e-4 px jitter of the tracked points, then
   5 free-running steps of each path; SIFT detect on frame 0 through the
   kernels and through the plain versions of B2, B3 and B4; matching_orb's
   first 3 steps through the plain B2, held as tracking_orb's;
5. entry points: the 60 frames written as a KITTI-layout directory of
   PNGs, decoded by the native decoder (bit-exact, every frame served by
   it), the CLI's tracking_orb on it (launch counters zeroed around it,
   ATE from the bundle's files), a run checkpointed every 20 frames,
   stopped at frame 41 and resumed, held to two uninterrupted runs, and
   `compare` on frame 0's PNG held to vo_tpu's report;
6. parallel: a 1-rank NCCL group (FileStore in a temporary directory, 60 s
   timeout, every section under a watchdog that ends the process) and the
   port's parallel/ on it: `ShardedTrackingVO` (tracking_orb's keypoint-
   sharded step, B1 on the shard, one all-gather a step) over the 60
   frames without the blank frame, its poses, n_assoc and n_inliers bit
   for bit against the dense tracking_orb on the same frames
   (`parallel_tracking_orb` in launches_by_path, B1 4 a step), timed
   beside it; `sharded_match_descriptors` on frames 0/1's 2996 ORB
   descriptors, `sharded_gaussian_blur` (B2) and `sharded_fast_score` on
   frame 0 (`parallel_blur_fast`) and `batched_orb` on frames 0 and 1
   (`parallel_batched_orb`), each bit for bit against the dense call;
   `sharded_window_ba` on the tracking_sift_ba window of phase 3, its
   landmark and hold-out counts equal to `run_window_ba`'s and its poses
   within 2e-3;
7. scan mode and B1 against its lane count: `run_vo_scan` on tracking_orb
   (blank frame), tracking_sift and matching_orb, each from the preset's
   own pipeline (tracking_orb's gate is async), bit-equal to `run_vo` with
   the sync gate in trajectory, scales and per-frame stats, with both fps;
   then B1 timed (CUDA events) on one tracking_orb step's work, the step
   into frame 40, at full capacity, at the live slots and on the same
   state cut to its first 1536, 768 and 192 live slots;
8. the eval: scripts/eval_torch_synthetic.py's run function on the first
   100 frames of its hard 1000-frame sequence (seed 0, 240x320, rendered
   once and staged on the card) for tracking_orb and tracking_sift_ba,
   launch counters zeroed around each run; each bundle has vo_tpu's files
   and metrics.json keys (results_tpu/) plus run.json, tracking_sift_ba
   re-detects in the dropout stretches and solves its window; ATE, RPE,
   re-detects, BA solves, poses accepted and seconds.

Output: the card's name and power limit first, a JSON line of per-kernel
results second to last, and {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

SHAPE = (376, 1241)  # KITTI odometry frames
N_FRAMES = 60
# A textureless frame in tracking_orb's sequence. The step INTO it keeps
# most LK tracks (templates are solvable, and on flat gray the solve
# converges in place), so that pose is garbage; the next step finds no
# texture, the survivors fall to 0 and the step after re-detects, as in
# vo_tpu (tests/test_torch_pipeline.py holds the two together step by step
# through such a frame).
BLANK = 45
ORB_ATE_LIMIT = 0.10
# vo_tpu's tracking_sift on the same 60 frames without the blank frame:
# ATE 12.18 % of the path, re-detects at every step from 46 on
# (scripts/eval_ref_tracking_sift.py, JAX on the CPU of an H100 host). The
# port is held to the larger of 10 % and 1.25x that.
SIFT_REF_ATE = 0.1218
SIFT_ATE_LIMIT = max(0.10, 1.25 * SIFT_REF_ATE)
# vo_tpu on the same 60 frames without the blank frame, RANSAC seed 0
# (scripts/eval_ref_matching.py, JAX on the CPU of an H100 host; seeds 1
# and 2 give 11.54 and 33.42 % for matching_orb, 18.77 and 14.52 % for
# matching_sift, 8.62 and 9.55 % for matching_orb_3d_correspond, 6.25 and
# 8.61 % for tracking_sift_ba). Each path is held to the larger of 10 % and
# 1.25x its figure, the rule of tracking_sift.
REF_ATE = {"matching_orb": 0.2451, "matching_sift": 0.0933,
           "matching_orb_3d_correspond": 0.1954, "tracking_sift_ba": 0.1248}
ATE_LIMIT = {k: max(0.10, 1.25 * v) for k, v in REF_ATE.items()}
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
EPS32 = float(np.finfo(np.float32).eps)


def _log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def ptxas_summary(out: str) -> list[str]:
    """One line per compiled kernel from nvcc's `-Xptxas -v` output: its
    (demangled) name, registers, stack frame and spills."""
    import re
    import shutil

    rows, name = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            rows.append([name, "", ""])
        elif name and "stack frame" in line:
            rows[-1][1] = line.split(":")[-1].strip()
        elif name and "Used" in line and "registers" in line:
            rows[-1][2] = line.split(":", 1)[-1].strip()
    if rows and shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(r[0] for r in rows),
            capture_output=True, text=True).stdout.split("\n")
        for r, n in zip(rows, names):
            r[0] = n or r[0]
    return [f"{n}: {frame}; {regs}" for n, frame, regs in rows]


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps back-to-back runs, by CUDA
    events. The device first spins for ~10 ms, so the host queues the runs
    ahead of it and the events time the device's work, not the host's
    launch rate (where queueing takes longer than that, as for the plain
    versions' thousands of small launches, they time both). The runs reuse
    their inputs, so an input that fits the 50 MB L2 may be read from it:
    B4's 72 MB canvas does not fit, and B3 is held by the windows it writes
    (333 MB at S=79), not by its reads of the maps."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_split(fn, kernel: str, reps: int = 10) -> str:
    """Device time per call of fn(), by torch.profiler: the named kernel's
    and the rest's (the wrapper's small tensor ops)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        return "not measured (the profiler saw no device time)"
    k = sum(e.device_time for e in ev if kernel in e.name) / reps / 1e3
    rest = sum(e.device_time for e in ev if kernel not in e.name) / reps / 1e3
    return f"{kernel} {k:.4f} ms, other kernels {rest:.4f} ms"


def _bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_mem = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_F32_FLOPS * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


class _Staged:
    """A synthetic sequence whose frames are already on the card."""

    def __init__(self, seq, device, frames=None):
        import torch

        self.poses = seq.poses
        self.K = seq.K
        self.frames = frames or [torch.from_numpy(seq.frame(i)).to(device)
                                 for i in range(len(seq))]

    def with_frame(self, i, img):
        """The same sequence with frame i replaced."""
        frames = list(self.frames)
        frames[i] = img
        return _Staged(self, None, frames)

    def __len__(self):
        return len(self.frames)

    def frame(self, i):
        return self.frames[i]


def _capture(module, name):
    """Patch module.name with a pass-through that records its arguments
    (keyword arguments after the positional ones, in call order)."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args + tuple(kwargs.values()))
        return real(*args, **kwargs)

    return mock.patch.object(module, name, spy), calls


# B1 against its plain version. Both compute in f32 but sum the 21x21
# patch in different orders (and the kernel contracts to FMA), so the
# comparison separates what rounding may move from what it may not, with
# an f64 run of the plain version (same working-type windows) as witness:
# - solvable counts only where `pre` holds (elsewhere the caller discards
#   it: the point is already lost, or its template is outside its window).
#   It compares min_eig = (tr - sqrt(tr^2 - 4 det)) / 2 with a threshold,
#   as vo_tpu does, and f32 rounding decides it in two bands: where the
#   f64 min_eig lies within npx * eps32 * tr of the threshold (a sum of
#   npx terms), and where G is nearly isotropic, (gxx - gyy)^2 + 4 gxy^2
#   <= 16 eps32 tr^2: there tr^2 - 4 det may round below zero, the square
#   root is NaN and the point is unsolvable. A flag may differ only inside
#   these bands;
# - endpoints: a point is rounding-sensitive where the f32 plain version
#   itself strays from f64 by over 1e-4 px (near-singular G: Gauss-Newton
#   amplifies rounding into another iteration path). Elsewhere the kernel
#   must agree to 1e-3 px, or to 2 eps (one convergence step) where its
#   iteration count differs, with p99 < 1e-4 px. The sensitive share, and
#   the share over 1e-3 px, are each bounded: on the main path's ORB
#   points by 0.5 % (readings <= 0.04 %). Random points, weak texture
#   included, reach a few %, and an unmarked point may reach 1e-3 px (one
#   f32 run can land near f64 by chance): tests/test_torch_cuda.py holds
#   them to wider limits.
LK_TOLERANCE = ("solvable (where pre) flips only inside the rounding "
                "bands, band share < 2 %; off the sensitive points |dv| < "
                "1e-3 px (same iterations) or < 2 eps (not) and p99 < 1e-4 "
                "px; sensitive share and share over 1e-3 px < 0.5 %")


def lk_stats(args, out, ref) -> dict:
    """Agreement of one level's kernel and plain results, with the f64
    plain run as witness of the rounding-sensitive points."""
    import torch

    from vo_tpu_torch.ops import lk_cuda

    img1, img2, q1, q20, flow, pre, org1, org2, S, config = args
    v, solv, its = out
    rv, rsolv, rits = ref
    dv, _, _ = lk_cuda.refine_level_reference(*args, dtype=torch.float64)
    npx = config.win * config.win
    w1 = lk_cuda.crop_windows(img1, org1[:, 0], org1[:, 1], S,
                              config.precision, torch.float64)
    _, _, _, (gxx, gxy, gyy) = lk_cuda.structure_tensor(w1, q1.double(),
                                                        config.win)
    tr = gxx + gyy
    disc2 = (gxx - gyy) ** 2 + 4 * gxy * gxy
    lmin, lmax = (tr - disc2.sqrt()) / 2, (tr + disc2.sqrt()) / 2
    margin = (lmin - config.min_eig_threshold * npx).abs() / (EPS32 * tr)
    isotropy = disc2 / (EPS32 * tr * tr)
    band = (margin <= npx) | (isotropy <= 16)
    flips = pre & (solv != rsolv)
    idle = ~pre & (solv != rsolv)

    both = pre & solv & rsolv
    d = (v - rv).abs().amax(dim=1).double()
    sensitive = both & ((rv.double() - dv).abs().amax(dim=1) > 1e-4)
    rest = both & ~sensitive
    same = rest & (its == rits)
    cond = lmax / lmin.clamp_min(1e-30)
    tail = both & (d > 1e-3)
    dr = d[rest]
    n = max(int(both.sum()), 1)

    def mx(m):
        return d[m].max().item() if bool(m.any()) else 0.0

    def med(x, m):
        return x[m].median().item() if bool(m.any()) else float("nan")

    return {
        "agree": 1.0 - flips.double().sum().item() / max(int(pre.sum()), 1),
        "flips": int(flips.sum()),
        "flips_where_discarded": int(idle.sum()),
        "flips_outside_band": int((flips & ~band).sum()),
        "flips_min_eig_band": int((flips & (margin <= npx)).sum()),
        "flips_isotropic_band": int((flips & (isotropy <= 16)).sum()),
        "max_flip_isotropy": isotropy[flips].max().item()
        if bool(flips.any()) else 0.0,
        "band_share": band[pre].double().mean().item()
        if bool(pre.any()) else 0.0,
        "isotropic_share": (isotropy <= 16)[pre].double().mean().item()
        if bool(pre.any()) else 0.0,
        "points": int(both.sum()),
        "p50": dr.quantile(0.5).item() if dr.numel() else 0.0,
        "p99": dr.quantile(0.99).item() if dr.numel() else 0.0,
        "max": mx(both),
        "max_rest_same_iters": mx(same),
        "max_rest_other_iters": mx(rest & ~same),
        "iters_differ": int((both & (its != rits)).sum()),
        "sensitive_share": int(sensitive.sum()) / n,
        "over_1e-3": int(tail.sum()) / n,
        "tail_in_sensitive": int((tail & sensitive).sum()),
        "cond_median_all": med(cond, both),
        "cond_median_tail": med(cond, tail),
        "plain_vs_f64_max": (rv.double() - dv).abs().amax(dim=1)[both].max()
        .item() if bool(both.any()) else 0.0,
    }


def lk_within(st: dict, eps: float, max_share: float = 0.005,
              max_band: float = 0.02, max_rest: float = 1e-3) -> bool:
    return (st["flips_outside_band"] == 0 and st["band_share"] < max_band
            and st["max_rest_same_iters"] < max_rest
            and st["max_rest_other_iters"] < 2 * eps and st["p99"] < 1e-4
            and st["sensitive_share"] < max_share
            and st["over_1e-3"] < max_share)


def lk_flops(win: int, n_points: int, n_iters: int) -> float:
    """Operations the LK level needs: per point, (win+2)^2 bilinear samples
    (7 flops each: 4 products and 3 sums, the 4 weights shared by the
    patch), then per template pixel 2 differences, 2 halvings and the 3
    products and 3 sums of G; per iteration and pixel one sample, the
    residual, and 2 products and 2 sums for b."""
    wp = win + 2
    return (n_points * (7 * wp * wp + 10 * win * win)
            + n_iters * 12 * win * win)


def check_lk(seqs, device) -> dict:
    """B1 against its plain version at both precisions on every level, on
    the main path's inputs (and at 240x320); times the KITTI-shape bf16
    levels."""
    import torch

    from vo_tpu_torch.models.vo import TrackingVO
    from vo_tpu_torch.ops import lk_cuda
    from vo_tpu_torch.ops.lk import LKConfig
    from vo_tpu_torch.runtime.presets import get_preset

    base = get_preset("tracking_orb").config
    worst, ms, plain_ms, n_bytes, n_flops = 0.0, 0.0, 0.0, 0.0, 0.0
    failed, timed, levels = [], [], []
    for seq_name, seq in seqs:
        for precision in ("bf16", "f32"):
            cfg = base._replace(lk=LKConfig(precision=precision))
            vo = TrackingVO(seq.K, cfg, device=device)
            patch, calls = _capture(lk_cuda, "refine_level")
            with patch:
                vo.step(vo.init(seq.frame(0)), seq.frame(1))
            torch.cuda.synchronize()
            if len(calls) != 4:
                raise RuntimeError(
                    f"expected 4 LK levels, captured {len(calls)}")
            for level, args in zip((3, 2, 1, 0), calls):
                out = lk_cuda.refine_level(*args)
                ref = lk_cuda.refine_level_reference(*args)
                torch.cuda.synchronize()
                pre, its = args[5], out[2]
                st = lk_stats(args, out, ref)
                _log(f"B1 {seq_name} {precision} level {level}: "
                     f"N={int(pre.shape[0])} S={args[8]} {st}, mean iters "
                     f"{its.float().mean().item():.2f} (plain "
                     f"{ref[2].float().mean().item():.2f}); tolerance: "
                     f"{LK_TOLERANCE}")
                if not lk_within(st, cfg.lk.eps):
                    failed.append(f"{seq_name} {precision} level {level}")
                worst = max(worst, st["max"])
                if seq_name == "kitti" and precision == "bf16":
                    timed.append(args)
                    lvl_ms = _time_ms(lambda: lk_cuda.refine_level(*args), 20)
                    plain_ms += _time_ms(
                        lambda: lk_cuda.refine_level_reference(*args), 3)
                    img1, img2 = args[0], args[1]
                    # images read once; per point 5 (N, 2) f32 inputs and
                    # pre in, v, solvable and iterations out
                    lvl_bytes = (img1.numel() * img1.element_size()
                                 + img2.numel() * img2.element_size()
                                 + pre.numel() * (5 * 8 + 1 + 8 + 1 + 4))
                    lvl_flops = lk_flops(cfg.lk.win, int(pre.sum()),
                                         int(its.sum()))
                    lvl_bound, _ = _bound_ms(lvl_bytes, lvl_flops)
                    levels.append({
                        "level": level, "S": args[8], "N": int(pre.shape[0]),
                        "refined": int(pre.sum()),
                        "mean_iters": its[pre].float().mean().item()
                        if bool(pre.any()) else 0.0,
                        "max_iters": int(its.max()) if its.numel() else 0,
                        "ms": lvl_ms, "bound_ms": lvl_bound})
                    _log(f"B1 level {level} time: {levels[-1]}")
                    ms += lvl_ms
                    n_bytes += lvl_bytes
                    n_flops += lvl_flops
    if failed:
        raise RuntimeError(f"B1 disagrees with its plain version: {failed}")
    bound, by = _bound_ms(n_bytes, n_flops)
    _log(f"B1 timing (bf16, 4 levels of one step): kernel {ms:.4f} ms, "
         f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
         f"{n_flops:.4g} flops, {n_bytes:.4g} bytes)")
    split = _device_split(
        lambda: [lk_cuda.refine_level(*a) for a in timed], "lk_refine_kernel")
    _log(f"B1 device time by profiler (4 levels of one step): {split}")
    return {
        "name": "lk_refine", "route": "cuda",
        "source": "vo_tpu_torch/csrc/lk_refine.cu",
        "replaces": "vo_tpu/ops/lk_pallas.py:157",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "levels": levels,
    }


def check_blur(seq, device) -> dict:
    """B2 against its plain version on the Harris canvas and edge cases."""
    import torch
    import torch.nn.functional as F

    from vo_tpu_torch.ops import blur_cuda
    from vo_tpu_torch.ops.conv import gaussian_kernel_1d
    from vo_tpu_torch.runtime.presets import get_preset

    vo = get_preset("tracking_orb").build(seq.K, device=device)
    patch, calls = _capture(blur_cuda, "separable_blur")
    with patch:
        vo.detect(seq.frame(0))
    torch.cuda.synchronize()
    if len(calls) != 1:
        raise RuntimeError(f"expected 1 blur per detect, got {len(calls)}")
    img, ky, kx = calls[0]
    _log(f"B2 main-path input {tuple(img.shape)} {img.dtype}, "
         f"{len(ky)}x{len(kx)} taps")

    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=device) * 255.0

    cases = [
        ("harris canvas", img, ky, kx, 1e-5 * img.abs().max().item()),
        ("odd shape", rand((2, 377, 1243)), ky, kx, 2e-3),
        ("asymmetric taps", rand((1, 240, 320)), gaussian_kernel_1d(5, 1.0),
         gaussian_kernel_1d(9, 2.0), 2e-3),
        ("radius 64", rand((1, 200, 300)), gaussian_kernel_1d(129, 20.0),
         gaussian_kernel_1d(129, 20.0), 5e-3),
    ]
    worst = 0.0
    for name, x, cy, cx, tol in cases:
        out = blur_cuda.separable_blur(x, cy, cx)
        ref = blur_cuda.separable_blur_reference(x, cy, cx)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        _log(f"B2 {name} {tuple(x.shape)}: max |err| {err:.3e}, "
             f"tolerance {tol:.3e}")
        if not err <= tol:
            raise RuntimeError(f"B2 {name} disagrees")
        if name == "harris canvas":
            worst = err

    ms = _time_ms(lambda: blur_cuda.separable_blur(img, ky, kx), 50)
    plain_ms = _time_ms(
        lambda: blur_cuda.separable_blur_reference(img, ky, kx), 10)
    wy = torch.tensor(np.asarray(ky, np.float32), device=device)
    wx = torch.tensor(np.asarray(kx, np.float32), device=device)
    ry, rx = len(ky) // 2, len(kx) // 2
    B, H, W = img.shape
    x4 = img.reshape(B, 1, H, W)

    def library():  # cuDNN, TF32 off (vo_tpu_torch sets it at import)
        t = F.conv2d(F.pad(x4, (rx, rx, 0, 0), mode="reflect"),
                     wx.reshape(1, 1, 1, -1))
        return F.conv2d(F.pad(t, (0, 0, ry, ry), mode="reflect"),
                        wy.reshape(1, 1, -1, 1))

    lib_err = (library().reshape(img.shape)
               - blur_cuda.separable_blur(img, ky, kx)).abs().max().item()
    library_ms = _time_ms(library, 50)
    _log(f"B2 timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
         f"F.conv2d x2 {library_ms:.4f} ms (max |diff| {lib_err:.3e})")
    n_bytes = 2 * img.numel() * 4
    n_flops = img.numel() * 2 * (len(ky) + len(kx))
    bound, by = _bound_ms(n_bytes, n_flops)
    _log(f"B2 bound {bound:.4f} ms ({by})")
    return {
        "name": "separable_blur", "route": "cuda",
        "source": "vo_tpu_torch/csrc/separable_blur.cu",
        "replaces": "vo_tpu/ops/pallas_blur.py:59",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
    }


def _kernel_modules() -> dict:
    """Each kernel's wrapper module, whose `launches` counts its launches."""
    from vo_tpu_torch.ops import blur_cuda, crop_cuda, lk_cuda, rowconv_cuda

    return {"lk_refine": lk_cuda, "separable_blur": blur_cuda,
            "crop_windows": crop_cuda, "row_conv": rowconv_cuda}


def run_pipeline(name, seq, device, ate_limit, kernels, note,
                 redetects: bool = True, warm_steps: int = 3) -> dict:
    """One preset end to end after a warm-up of `warm_steps` steps; returns
    the launch counts of the measured run (counters zeroed just before,
    read just after). A path that must re-detect (`redetects`) fails
    without one; the matching paths detect every frame and have none."""
    import torch

    from vo_tpu_torch.runtime.presets import get_preset
    from vo_tpu_torch.utils.metrics import compute_ate, compute_rpe

    preset = get_preset(name)
    warm = preset.build(seq.K)  # default device: cuda
    state = warm.init(seq.frame(0))
    for i in range(1, warm_steps + 1):
        state, _ = warm.step(state, seq.frame(i))
    torch.cuda.synchronize()

    vo = preset.build(seq.K)
    modules = _kernel_modules()
    for m in modules.values():
        m.launches = 0
    t0 = time.perf_counter()
    est, gt, _, stats = preset.run(seq, vo)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: m.launches for k, m in modules.items()}

    n_steps = len(seq) - 1
    ate, _ = compute_ate(gt, est)
    rpe, _ = compute_rpe(gt, est)
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    redetected = [i for i, s in enumerate(stats) if s.get("fallback")]
    _log(f"pipeline {name} {SHAPE[0]}x{SHAPE[1]}, {len(seq)} frames, "
         f"{note}: {n_steps / dt:.2f} fps (host clock over init + {n_steps} "
         f"steps, closed by synchronize), ATE {ate:.4f} on a {path:.2f} path "
         f"({100 * ate / path:.2f} %, limit {100 * ate_limit:.2f} %), RPE "
         f"{rpe:.4f}, re-detects at steps {redetected}, launches {counts}, "
         f"median n_assoc {int(np.median([s['n_assoc'] for s in stats[1:]]))}")
    ba = [(i, s) for i, s in enumerate(stats) if s.get("ba_ran")]
    if preset.window is not None:
        _log(f"pipeline {name} BA: {len(ba)} runs at steps "
             f"{[i for i, _ in ba]}, poses accepted "
             f"{[s['ba_accepted'] for _, s in ba]}, cost0 -> cost "
             f"{[(round(s['ba_cost0'], 1), round(s['ba_cost'], 1)) for _, s in ba]}"
             f", landmarks {[s['ba_landmarks'] for _, s in ba]}")
        if not ba or not any(s["ba_accepted"] for _, s in ba):
            raise RuntimeError(f"{name}: BA ran {len(ba)} times and "
                               f"accepted no pose")
    if not np.isfinite(est).all():
        raise RuntimeError(f"{name}: non-finite trajectory")
    if redetects and not redetected:
        raise RuntimeError(f"{name}: no re-detect")
    if ate >= ate_limit * path:
        raise RuntimeError(f"{name}: ATE {ate:.4f} >= {ate_limit:.4f} of "
                           f"path {path:.2f}")
    if min(counts[k] for k in kernels) <= 0:
        raise RuntimeError(f"{name}: a kernel was not launched: {counts}")
    return counts


def time_window_ba(seq, device, reps: int = 5) -> tuple:
    """Host milliseconds per windowed BA solve of tracking_sift_ba at
    KITTI shape (each call closed by synchronize), on the window of its
    first BA step, after one warm-up call. Returns that solve's arguments
    (window, K, WindowConfig, map)."""
    import torch

    from vo_tpu_torch.models import vo_ba
    from vo_tpu_torch.runtime.presets import get_preset

    preset = get_preset("tracking_sift_ba")
    vo = preset.build(seq.K, device=device)
    spy, calls = _capture(vo_ba, "run_window_ba")
    state = vo.init(seq.frame(0))
    with spy:
        for i in range(1, preset.window.ba_every + 1):
            state, out = vo.step(state, seq.frame(i))
    if len(calls) != 1:
        raise RuntimeError(f"expected one BA solve, captured {len(calls)}")
    win, K, wcfg, lmap = calls[0]
    vo_ba.run_window_ba(win, K, wcfg, lmap=lmap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        vo_ba.run_window_ba(win, K, wcfg, lmap=lmap)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        vo_ba.run_window_ba(win, K, wcfg, lmap=lmap)
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time for e in ev) / 1e3
    _log(f"window BA (tracking_sift_ba, window {win.obs.shape[0]} x "
         f"{win.obs.shape[1]} slots, {int(out.ba_landmarks)} landmarks, "
         f"{wcfg.ba.max_iters} LM steps): {ms:.1f} ms per solve (host "
         f"clock, synchronized); by torch.profiler {len(ev)} device "
         f"operations, {dev_ms:.2f} ms of device time per solve")
    return calls[0]


def time_sift_detect(seq, device, reps: int = 5) -> None:
    """Host milliseconds per tracking_sift detect at KITTI shape (each call
    closed by synchronize), after one warm-up call."""
    import torch

    from vo_tpu_torch.runtime.presets import get_preset

    vo = get_preset("tracking_sift").build(seq.K, device=device)
    vo.detect(seq.frame(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        vo.detect(seq.frame(i))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    n = int(vo.detect(seq.frame(0))[2].sum())
    _log(f"SIFT detect (tracking_sift, {SHAPE[0]}x{SHAPE[1]}, nfeatures "
         f"3000): {ms:.1f} ms per frame (host clock, synchronized), {n} "
         f"keypoints on frame 0")


def capture_sift(seq, device) -> dict:
    """The calls of B2, B3 and B4, with their arguments, in one
    tracking_sift detect of frame 0 (B3's and B4's single-map and
    single-axis entry points too, which the detect must not call)."""
    import contextlib

    import torch

    from vo_tpu_torch.runtime.presets import get_preset

    mods = _kernel_modules()
    vo = get_preset("tracking_sift").build(seq.K, device=device)
    spies = {n: _capture(mods[m], n) for n, m in (
        ("separable_blur", "separable_blur"),
        ("crop_windows_pair", "crop_windows"), ("crop_windows", "crop_windows"),
        ("conv_rows_cols", "row_conv"), ("conv_rows", "row_conv"),
        ("conv_cols", "row_conv"))}
    with contextlib.ExitStack() as stack:
        for patch, _ in spies.values():
            stack.enter_context(patch)
        vo.detect(seq.frame(0))
    torch.cuda.synchronize()
    calls = {n: c for n, (_, c) in spies.items()}
    stray = {n: len(calls[n]) for n in ("crop_windows", "conv_rows",
                                        "conv_cols") if calls[n]}
    if stray:
        raise RuntimeError(f"SIFT detect took single-map/single-axis entry "
                           f"points: {stray}")
    return calls


def _sum_ms(fns, reps: int) -> float:
    return sum(_time_ms(f, reps) for f in fns)


def check_sift_blurs(calls) -> dict:
    """B2 against its plain version on every blur of SIFT's scale space
    (0..255 images), and its time over all of them and per octave."""
    import torch
    import torch.nn.functional as F

    from vo_tpu_torch.ops import blur_cuda

    worst, shapes = 0.0, []
    for img, ky, kx in calls:
        err = (blur_cuda.separable_blur(img, ky, kx)
               - blur_cuda.separable_blur_reference(img, ky, kx)
               ).abs().max().item()
        worst = max(worst, err)
        shapes.append((tuple(img.shape[-2:]), len(ky)))
    torch.cuda.synchronize()
    small = [f"{h}x{w} ({k} taps)" for (h, w), k in shapes if h <= 12]
    _log(f"B2 on {len(calls)} SIFT scale-space blurs ({shapes[0][0]} down to "
         f"{shapes[-1][0]}; past the edge: {small}): max |err| {worst:.3e}, "
         f"tolerance 2.000e-03 (0..255 images)")
    if not worst <= 2e-3:
        raise RuntimeError("B2 disagrees on the SIFT blurs")

    def library(img, ky, kx):  # cuDNN, TF32 off
        wy = torch.tensor(np.asarray(ky, np.float32), device=img.device)
        wx = torch.tensor(np.asarray(kx, np.float32), device=img.device)
        ry, rx = len(ky) // 2, len(kx) // 2
        x4 = img.reshape(-1, 1, *img.shape[-2:])
        return lambda: F.conv2d(F.pad(F.conv2d(
            F.pad(x4, (rx, rx, 0, 0), mode="reflect"),
            wx.reshape(1, 1, 1, -1)), (0, 0, ry, ry), mode="reflect"),
            wy.reshape(1, 1, -1, 1))

    # F.pad's reflect needs the pad below the axis length
    fit = [c for c in calls if len(c[1]) // 2 < c[0].shape[-2]]
    each = [_time_ms(lambda c=c: blur_cuda.separable_blur(*c), 20)
            for c in calls]
    ms = sum(each)
    plain_ms = _sum_ms([lambda c=c: blur_cuda.separable_blur_reference(*c)
                        for c in calls], 3)
    library_ms = _sum_ms([library(*c) for c in fit], 20)
    n_bytes = sum(2 * c[0].numel() * 4 for c in calls)
    n_flops = sum(c[0].numel() * 2 * (len(c[1]) + len(c[2])) for c in calls)
    bound, by = _bound_ms(n_bytes, n_flops)
    _log(f"B2 timing over the {len(calls)} SIFT blurs of one detect: kernel "
         f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.conv2d x2 {library_ms:.4f}"
         f" ms (the {len(fit)} blurs whose pad fits F.pad), bound "
         f"{bound:.4f} ms ({by})")
    octaves = []  # the blurs of one plane shape, in order: one octave each
    for (hw, k), t, c in zip(shapes, each, calls):
        if not octaves or octaves[-1]["shape"] != list(hw):
            octaves.append({"octave": len(octaves), "shape": list(hw),
                            "taps": [], "ms": 0.0, "bound_ms": 0.0})
        o = octaves[-1]
        o["taps"].append(k)
        o["ms"] += t
        o["bound_ms"] += _bound_ms(2 * c[0].numel() * 4, 0.0)[0]
    for o in octaves:
        _log(f"B2 SIFT octave {o['octave']} {o['shape'][0]}x{o['shape'][1]}, "
             f"{len(o['taps'])} blurs of {o['taps']} taps: kernel "
             f"{o['ms']:.4f} ms, bytes bound {o['bound_ms']:.4f} ms")
    return {"sift_blurs_ms": ms, "sift_blurs_plain_ms": plain_ms,
            "sift_blurs_library_ms": library_ms, "sift_blurs_bound_ms": bound,
            "sift_blurs_max_abs_err": worst, "octaves": octaves}


def _crop_flat_index(img, ox, oy, S):
    """Each window sample's index into the flattened image, H * W for the
    samples outside it."""
    import torch

    from vo_tpu_torch.ops.crop_cuda import window_indices

    H, W = img.shape
    rows, cols, inside = window_indices(H, W, ox, oy, S)
    return torch.where(inside, rows[:, :, None] * W + cols[:, None, :], H * W)


def _crop_library(maps, ox, oy, S):
    """One advanced-indexing call on precomputed indices into the stacked
    flattened maps, each with a trailing zero (the value of every sample
    outside it)."""
    import torch

    idx = _crop_flat_index(maps[0], ox, oy, S)
    flat = torch.stack([torch.cat([m.reshape(-1), m.new_zeros(1)])
                        for m in maps])
    return lambda: flat[:, idx]


def _crop_bytes(img, ox, oy, S, maps: int) -> tuple[int, int]:
    """Device bytes one crop call over `maps` maps of img's shape must
    move: per map the distinct pixels its windows cover, read once
    (windows overlap, and a secondary orientation peak repeats its
    keypoint's window), and every window sample written once; the origins
    read once. Returns (bytes, distinct pixels per map)."""
    import torch

    H, W = img.shape
    covered = torch.zeros(H * W + 1, dtype=torch.bool, device=img.device)
    covered[_crop_flat_index(img, ox, oy, S)] = True
    pixels = int(covered[:H * W].sum())
    n = ox.shape[0]
    return maps * (4 * pixels + 4 * n * S * S) + 8 * n, pixels


def check_crop(calls, device) -> dict:
    """B3 bit for bit against its plain versions, both maps in one launch
    and one map at a time, on SIFT's window pairs, an 8-aligned S=40 case
    and windows past every edge; timed per window size over the pair calls
    of one detect."""
    import torch

    from vo_tpu_torch.ops import crop_cuda

    got = [(tuple(c[0].shape), int(c[2].shape[0]), c[4]) for c in calls]
    _log(f"B3 main-path calls (map shape, N, S): {got}")
    if [g[2] for g in got] != [37, 79]:
        raise RuntimeError(f"unexpected SIFT crop pairs {got}")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    a, b = calls[0][0], calls[0][1]
    H, W = a.shape
    n, S = 3476, 40
    ox = torch.randint(0, W - S + 1, (n,), generator=gen, device=device)
    oy = torch.randint(0, (H - S) // 8 + 1, (n,), generator=gen,
                       device=device) * 8
    ex = torch.randint(-79, W, (6666,), generator=gen, device=device)
    ey = torch.randint(-79, H, (6666,), generator=gen, device=device)
    cases = [(f"SIFT S={c[4]} N={int(c[2].shape[0])}", c) for c in calls]
    cases += [("8-aligned S=40 N=3476", (a, b, ox, oy, S)),
              ("past every edge S=79 N=6666", (a, b, ex, ey, 79))]
    for name, c in cases:
        pair = crop_cuda.crop_windows_pair(*c)
        ref = crop_cuda.crop_windows_pair_reference(*c)
        one = [crop_cuda.crop_windows(m, *c[2:]) for m in c[:2]]
        lib = _crop_library(c[:2], *c[2:])()
        torch.cuda.synchronize()
        eq = {"pair": torch.equal(pair, ref),
              "single": all(torch.equal(o, r) for o, r in zip(one, ref)),
              "indexing call": torch.equal(pair, lib)}
        outside = int((c[3][:, None] + torch.arange(c[4], device=device)
                       < 0).any(1).sum())
        _log(f"B3 {name}: bit-equal to plain {eq}; windows reaching above "
             f"the map: {outside}; tolerance: bit for bit")
        if not all(eq.values()):
            raise RuntimeError(f"B3 {name} disagrees")
    sizes = []
    for c in calls:
        img, S_, N = c[0], c[4], int(c[2].shape[0])
        n_bytes, pixels = _crop_bytes(img, c[2], c[3], S_, 2)
        bound, by = _bound_ms(n_bytes, 0.0)
        # what the card takes to write the same bytes and nothing else
        blank = torch.empty((2, N, S_, S_), device=device)
        sizes.append({
            "S": S_, "N": N,
            "ms": _time_ms(lambda c=c: crop_cuda.crop_windows_pair(*c), 20),
            "single_ms": _time_ms(lambda c=c: [
                crop_cuda.crop_windows(m, *c[2:]) for m in c[:2]], 20),
            "plain_ms": _time_ms(
                lambda c=c: crop_cuda.crop_windows_pair_reference(*c), 5),
            "library_ms": _time_ms(_crop_library(c[:2], *c[2:]), 20),
            "zero_ms": _time_ms(blank.zero_, 20),
            "bound_ms": bound, "bound_by": by, "bytes": n_bytes,
            "written": 2 * 4 * N * S_ * S_})
        _log(f"B3 S={S_} N={N} (both maps): pair {sizes[-1]['ms']:.4f} ms, "
             f"two single-map calls {sizes[-1]['single_ms']:.4f} ms, plain "
             f"{sizes[-1]['plain_ms']:.4f} ms, indexing "
             f"{sizes[-1]['library_ms']:.4f} ms, zero_ of the windows "
             f"{sizes[-1]['zero_ms']:.4f} ms, bound {bound:.4f} ms ({by}: "
             f"{n_bytes:.4g} bytes, {sizes[-1]['written']:.4g} of them "
             f"written; {pixels} of {img.numel()} pixels covered per map)")
    out = {k: sum(z[k] for z in sizes)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    _log(f"B3 timing (the {len(calls)} pair calls of one SIFT detect): "
         f"kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
         f"indexing {out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} "
         f"ms (bytes)")
    return {"name": "crop_windows", "route": "cuda",
            "source": "vo_tpu_torch/csrc/crop_windows.cu",
            "replaces": "vo_tpu/ops/pallas_crop.py:46", "max_abs_err": 0.0,
            **out, "bound_by": "bytes", "sizes": sizes}


def _conv_library(x, taps, mode: str):
    """One nn.Conv2d call with reflect padding (TF32 off: vo_tpu_torch sets
    it): a (1, 3) or (3, 1) kernel for one axis, for both a 3x3 kernel with
    two output channels (the row taps in the middle row of one, the column
    taps in the middle column of the other)."""
    import torch

    t = torch.tensor(taps, dtype=torch.float32)
    r = len(taps) // 2
    k = 2 * r + 1
    if mode == "rows":
        w, pad = t.reshape(1, 1, 1, k), (0, r)
    elif mode == "cols":
        w, pad = t.reshape(1, 1, k, 1), (r, 0)
    else:
        w = torch.zeros(2, 1, k, k)
        w[0, 0, r, :] = t
        w[1, 0, :, r] = t
        pad = (r, r)
    conv = torch.nn.Conv2d(1, w.shape[0], tuple(w.shape[2:]), padding=pad,
                           padding_mode="reflect", bias=False).to(x.device)
    conv.weight.requires_grad_(False)
    conv.weight.copy_(w)
    x4 = x[None, None]
    return lambda: conv(x4)


def check_rowconv(calls, device) -> dict:
    """B4 bit for bit against its plain versions, both passes from one read
    and each axis alone, on the layer-flattened Gaussian canvas and past
    the edge of a 6x20 plane; timed per entry point on the canvas."""
    import torch

    from vo_tpu_torch.ops import rowconv_cuda
    from vo_tpu_torch.ops.conv import gaussian_kernel_1d

    if len(calls) != 1:
        raise RuntimeError(f"expected 1 gradient pass per detect, got "
                           f"{len(calls)}")
    (flat, taps), = calls
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    small = torch.rand((6, 20), generator=gen, device=device) * 255.0
    wide = tuple(gaussian_kernel_1d(25, 3.09))
    nine = tuple(gaussian_kernel_1d(9, 1.5))
    entry = {
        "pair": (rowconv_cuda.conv_rows_cols,
                 rowconv_cuda.conv_rows_cols_reference),
        "rows": (rowconv_cuda.conv_rows,
                 lambda x, t: rowconv_cuda.conv_reference(x, t, False)),
        "cols": (rowconv_cuda.conv_cols,
                 lambda x, t: rowconv_cuda.conv_reference(x, t, True)),
    }
    cases = [("pair", flat, taps), ("rows", flat, taps), ("cols", flat, taps),
             ("pair", small, taps), ("pair", small, nine),
             ("rows", small, wide), ("cols", small, wide)]
    worst = 0.0
    for mode, x, t in cases:
        fn, ref_fn = entry[mode]
        out, ref = fn(x, t), ref_fn(x, t)
        torch.cuda.synchronize()
        outs = out if mode == "pair" else (out,)
        refs = ref if mode == "pair" else (ref,)
        err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
        eq = all(torch.equal(o, r) for o, r in zip(outs, refs))
        _log(f"B4 {mode} {tuple(x.shape)}, {len(t)} taps: bit-equal to plain "
             f"{eq} (max |err| {err:.3e}); tolerance: bit for bit")
        if not eq:
            raise RuntimeError(f"B4 {mode} {tuple(x.shape)} disagrees")
        if x is flat:
            worst = max(worst, err)
            lib = _conv_library(x, t, mode)()[0]
            lib_err = max((lib[i] - o).abs().max().item()
                          for i, o in enumerate(outs))
            _log(f"B4 {mode}: nn.Conv2d differs by {lib_err:.3e}")
    nz = sum(1 for v in taps if v)
    px = flat.numel()
    entries = {}
    for mode, (fn, ref_fn) in entry.items():
        passes = 2 if mode == "pair" else 1
        # the input read once, each output written once; per pixel and
        # pass one product per nonzero tap and the sums between them
        bound, by = _bound_ms((1 + passes) * px * 4, passes * px * (2 * nz - 1))
        entries[mode] = {
            "ms": _time_ms(lambda fn=fn: fn(flat, taps), 20),
            "plain_ms": _time_ms(lambda f=ref_fn: f(flat, taps), 5),
            "library_ms": _time_ms(_conv_library(flat, taps, mode), 20),
            "bound_ms": bound, "bound_by": by}
        e = entries[mode]
        _log(f"B4 timing, {mode} over {tuple(flat.shape)}: kernel "
             f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, nn.Conv2d "
             f"{e['library_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
    return {"name": "row_conv", "route": "cuda",
            "source": "vo_tpu_torch/csrc/row_conv.cu",
            "replaces": "vo_tpu/ops/pallas_conv.py:39", "max_abs_err": worst,
            **entries["pair"], "entry_points": entries}


# SIFT through the kernels against SIFT through the plain versions, as the
# CPU tests hold the port against vo_tpu (tests/test_torch_sift.py): of the
# plain path's keypoints, >= 98 % within 0.01 px, and of those >= 98 % with
# the angle within 1e-3 rad and the descriptor within relative L2 1e-3.
SIFT_TOLERANCE = {"found": 0.98, "same": 0.98, "angle": 1e-3, "desc": 1e-3}


def compare_sift_plain(seq, device) -> None:
    """SIFT detect on frame 0 through B2, B3 and B4 and through their plain
    versions."""
    import torch

    from vo_tpu_torch.frontend.sift import sift_detect_and_compute, sift_pairs
    from vo_tpu_torch.ops import blur_cuda, crop_cuda, rowconv_cuda
    from vo_tpu_torch.runtime.presets import get_preset

    cfg = get_preset("tracking_sift").config.sift
    img = seq.frame(0)

    def numpy(f):
        return type(f)(*(t.cpu().numpy() for t in f))

    kern = numpy(sift_detect_and_compute(img, cfg))
    with mock.patch.object(blur_cuda, "separable_blur",
                           blur_cuda.separable_blur_reference), \
            mock.patch.object(crop_cuda, "crop_windows_pair",
                              crop_cuda.crop_windows_pair_reference), \
            mock.patch.object(rowconv_cuda, "conv_rows_cols",
                              rowconv_cuda.conv_rows_cols_reference):
        plain = numpy(sift_detect_and_compute(img, cfg))
    torch.cuda.synchronize()
    found, dang, rel = sift_pairs(plain, kern)
    same = (dang[found] < SIFT_TOLERANCE["angle"]) & (
        rel[found] < SIFT_TOLERANCE["desc"])
    _log(f"SIFT kernel path vs plain path on frame 0: {int(kern.valid.sum())}"
         f" vs {int(plain.valid.sum())} keypoints, {found.mean():.4f} within "
         f"0.01 px, of those {same.mean():.4f} with angle and descriptor "
         f"within tolerance (max angle gap {dang[found].max():.2e} rad, max "
         f"descriptor gap {rel[found].max():.2e}); tolerance: "
         f"{SIFT_TOLERANCE}")
    if not (found.mean() >= SIFT_TOLERANCE["found"]
            and same.mean() >= SIFT_TOLERANCE["same"]):
        raise RuntimeError("SIFT kernel and plain paths disagree")


def _rel(P0: np.ndarray, P1: np.ndarray) -> np.ndarray:
    return np.linalg.inv(P0.astype(np.float64)) @ P1.astype(np.float64)


def _pose_gap(A: np.ndarray, B: np.ndarray) -> dict:
    """Rotation angle, translation-direction angle (deg), length ratio
    B/A and max |A - B| of two step transforms (angles in forms that
    stay accurate when small)."""
    dR = A[:3, :3].T @ B[:3, :3] - np.eye(3)
    rot = 2.0 * np.arcsin(min(np.linalg.norm(dR) / (2.0 * np.sqrt(2.0)),
                              1.0))
    ta, tb = A[:3, 3], B[:3, 3]
    na, nb = np.linalg.norm(ta), np.linalg.norm(tb)
    sin_t = np.linalg.norm(np.cross(ta, tb))
    return {"rot": float(np.degrees(rot)),
            "dir": float(np.degrees(np.arctan2(sin_t, ta @ tb))),
            "len": float(nb / max(na, 1e-30)),
            "max": float(np.abs(A - B).max())}


# Kernel path against plain path, per step. On these frames the pose
# moves by up to 0.1 deg of rotation, 3.5 deg of translation direction and
# 8 % of step length when the tracked points move by 1e-4 px (the jitter
# witness below; measured on an H100), well above the two paths' point
# differences (~1e-6 px, rare tails of ~5e-3 px): the winner of 256
# RANSAC hypotheses and the scale, the upper median of ~2,800 distance
# ratios of a cloud whose far points have sub-pixel parallax, both move
# with them. The limits sit above the witness, and the kernel path's
# steps are also held against the ground truth.
POSE_TOLERANCE = {"rot": 0.25, "dir": 5.0, "len": 0.15}
GT_TOLERANCE = {"rot": 0.25, "dir": 5.0}


def compare_plain_path(seq, device) -> None:
    """The first 5 steps through the plain versions, on the card: each
    step from the kernel path's state with the same RANSAC draws, beside
    the pose's response to a 1e-4 px jitter of its tracked points; then
    5 free-running steps of each path."""
    import torch

    from vo_tpu_torch.models import vo as vo_module
    from vo_tpu_torch.ops import blur_cuda, lk_cuda
    from vo_tpu_torch.runtime.presets import get_preset

    preset = get_preset("tracking_orb")
    plain = mock.patch.object(lk_cuda, "refine_level",
                              lk_cuda.refine_level_reference), \
        mock.patch.object(blur_cuda, "separable_blur",
                          blur_cuda.separable_blur_reference)

    def step_from(vo, state, gen_state, i, pts=None):
        gen = torch.Generator(device=device)
        gen.set_state(gen_state)
        state = state._replace(gen=gen)
        if pts is not None:
            state = state._replace(pts=pts)
        _, out = vo.step(state, seq.frame(i))
        return out.pose.cpu().numpy()

    def within(gap, limits):
        return all((abs(gap[k] - 1.0) if k == "len" else gap[k]) < v
                   for k, v in limits.items())

    kvo, pvo, jvo = (preset.build(seq.K, device=device) for _ in range(3))
    jitter_gen = torch.Generator(device=device)
    jitter_gen.manual_seed(1)
    state = kvo.init(seq.frame(0))
    failed = []
    for i in range(1, 6):
        P0 = state.pose.cpu().numpy()
        gen_state = state.gen.get_state()
        spy, scale_calls = _capture(vo_module, "relative_scale_matched")
        with spy:
            nxt, out = kvo.step(state, seq.frame(i))
            Pk = out.pose.cpu().numpy()
            noise = torch.randn(state.pts.shape, generator=jitter_gen,
                                device=device) * 1e-4
            with plain[0], plain[1]:
                Pp = step_from(pvo, state, gen_state, i)
                Pj = step_from(jvo, state, gen_state, i, state.pts + noise)
        (_, Xk, vk), (_, Xp, vp) = scale_calls[0], scale_calls[1]
        common = vk & vp
        dX = ((Xk - Xp).norm(dim=1) / Xp.norm(dim=1))[common]
        if not bool(common.any()):  # the first step has no earlier cloud
            dX = torch.zeros(1, device=device)
        g = _rel(seq.poses[i - 1], seq.poses[i])
        kp = _pose_gap(_rel(P0, Pk), _rel(P0, Pp))
        jit = _pose_gap(_rel(P0, Pp), _rel(P0, Pj))
        gk = _pose_gap(g, _rel(P0, Pk))
        _log(f"step {i} from one state: kernel vs plain {kp}; plain vs "
             f"plain with 1e-4 px jitter {jit}; kernel vs ground truth "
             f"{gk}; scale cloud: {int(vk.sum())} vs {int(vp.sum())} "
             f"valid, {int((vk != vp).sum())} differ, relative |dX| median "
             f"{dX.median().item():.2e} max {dX.max().item():.2e}; "
             f"tolerance: {POSE_TOLERANCE}, against ground truth "
             f"{GT_TOLERANCE}")
        if not (within(kp, POSE_TOLERANCE) and within(gk, GT_TOLERANCE)):
            failed.append(f"step {i}")
        state = nxt
    torch.cuda.synchronize()

    def free_run():
        vo = preset.build(seq.K, device=device)
        st = vo.init(seq.frame(0))
        outs = []
        for i in range(1, 6):
            st, o = vo.step(st, seq.frame(i))
            outs.append((o.pose.cpu().numpy(), int(o.n_assoc), st.pts,
                         st.pts_valid))
        return outs

    kern = free_run()
    with plain[0], plain[1]:
        plain_run = free_run()
    Pk0 = Pp0 = np.eye(4)
    for i, ((Pk, nk, pk, vk), (Pp, np_, pp, vp)) in enumerate(
            zip(kern, plain_run), 1):
        both = vk & vp
        dpts = (pk - pp).abs().amax(dim=1)[both].max().item()
        st = _pose_gap(_rel(Pk0, Pk), _rel(Pp0, Pp))
        _log(f"free-running step {i}: pose max |diff| "
             f"{np.abs(Pk - Pp).max():.3e}, step {st}, n_assoc {nk} vs "
             f"{np_}, points |diff| max {dpts:.3e} px; tolerance: n_assoc "
             f"equal, points < 1e-2 px, step {POSE_TOLERANCE}")
        if nk != np_ or dpts >= 1e-2 or not within(st, POSE_TOLERANCE):
            failed.append(f"free-running step {i}")
        Pk0, Pp0 = Pk, Pp
    if failed:
        raise RuntimeError(f"kernel and plain paths disagree: {failed}")


def compare_matching_plain(seq, device, steps: int = 3) -> None:
    """matching_orb's first `steps` steps through the plain version of B2
    (its one kernel: the Harris blur of every detect), each from the
    kernel path's state with the same RANSAC draws, beside the pose's
    response to a 1e-4 px jitter of the previous frame's keypoints and the
    ground truth. The keypoints of frame 0 and the associations must be
    the same and the step within POSE_TOLERANCE of the plain path's. The
    gap to the ground truth is printed, not held: one matching_orb step
    can miss the truth's translation direction by tens of degrees on
    these frames, and its 1e-4 px jitter moves it as far (an H100 run;
    vo_tpu's own ATE here is 24.51 %)."""
    import torch

    from vo_tpu_torch.ops import blur_cuda
    from vo_tpu_torch.runtime.presets import get_preset

    preset = get_preset("matching_orb")
    plain = mock.patch.object(blur_cuda, "separable_blur",
                              blur_cuda.separable_blur_reference)

    def step_from(vo, state, gen_state, i, pts=None):
        gen = torch.Generator(device=device)
        gen.set_state(gen_state)
        state = state._replace(gen=gen)
        if pts is not None:
            state = state._replace(pts=pts)
        _, out = vo.step(state, seq.frame(i))
        return out.pose.cpu().numpy(), int(out.n_assoc)

    def within(gap, limits):
        return all((abs(gap[k] - 1.0) if k == "len" else gap[k]) < v
                   for k, v in limits.items())

    kvo, pvo = (preset.build(seq.K, device=device) for _ in range(2))
    jitter_gen = torch.Generator(device=device)
    jitter_gen.manual_seed(2)
    state = kvo.init(seq.frame(0))
    with plain:
        pstate = pvo.init(seq.frame(0))
    same_init = bool(torch.equal(pstate.pts, state.pts))
    failed = [] if same_init else ["init keypoints"]
    for i in range(1, steps + 1):
        P0 = state.pose.cpu().numpy()
        gen_state = state.gen.get_state()
        nxt, out = kvo.step(state, seq.frame(i))
        Pk, nk = out.pose.cpu().numpy(), int(out.n_assoc)
        noise = torch.randn(state.pts.shape, generator=jitter_gen,
                            device=device) * 1e-4
        with plain:
            Pp, np_ = step_from(pvo, state, gen_state, i)
            Pj, _ = step_from(pvo, state, gen_state, i, state.pts + noise)
        g = _rel(seq.poses[i - 1], seq.poses[i])
        kp = _pose_gap(_rel(P0, Pk), _rel(P0, Pp))
        jit = _pose_gap(_rel(P0, Pp), _rel(P0, Pj))
        gk = _pose_gap(g, _rel(P0, Pk))
        _log(f"matching_orb step {i} from one state: kernel vs plain {kp}; "
             f"plain vs plain with 1e-4 px jitter {jit}; kernel vs ground "
             f"truth {gk}; n_assoc {nk} vs {np_}; init keypoints the same: "
             f"{same_init}; tolerance: n_assoc equal, {POSE_TOLERANCE}")
        if nk != np_ or not within(kp, POSE_TOLERANCE):
            failed.append(f"step {i}")
        state = nxt
    torch.cuda.synchronize()
    if failed:
        raise RuntimeError(f"matching_orb kernel and plain paths disagree: "
                           f"{failed}")


# vo_tpu's `compare` report on frame 0 of the pipeline sequence as a PNG
# (scripts/eval_ref_compare.py --full, JAX on the CPU of an H100 host). The
# port's report is held to these figures plus the ORB parity tolerances of
# tests/test_torch_orb.py (angles to 1e-4 rad, bits to 1e-4).
# vo_tpu reports 1000 keypoints, FAST-positive at all of them, orientation
# error 2.38e-7 rad at most (1.78e-8 mean) and bit error 0.
COMPARE_REF = {"n_keypoints": 1000,
               "orientation_max_err_rad": 2.384185791015625e-07,
               "descriptor_bit_error_rate": 0.0}
COMPARE_TOLERANCE = 1e-4
RESUME_EVERY = 20
RESUME_CUT = 41  # the interrupted run's frames: checkpoints at 20 and 40


def _bundle(out_dir: str) -> dict:
    """The result bundle's paths and the ATE share of the path they give."""
    from vo_tpu_torch.utils.io import load_path
    from vo_tpu_torch.utils.metrics import compute_ate

    gt = load_path(f"{out_dir}/tracking_orb/gt_path.txt")
    est = load_path(f"{out_dir}/tracking_orb/est_path.txt")
    ate, _ = compute_ate(gt, est)
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return {"est": est, "ate": ate, "share": ate / path}


def run_entry_points(base, counts: dict, card: str) -> None:
    """The runtime's entry points on a KITTI-layout directory written from
    the pipeline sequence's 60 frames (rounded to uint8, PNGs from the
    standard library's encoder): the native decoder through
    `KittiSequence.open(...).prefetched()` (every frame bit-exact), the CLI's
    tracking_orb (launch counters zeroed around it; B1 a multiple of 4, at
    least 4 per tracking step; B2 > 0; ATE from the bundle's files within
    ORB_ATE_LIMIT), a run interrupted at frame 41 and resumed from its
    checkpoint against two uninterrupted checkpointed runs, and `compare`
    on frame 0's PNG against vo_tpu's report (COMPARE_REF)."""
    import os
    import tempfile

    import torch

    from vo_tpu_torch.data.kitti import KittiSequence, write_sequence
    from vo_tpu_torch.models import vo as vo_module
    from vo_tpu_torch.runtime import cli
    from vo_tpu_torch.runtime.compare import run_compare
    from vo_tpu_torch.runtime.loader import (build_error, decode_png,
                                             native_available)

    modules = _kernel_modules()
    frames = [np.clip(np.rint(base.frame(i)), 0, 255).astype(np.uint8)
              for i in range(len(base))]
    with tempfile.TemporaryDirectory() as tmp:
        kitti = os.path.join(tmp, "kitti")
        write_sequence(kitti, "05", frames, base.poses, base.K)

        seq = KittiSequence.open(kitti, "05")
        t0 = time.perf_counter()
        if not native_available():  # builds it with g++ on first use
            raise RuntimeError(f"the native PNG decoder is unavailable: "
                               f"{build_error()}")
        _log(f"native PNG decoder ready in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        for p in seq.image_paths:
            decode_png(p)
        sync_ms = (time.perf_counter() - t0) * 1e3 / len(seq)
        pre = seq.prefetched()
        t0 = time.perf_counter()
        bad = [i for i in range(len(pre))
               if not np.array_equal(pre.frame(i), frames[i])]
        pre_ms = (time.perf_counter() - t0) * 1e3 / len(pre)
        served = pre.served
        pre.close()
        _log(f"decode: {len(seq)} PNGs of {SHAPE[0]}x{SHAPE[1]}, "
             f"decode_png {sync_ms:.3f} ms per frame, prefetched (4 threads) "
             f"{pre_ms:.3f} ms per frame; native decoder served {served}; "
             f"frames unequal to their uint8 source: {bad}")
        if bad or served != len(seq):
            raise RuntimeError(f"native decode: unequal frames {bad}, "
                               f"served {served} of {len(seq)}")

        def run_cli(out, *extra):
            tracked = []
            real = vo_module._track_step

            def spy(*args, **kwargs):
                tracked.append(1)
                return real(*args, **kwargs)

            for m in modules.values():
                m.launches = 0
            with mock.patch.object(vo_module, "_track_step", spy):
                rep = cli.main(["--preset", "tracking_orb", "--kitti-dir",
                                kitti, "--seq", "05", "--out",
                                os.path.join(tmp, out), "--no-plots", *extra])
            torch.cuda.synchronize()
            launched = {k: m.launches for k, m in modules.items()}
            return rep, launched, len(tracked), _bundle(os.path.join(tmp, out))

        rep, launched, n_track, b = run_cli("cli", "--max-frames", "60")
        files = sorted(os.listdir(os.path.join(tmp, "cli", "tracking_orb")))
        b1, b2 = launched["lk_refine"], launched["separable_blur"]
        _log(f"cli tracking_orb on the KITTI-layout PNGs ({card}): "
             f"{rep['fps']} fps (host clock over {rep['n_frames']} frames, "
             f"closed by a sync), "
             f"compile_s {rep['compile_s']}, ATE {b['ate']:.4f} "
             f"({100 * b['share']:.2f} % of the path, limit "
             f"{100 * ORB_ATE_LIMIT:.0f} %), launches {launched}, tracking "
             f"steps {n_track} (the warm-up step included), bundle {files}")
        if b1 % 4 or b1 < 4 * n_track or b2 <= 0:
            raise RuntimeError(f"cli: B1 {b1} launches for {n_track} tracking "
                               f"steps, B2 {b2}")
        if b["share"] > ORB_ATE_LIMIT:
            raise RuntimeError(f"cli: ATE {100 * b['share']:.2f} % of the path")
        if files != ["est_path.txt", "gt_path.txt", "metrics.json",
                     "scale.txt"]:
            raise RuntimeError(f"cli: bundle {files}")
        counts["cli_tracking_orb"] = launched

        every = ["--checkpoint-every", str(RESUME_EVERY)]
        ckpt = os.path.join(tmp, "resume.npz")
        run_cli("cut", *every, "--max-frames", str(RESUME_CUT),
                "--checkpoint-file", ckpt)
        resumed = run_cli("resumed", *every, "--max-frames", "60",
                          "--checkpoint-file", ckpt)
        whole = [run_cli(f"whole{k}", *every, "--max-frames", "60",
                         "--checkpoint-file", os.path.join(tmp, f"w{k}.npz"))
                 for k in (1, 2)]
        gap = float(np.abs(whole[0][3]["est"] - whole[1][3]["est"]).max())
        off = [float(np.abs(resumed[3]["est"] - w[3]["est"]).max())
               for w in whole]
        steps = len(seq) - RESUME_CUT
        _log(f"resume at frame {RESUME_CUT} with --checkpoint-every "
             f"{RESUME_EVERY} ({card}): "
             f"{steps / resumed[0]['runtime_s']:.2f} steps/s over the last "
             f"{steps} steps; uninterrupted checkpointed runs "
             f"{[w[0]['fps'] for w in whole]} fps, ATE "
             f"{[round(100 * w[3]['share'], 4) for w in whole]} % vs resumed "
             f"{100 * resumed[3]['share']:.4f} %; max |est| gap between the "
             f"two uninterrupted runs {gap:.3g}, resumed vs each {off}")
        if min(off) > gap:  # 0 when the two are bit-equal
            raise RuntimeError(f"resumed run off the uninterrupted ones by "
                               f"{off}, beyond their own gap {gap}")

        png0 = seq.image_paths[0]
        for m in modules.values():
            m.launches = 0
        cmp = run_compare(png0, None, True)
        torch.cuda.synchronize()
        launched = {k: m.launches for k, m in modules.items()}
    _log(f"compare on frame 0's PNG: {json.dumps(cmp)}; launches {launched}; "
         f"vo_tpu's {COMPARE_REF} (tolerance {COMPARE_TOLERANCE})")
    if launched["separable_blur"] <= 0 or cmp["n_keypoints"] <= 0:
        raise RuntimeError(f"compare: launches {launched}, "
                           f"{cmp['n_keypoints']} keypoints")
    for k in ("orientation_max_err_rad", "descriptor_bit_error_rate"):
        if cmp[k] > COMPARE_REF[k] + COMPARE_TOLERANCE:
            raise RuntimeError(f"compare: {k} {cmp[k]} > vo_tpu's "
                               f"{COMPARE_REF[k]} + {COMPARE_TOLERANCE}")


PARALLEL_POSE_TOLERANCE = 2e-3  # tests/test_parallel.py's window BA bound
WATCHDOG_S = 300.0


def _hung(tag: str, elapsed: float) -> None:
    """The watchdog's action: a section that hangs (a collective whose
    peer is gone) ends the process with a non-zero code."""
    import os

    print(f"[chip_smoke] watchdog: '{tag}' still running after "
          f"{elapsed:.0f} s; exiting", file=sys.stderr, flush=True)
    os._exit(3)


def run_parallel(clean, window_call, counts: dict, card: str) -> None:
    """The parallel port on a 1-rank NCCL group (module docstring, phase
    6). Launch counts go into `counts` under parallel_tracking_orb,
    parallel_blur_fast and parallel_batched_orb."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from vo_tpu_torch.frontend.orb import OrbFeatures, orb_detect_and_compute
    from vo_tpu_torch.ops.conv import binomial_blur5
    from vo_tpu_torch.ops.fast import fast_score
    from vo_tpu_torch.ops.hamming import match_descriptors
    from vo_tpu_torch.parallel import (StepWatchdog, batched_orb, make_mesh,
                                       shard_leading, sharded_fast_score,
                                       sharded_gaussian_blur,
                                       sharded_match_descriptors)
    from vo_tpu_torch.ba.window import run_window_ba
    from vo_tpu_torch.parallel.ba import shard_window, sharded_window_ba
    from vo_tpu_torch.parallel.mesh import init_process_group
    from vo_tpu_torch.runtime.presets import get_preset

    wd = StepWatchdog(timeout_s=WATCHDOG_S, on_timeout=_hung)
    modules = _kernel_modules()
    t_phase = time.perf_counter()

    def zero():
        for m in modules.values():
            m.launches = 0

    def launched():
        torch.cuda.synchronize()
        return {k: m.launches for k, m in modules.items()}

    with tempfile.TemporaryDirectory() as tmp:
        with wd.watch("NCCL group init"):
            t0 = time.perf_counter()
            init_process_group(0, 1, f"file://{os.path.join(tmp, 'store')}",
                               "cuda")
            mesh = make_mesh(axis="kp")  # cuda, as every entry point
            probe = torch.ones(1, device="cuda")
            dist.all_reduce(probe)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
        try:
            backend = dist.get_backend()
            if backend != "nccl" or float(probe) != 1.0:
                raise RuntimeError(f"parallel: backend {backend}, all-reduce "
                                   f"of one rank gave {float(probe)}")
            _log(f"parallel: 1-rank {backend} group and mesh {mesh} in "
                 f"{init_s:.2f} s")
            _parallel_tracking(clean, mesh, wd, counts, card, zero, launched)
            preset = get_preset("tracking_orb")
            with wd.watch("sharded matching"):
                f0, f1 = (orb_detect_and_compute(clean.frame(i),
                                                 preset.config.orb)
                          for i in (0, 1))
                cut = lambda x: shard_leading(mesh, "kp", x)  # noqa: E731
                dense = match_descriptors(f0.bits, f1.bits, f0.valid,
                                          f1.valid)
                shard = sharded_match_descriptors(
                    mesh, cut(f0.bits), cut(f1.bits), cut(f0.valid),
                    cut(f1.valid))
                same = all(torch.equal(a, b) for a, b in zip(dense, shard))
                ms = [_time_ms(lambda: match_descriptors(
                    f0.bits, f1.bits, f0.valid, f1.valid), 10),
                      _time_ms(lambda: sharded_match_descriptors(
                          mesh, f0.bits, f1.bits, f0.valid, f1.valid), 10)]
            _log(f"sharded matching {f0.bits.shape[0]} x {f1.bits.shape[0]} "
                 f"(frames 0/1, 1 rank, {card}): {int(dense.count())} "
                 f"matches, bit-equal to match_descriptors: {same}; "
                 f"{ms[0]:.4f} ms dense, {ms[1]:.4f} ms sharded (CUDA events)")
            if not same:
                raise RuntimeError("sharded matching differs from the dense")

            row = make_mesh(axis="row")
            img = clean.frame(0)
            with wd.watch("row-sharded stencils"):
                blur, fast = binomial_blur5(img), fast_score(img)
                zero()
                sblur = sharded_gaussian_blur(row)(
                    shard_leading(row, "row", img))
                sfast = sharded_fast_score(row)(shard_leading(row, "row",
                                                              img))
                counts["parallel_blur_fast"] = launched()
            eq = (torch.equal(sblur, blur), torch.equal(sfast, fast))
            _log(f"row-sharded blur and FAST on frame 0 (376x1241, 1 rank): "
                 f"bit-equal {eq}, FAST corners {int((fast > 0).sum())}, "
                 f"launches {counts['parallel_blur_fast']}")
            if not all(eq) or counts["parallel_blur_fast"]["separable_blur"] \
                    != 1:
                raise RuntimeError(f"row-sharded stencils: equal {eq}, "
                                   f"{counts['parallel_blur_fast']}")

            frame = make_mesh(axis="frame")
            frames = torch.stack([clean.frame(0), clean.frame(1)])
            with wd.watch("batched ORB"):
                zero()
                feats = batched_orb(frame, preset.config.orb)(
                    shard_leading(frame, "frame", frames))
                counts["parallel_batched_orb"] = launched()
            same = all(torch.equal(getattr(feats, k)[i], getattr(f, k))
                       for i, f in enumerate((f0, f1))
                       for k in OrbFeatures._fields)
            _log(f"batched_orb on frames 0 and 1 (1 rank): equal to the "
                 f"single-frame detect {same}, keypoints "
                 f"{feats.valid.sum(1).tolist()}, launches "
                 f"{counts['parallel_batched_orb']}")
            if not same or counts["parallel_batched_orb"]["separable_blur"] \
                    != 2:
                raise RuntimeError("batched_orb differs from the detect")

            win, K, wcfg, lmap = window_call
            with wd.watch("sharded window BA"):
                poses, _, info, _ = run_window_ba(win, K, wcfg, lmap=lmap)
                sposes, _, sinfo, _ = sharded_window_ba(
                    mesh, shard_window(mesh, win), K, wcfg,
                    lmap=tuple(shard_leading(mesh, "kp", x) for x in lmap))
                torch.cuda.synchronize()
            counts_eq = all(int(info[k]) == int(sinfo[k])
                            for k in ("ba_landmarks", "ba_holdout_n",
                                      "ba_ran", "ba_reused"))
            gap = float((sposes - poses).abs().max())
            _log(f"sharded window BA (tracking_sift_ba's first window, "
                 f"{win.obs.shape[1]} slots, 1 rank): landmarks "
                 f"{int(sinfo['ba_landmarks'])} / {int(info['ba_landmarks'])}"
                 f", hold-out {int(sinfo['ba_holdout_n'])} / "
                 f"{int(info['ba_holdout_n'])}, accepted "
                 f"{int(sinfo['ba_accepted'])}, max |pose gap| {gap:.3g}, "
                 f"bit-equal {torch.equal(sposes, poses)}")
            if not counts_eq or not torch.allclose(
                    sposes, poses, rtol=PARALLEL_POSE_TOLERANCE,
                    atol=PARALLEL_POSE_TOLERANCE):
                raise RuntimeError("sharded window BA left the dense one")
            _log(f"parallel phase: {time.perf_counter() - t_phase:.1f} s "
                 f"({card})")
        finally:
            dist.destroy_process_group()


def _parallel_tracking(clean, mesh, wd, counts, card, zero, launched):
    """tracking_orb through ShardedTrackingVO and through the dense
    pipeline, after a 3-step warm-up of each, their steps interleaved (the
    order alternating step by step) and each closed by a synchronize:
    poses, n_assoc and n_inliers bit-equal, the host time of each, and the
    sharded run's launches (counters zeroed just before each of its
    calls, read just after)."""
    import torch

    from vo_tpu_torch.models.vo import FrameOutput, _read_back
    from vo_tpu_torch.parallel.vo_step import ShardedTrackingVO
    from vo_tpu_torch.runtime.presets import get_preset

    preset = get_preset("tracking_orb")
    make = {"dense": lambda: preset.build(clean.K),
            "sharded": lambda: ShardedTrackingVO(mesh, clean.K,
                                                 preset.config)}
    with wd.watch("sharded and dense tracking_orb"):
        for name, build in make.items():
            warm = build()
            state = warm.init(clean.frame(0))
            for i in range(1, 4):
                state, _ = warm.step(state, clean.frame(i))
        torch.cuda.synchronize()
        pipes = {name: build() for name, build in make.items()}
        secs = dict.fromkeys(pipes, 0.0)
        outs = {name: [] for name in pipes}
        states, total = {}, {k: 0 for k in _kernel_modules()}

        def timed(name, call):
            zero()
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            if name == "sharded":
                for k, v in launched().items():
                    total[k] += v
            return res

        for name, p in pipes.items():
            states[name] = timed(name, lambda: p.init(clean.frame(0)))
        for i in range(1, len(clean)):
            order = list(pipes) if i % 2 else list(pipes)[::-1]
            for name in order:
                states[name], out = timed(name, lambda: pipes[name].step(
                    states[name], clean.frame(i)))
                outs[name].append(out)
        cols = {name: _read_back(o, FrameOutput._fields)
                for name, o in outs.items()}
    counts["parallel_tracking_orb"] = total
    d, s = cols["dense"], cols["sharded"]
    n = len(clean) - 1
    same = {k: bool(np.array_equal(d[k], s[k]))
            for k in ("pose", "n_assoc", "n_inliers", "fallback")}
    refresh = [i + 1 for i, f in enumerate(s["fallback"]) if f]
    b1 = total["lk_refine"]
    _log(f"parallel tracking_orb, 1-rank NCCL, {SHAPE[0]}x{SHAPE[1]}, "
         f"{len(clean)} frames ({card}): sharded "
         f"{1e3 * secs['sharded'] / n:.2f} ms per step, dense "
         f"{1e3 * secs['dense'] / n:.2f} ms per step (host clock over init "
         f"+ {n} steps, each closed by a synchronize, the two runs' steps "
         f"interleaved); bit-equal {same}; re-detects (through the dense "
         f"refresh) at steps {refresh}; launches {total}; median n_assoc "
         f"{int(np.median(s['n_assoc']))}")
    if not all(same.values()):
        raise RuntimeError(f"sharded tracking_orb differs from the dense: "
                           f"{same}")
    if b1 != 4 * (n - len(refresh)) or total["separable_blur"] < 1:
        raise RuntimeError(f"parallel tracking_orb: launches {total} for "
                           f"{n - len(refresh)} track steps")
# ---------------------------------------------------------------- phase 7

SCAN_PATHS = (  # (preset, sequence, kernels it must launch)
    ("tracking_orb", "seq", ("lk_refine", "separable_blur")),
    ("tracking_sift", "clean", ("lk_refine", "separable_blur",
                                "crop_windows", "row_conv")),
    ("matching_orb", "clean", ("separable_blur",)))
LK_SLOTS = (1536, 768, 192)  # slot counts B1 is timed at besides the live
LK_STEP = 40  # the tracking_orb step whose work B1 is timed on


def scan_vs_loop(name, seq) -> tuple:
    """The preset `name` through `run_vo` with the sync gate and through
    `run_vo_scan` from the preset's own pipeline, on the same frames.
    Raises unless the two are bit-equal. Returns (scan's stats, loop s,
    scan s, the scan's launch counts)."""
    import torch

    from vo_tpu_torch.models.vo import run_vo
    from vo_tpu_torch.models.vo_scan import run_vo_scan
    from vo_tpu_torch.runtime.presets import get_preset

    preset = get_preset(name)
    t0 = time.perf_counter()
    loop = run_vo(seq, preset.make(
        seq.K, preset.config._replace(fallback_gate="sync")))
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    vo = preset.build(seq.K)
    modules = _kernel_modules()
    for m in modules.values():
        m.launches = 0
    t0 = time.perf_counter()
    scan = run_vo_scan(seq, vo)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    counts = {k: m.launches for k, m in modules.items()}
    differ = [k for k, a, b in zip(("est", "gt", "scales"), loop, scan)
              if not np.array_equal(a, b)]
    if loop[3] != scan[3]:
        differ.append("stats")
    if differ:
        raise RuntimeError(f"{name}: scan differs from the step loop in "
                           f"{differ}")
    return scan[3], t_loop, t_scan, counts


def run_scans(seqs: dict, counts: dict) -> None:
    """Each of SCAN_PATHS in scan mode against its sync-gate step loop."""
    for name, which, kernels in SCAN_PATHS:
        seq = seqs[which]
        stats, t_loop, t_scan, c = scan_vs_loop(name, seq)
        n = len(seq) - 1
        redetects = [i for i, s in enumerate(stats) if s.get("fallback")]
        _log(f"{name}_scan: {n} steps bit-equal to the sync-gate step loop "
             f"(trajectory, scales, n_assoc, n_inliers, scale, fallback, "
             f"health); scan {n / t_scan:.2f} fps, step loop "
             f"{n / t_loop:.2f} fps (host clock over init + {n} steps, "
             f"closed by synchronize; loop first); re-detects at "
             f"{redetects}; launches {c}")
        if name == "tracking_orb" and not redetects:
            raise RuntimeError("tracking_orb_scan: no re-detect")
        if min(c[k] for k in kernels) <= 0:
            raise RuntimeError(f"{name}_scan: a kernel was not launched: "
                               f"{c}")
        counts[f"{name}_scan"] = c


def _first_live(state, n: int):
    """The tracking state on n slots: its live slots first, in slot order
    (then dead ones), every per-slot field cut alike."""
    import torch

    from vo_tpu_torch.ops.lk import LKCache

    idx = torch.argsort((~state.pts_valid).to(torch.uint8), stable=True)[:n]
    return state._replace(
        lk_cache=LKCache(origins=tuple(o[idx]
                                       for o in state.lk_cache.origins)),
        pts=state.pts[idx], pts_valid=state.pts_valid[idx],
        prev3d=state.prev3d[idx], prev3d_valid=state.prev3d_valid[idx])


def time_lk_slots(seq, card: str) -> None:
    """B1 per track step against the number of slots it runs on: the
    tracking_orb state before step LK_STEP (sync gate), at full capacity,
    at its live slots and cut to LK_SLOTS, each tracked into frame LK_STEP
    from the same generator state; the step's four B1 launches timed with
    CUDA events (20 reps), with B1's N and mean iterations per level."""
    import torch

    from vo_tpu_torch.models.vo import _track_step
    from vo_tpu_torch.ops import lk_cuda
    from vo_tpu_torch.runtime.presets import get_preset

    preset = get_preset("tracking_orb")
    vo = preset.make(seq.K, preset.config._replace(fallback_gate="sync"))
    state = vo.init(seq.frame(0))
    for i in range(1, LK_STEP):
        state, _ = vo.step(state, seq.frame(i))
    gen_state = state.gen.get_state()
    live = int(state.pts_valid.sum())
    for n in (vo.capacity, live, *LK_SLOTS):
        st = state if n == vo.capacity else _first_live(state, n)
        gen = torch.Generator(device=st.pts.device)
        gen.set_state(gen_state)
        spy, args = _capture(lk_cuda, "refine_level")
        with spy:
            _track_step(st._replace(gen=gen), seq.frame(LK_STEP), vo.K,
                        vo.cfg)
        if len(args) != 4 or any(a[2].shape[0] != n for a in args):
            raise RuntimeError(f"B1 at {n} slots: launches on "
                               f"{[a[2].shape[0] for a in args]} points")
        iters = [round(float(lk_cuda.refine_level(*a)[2].float().mean()), 2)
                 for a in args]
        ms = _time_ms(lambda: [lk_cuda.refine_level(*a) for a in args], 20)
        kind = ("full capacity" if n == vo.capacity else
                "the live slots" if n == live else "live slots only")
        _log(f"B1 per track step into frame {LK_STEP} on {n} slots ({kind}"
             f"; {min(n, live)} live): {ms:.4f} ms (4 levels, CUDA events, "
             f"20 reps; mean iterations per level {iters}; {card})")


def run_rest(seqs: dict, card: str, counts: dict) -> None:
    """Phase 7: scan mode, then B1 against its lane count."""
    t0 = time.perf_counter()
    run_scans(seqs, counts)
    time_lk_slots(seqs["clean"], card)
    _log(f"phase 7: {time.perf_counter() - t0:.1f} s")


# Phase 8: the 1000-frame eval's run function on the hard sequence cut to
# 100 frames (seed 0), whose dropout stretches (frames 30-35, 60-63 and
# 80-85) force tracking_sift_ba's re-detects (tracking_orb's LK tracks hold
# through them); tracking_sift_ba solves its window at steps 10-90.
EVAL_FRAMES = 100
EVAL_PRESETS = {"tracking_orb": ("lk_refine", "separable_blur"),
                "tracking_sift_ba": ("lk_refine", "separable_blur",
                                     "crop_windows", "row_conv")}


def run_eval(counts: dict, card: str) -> None:
    """Phase 8: scripts/eval_torch_synthetic.py's `run_preset` on the card
    for tracking_orb and tracking_sift_ba over the staged sequence, each
    bundle held to vo_tpu's layout (results_tpu/<preset>/: its files, and
    metrics.json's keys in order) plus run.json, tracking_sift_ba with a
    re-detect and a BA solve; launch counters zeroed around each run
    (`eval_<preset>` in launches_by_path)."""
    import tempfile

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "scripts"))
    import eval_torch_synthetic as ev

    t0 = time.perf_counter()
    device = torch.device("cuda")
    seq = ev.make_sequence("hard", EVAL_FRAMES, 0)
    staged = ev.StagedSequence(ev.render(seq), seq.poses, seq.K, device)
    _log(f"phase 8: rendered and staged {len(staged)} frames of the hard "
         f"sequence in {time.perf_counter() - t0:.1f} s")
    meta = {"sequence": "hard", "device": "cuda", "card": card, "jobs": 1,
            "gate": "preset", "code": ev.code_hash()}
    modules = _kernel_modules()
    with tempfile.TemporaryDirectory() as tmp:
        for name, path_kernels in EVAL_PRESETS.items():
            for m in modules.values():
                m.launches = 0
            run = ev.run_preset(name, staged, tmp, 0, device, meta)
            c = counts[f"eval_{name}"] = {k: m.launches
                                          for k, m in modules.items()}
            ref = os.path.join(root, "results_tpu", name)
            out = os.path.join(tmp, name)
            with open(os.path.join(ref, "metrics.json")) as f:
                ref_keys = list(json.load(f))
            with open(os.path.join(out, "metrics.json")) as f:
                row = json.load(f)
            _log(f"eval {name}: ATE {row['ate_rmse']} m, RPE "
                 f"{row['rpe_rmse']} m, re-detects at {run['fallbacks']}, BA "
                 f"solves {run['ba_runs']} (accepting {run['ba_accepting']}, "
                 f"poses {run['ba_poses']}), {run['seconds']} s "
                 f"({run['fps']} fps), launches {c}")
            files = set(os.listdir(ref)) | {"run.json"}
            if set(os.listdir(out)) != files:
                raise RuntimeError(f"eval {name}: bundle "
                                   f"{sorted(os.listdir(out))}, expected "
                                   f"{sorted(files)}")
            if list(row) != ref_keys:
                raise RuntimeError(f"eval {name}: metrics.json keys "
                                   f"{list(row)}, vo_tpu's {ref_keys}")
            if not np.isfinite([row["ate_rmse"], row["rpe_rmse"]]).all():
                raise RuntimeError(f"eval {name}: non-finite metrics {row}")
            if name == "tracking_sift_ba" and not run["fallbacks"]:
                raise RuntimeError(f"eval {name}: no re-detect")
            if name == "tracking_sift_ba" and not run["ba_runs"]:
                raise RuntimeError(f"eval {name}: no BA solve")
            if min(c[k] for k in path_kernels) <= 0:
                raise RuntimeError(f"eval {name}: a kernel was not launched: "
                                   f"{c}")
    _log(f"phase 8: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from vo_tpu_torch import _build
        from vo_tpu_torch.data.synthetic import SyntheticSequence
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda")
    _log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build(["lk_refine", "separable_blur", "row_conv",
                         "crop_windows"])
    _log(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, out in logs.items():
        for line in ptxas_summary(out):
            _log(f"  {name}: {line}")

    t0 = time.perf_counter()
    base = SyntheticSequence.generate(
        n_frames=N_FRAMES, shape=SHAPE, n_points=4000, yaw_amplitude=0.3,
        n_turns=2.0,
    )
    clean = _Staged(base, device)
    # a frame with no landmarks: the renderer's flat background
    seq = clean.with_frame(BLANK, torch.full(SHAPE, 128.0, device=device))
    small = _Staged(SyntheticSequence.generate(n_frames=2, shape=(240, 320)),
                    device)
    _log(f"rendered {len(seq)} frames in {time.perf_counter() - t0:.1f} s")

    kernels = [check_lk([("kitti", seq), ("240x320", small)], device),
               check_blur(seq, device)]
    sift_calls = capture_sift(clean, device)
    kernels[1].update(check_sift_blurs(sift_calls["separable_blur"]))
    kernels += [check_crop(sift_calls["crop_windows_pair"], device),
                check_rowconv(sift_calls["conv_rows_cols"], device)]

    counts = {
        "tracking_orb": run_pipeline(
            "tracking_orb", seq, device, ORB_ATE_LIMIT,
            ("lk_refine", "separable_blur"), f"frame {BLANK} blank"),
        "tracking_sift": run_pipeline(
            "tracking_sift", clean, device, SIFT_ATE_LIMIT,
            tuple(_kernel_modules()), "no blank frame"),
    }
    sift = counts["tracking_sift"]
    if sift["crop_windows"] != 2 * sift["row_conv"]:
        raise RuntimeError(f"tracking_sift: expected two B3 launches per B4 "
                           f"launch (one per window size and detect): {sift}")
    for name, path_kernels in (
            ("matching_orb", ("separable_blur",)),
            ("matching_sift", ("separable_blur", "crop_windows", "row_conv")),
            ("matching_orb_3d_correspond", ("separable_blur",))):
        counts[name] = run_pipeline(name, clean, device, ATE_LIMIT[name],
                                    path_kernels, "no blank frame",
                                    redetects=False)
    ms = counts["matching_sift"]
    # one SIFT detect per frame: one B4 launch and two B3 launches each
    if not (ms["row_conv"] == N_FRAMES
            and ms["crop_windows"] == 2 * N_FRAMES
            and ms["separable_blur"] % N_FRAMES == 0):
        raise RuntimeError(f"matching_sift: expected per frame one B4, two B3"
                           f" and a fixed number of B2 launches: {ms}")
    # warmed up through one BA solve (ba_every steps with a full window),
    # so that the first solve's library set-up is not timed
    counts["tracking_sift_ba"] = run_pipeline(
        "tracking_sift_ba", clean, device, ATE_LIMIT["tracking_sift_ba"],
        tuple(_kernel_modules()), "no blank frame", warm_steps=10)
    time_sift_detect(clean, device)
    window_call = time_window_ba(clean, device)
    compare_plain_path(seq, device)
    compare_sift_plain(clean, device)
    compare_matching_plain(clean, device)
    run_entry_points(base, counts, card)
    run_parallel(clean, window_call, counts, card)
    run_rest({"seq": seq, "clean": clean}, card, counts)
    run_eval(counts, card)

    for k in kernels:
        k["launches"] = counts["tracking_sift"][k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in counts.items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
