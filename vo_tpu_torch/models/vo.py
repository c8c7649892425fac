"""End-to-end monocular VO pipelines (port of vo_tpu/models/vo.py).

- `TrackingVO` is vo_tracking (feature_tracking.cpp): ORB or SIFT on frame
  0 (`VOConfig.detector`), pyramidal LK frame to frame, a re-detect + knn
  match step (Hamming for ORB, L2 for SIFT) when the tracked survivors
  drop below `min_tracked` (feature_tracking.cpp:69-71), 5-point
  LO-RANSAC pose, closed-form depths, matched-cloud scale, and pose
  chaining cur = prev @ T^-1.
- `MatchingVO` is vo_matching (feature_matching.cpp): detect + describe
  every frame, knn(2) ratio matching against the previous frame, the same
  geometry, and by default the unmatched-cloud scale of that driver.

Every step is a fixed-shape program of masked arrays on the device. The
one data-dependent choice, whether to re-detect, is made on the host from
survivor counts copied back asynchronously (`_AsyncScalarGate`), so the
host never waits on the card inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..frontend.orb import OrbConfig, level_budgets, orb_detect_and_compute
from ..frontend.sift import SiftConfig, sift_detect_and_compute
from ..geometry.epipolar import normalize_pixels, ransac_essential, recover_pose
from ..geometry.scale import relative_scale_matched, relative_scale_unmatched
from ..geometry.se3 import inv_se3, make_se3
from ..geometry.triangulate import triangulate_depths
from ..ops.hamming import knn2_ratio_match, l2_table, match_descriptors
from ..ops.lk import (
    LKCache,
    LKConfig,
    lk_build_pyramid,
    lk_make_cache,
    lk_pyramid_track_cached,
)


class VOConfig(NamedTuple):
    """Static pipeline parameters; defaults = the reference's tracking_orb
    configuration (ORB-3000, LK 21x21 x 4 levels x 30, RANSAC thr 1 px,
    re-detect below 150)."""

    orb: OrbConfig = OrbConfig(nfeatures=3000, fast_threshold=20.0)
    # frontend: "orb" (Hamming bits) or "sift" (L2 float descriptors), the
    # reference's two detector families (feature_matching.cpp:27-33)
    detector: str = "orb"
    sift: SiftConfig = SiftConfig()
    lk: LKConfig = LKConfig()
    ransac_iters: int = 256  # fixed-batch hypothesis count
    ransac_px_threshold: float = 1.0
    min_tracked: int = 150
    match_ratio: float = 0.8
    min_pose_points: int = 8
    # "matched": prev/cur 3D points pair by slot (tracking, where LK keeps
    # slot identity); "unmatched": the i-th valid point of each cloud pair
    # up, truncated to the common count (feature_matching.cpp:251-263)
    scale_mode: str = "matched"
    # "reference" caches the raw unit-baseline cloud, as the reference does
    # (feature_tracking.cpp:271-281), so each scale is a baseline ratio;
    # "rescaled" caches s * X (measured worse in vo_tpu: kept for parity)
    scale_chain: str = "reference"
    # "async": the re-detect gate never blocks on the device->host survivor
    # count; "sync": it waits for it every frame (reproducible runs, tests)
    fallback_gate: str = "async"
    # bounded staleness of the async gate: a count older than this many
    # steps is waited for, which also caps how far the host runs ahead
    gate_max_lag: int = 32


def detect_and_describe(img: torch.Tensor, cfg: VOConfig):
    """(pts (K, 2), desc, valid (K,)) of one frame: `desc` is (K, 256)
    uint8 bit planes for ORB, (K, 128) float32 for SIFT."""
    if cfg.detector == "sift":
        f = sift_detect_and_compute(img, cfg.sift)
        return torch.stack([f.xs, f.ys], 1), f.desc, f.valid
    f = orb_detect_and_compute(img, cfg.orb)
    return torch.stack([f.xs, f.ys], 1), f.bits, f.valid


def match_features(desc1, desc2, valid1, valid2, cfg: VOConfig):
    """knn2 + ratio matching in the detector's metric (Hamming / L2)."""
    if cfg.detector == "sift":
        return knn2_ratio_match(l2_table(desc1, desc2), valid1, valid2,
                                cfg.match_ratio, squared=True)
    return match_descriptors(desc1, desc2, valid1, valid2, cfg.match_ratio)


def _feature_capacity(cfg: VOConfig) -> int:
    if cfg.detector == "sift":
        return cfg.sift.nfeatures
    return sum(level_budgets(cfg.orb))


class FrameOutput(NamedTuple):
    pose: torch.Tensor  # (4, 4) cam->world, chained
    scale: torch.Tensor  # ()
    n_assoc: torch.Tensor  # () tracked/matched count used for the pose
    n_inliers: torch.Tensor  # () RANSAC inliers passing cheirality
    fallback: torch.Tensor  # () bool: this step re-detected
    health: torch.Tensor  # () n_assoc, 0 on frames that held the pose
    gate: torch.Tensor  # (2,) int32 [dip latch, health]: the gate's feed


class TrackingState(NamedTuple):
    pyramid: tuple  # previous frame's halving pyramid
    lk_cache: LKCache  # previous frame's search-window origins
    pts: torch.Tensor  # (K, 2) tracked points in the previous frame
    pts_valid: torch.Tensor  # (K,) bool
    prev3d: torch.Tensor  # (K, 3) previous frame-pair cloud
    prev3d_valid: torch.Tensor  # (K,) bool
    pose: torch.Tensor  # (4, 4)
    gen: torch.Generator  # RANSAC draws
    health: torch.Tensor  # () int32, the previous step's FrameOutput.health
    dipped: torch.Tensor  # () int32 latch: any health < min_tracked since
    # the last re-detect, accumulated on the device


def _pose_scale_chain(pts1, pts2, valid, K, prev3d, prev3d_valid, pose, gen,
                      cfg: VOConfig, slot=None):
    """RANSAC pose + triangulation scale + chaining. Returns (new_pose,
    cur3d, cur3d_valid, scale, n_inliers, pose_ok); holds the pose when
    fewer than `min_pose_points` associations or inliers survive."""
    p1n = normalize_pixels(pts1, K)
    p2n = normalize_pixels(pts2, K)
    res = ransac_essential(
        p1n, p2n, valid, threshold=cfg.ransac_px_threshold / K[0, 0],
        n_iters=cfg.ransac_iters, generator=gen, slot=slot,
    )
    pose_res = recover_pose(res.E, p1n, p2n, res.inliers)
    R, t = pose_res.R, pose_res.t
    # every association is triangulated under the recovered pose; points
    # failing cheirality or beyond 1e4 baselines leave the scale median
    z1, z2 = triangulate_depths(R, t, p1n, p2n)
    X = z1[:, None] * torch.cat([p1n, torch.ones_like(p1n[:, :1])], 1)
    cur_valid = (valid & torch.isfinite(z1) & torch.isfinite(z2)
                 & (z1 > 0) & (z2 > 0) & (z1 < 1e4))
    if cfg.scale_mode == "matched":
        s = relative_scale_matched(prev3d, X, prev3d_valid & cur_valid)
    else:
        s = relative_scale_unmatched(prev3d, prev3d_valid, X, cur_valid)
    n_inl = pose_res.mask.sum()
    enough = (valid.sum() >= cfg.min_pose_points) \
        & (n_inl >= cfg.min_pose_points)
    new_pose = torch.where(enough, pose @ inv_se3(make_se3(R, s * t)), pose)
    s = torch.where(enough, s, torch.ones_like(s))
    if cfg.scale_chain == "rescaled":
        X = s * X
    return new_pose, X, cur_valid & enough, s, n_inl, enough


def _start_host_copy(value: torch.Tensor):
    """(host tensor, CUDA event or None): a copy of `value` into pinned host
    memory, started at once without waiting, and the event that marks its
    arrival. A CPU tensor is its own copy and needs no event."""
    if not value.is_cuda:
        return value, None
    host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
    host.copy_(value, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class _AsyncScalarGate:
    """Non-blocking watch of the device-side dip latch.

    Each step pushes its packed [dip latch, health] pair; the copy into
    pinned host memory starts at once and a CUDA event marks its arrival.
    `update()` consumes whatever has arrived (the event has completed),
    waits only for entries `max_lag` steps old, and reports whether any
    consumed entry from after the last trigger showed a dip. In "sync"
    mode every entry is read as soon as it is pushed."""

    def __init__(self, mode: str = "async", max_lag: int = 32):
        if mode not in ("async", "sync"):
            raise ValueError(f"unknown gate mode {mode!r}")
        self.mode = mode
        self.max_lag = max_lag
        self.reset()

    def reset(self):
        self._inbox: list = []  # (step_idx, host tensor, event or None)
        self._step = 0
        self._last_trigger = -1
        self._pending_low = False

    def push(self, value: torch.Tensor) -> None:
        self._step += 1
        self._inbox.append((self._step, *_start_host_copy(value)))

    def _apply(self, idx: int, host: torch.Tensor) -> None:
        if idx > self._last_trigger and bool(host[0]):  # the dip latch
            self._pending_low = True

    def update(self) -> bool:
        while self._inbox:
            idx, host, event = self._inbox[0]
            if event is not None:
                stale = self._step - idx >= self.max_lag
                if self.mode == "async" and not stale and not event.query():
                    break
                event.synchronize()
            self._inbox.pop(0)
            self._apply(idx, host)
        trigger = self._pending_low
        if trigger:
            self._pending_low = False
            self._last_trigger = self._step  # wait for post-refresh counts
        return trigger


def _tracking_init(feats, img0, gen, cfg: VOConfig) -> TrackingState:
    pts, _, valid = feats
    K_cap = pts.shape[0]
    pyr = lk_build_pyramid(img0, cfg.lk)
    n = valid.sum().to(torch.int32)
    return TrackingState(
        pyramid=pyr,
        lk_cache=lk_make_cache(pyr, pts, cfg.lk),
        pts=pts,
        pts_valid=valid,
        prev3d=pts.new_zeros((K_cap, 3)),
        prev3d_valid=torch.zeros_like(valid),
        pose=torch.eye(4, dtype=torch.float32, device=pts.device),
        gen=gen,
        health=n,
        dipped=(n < cfg.min_tracked).to(torch.int32),
    )


def _finish_tracking_step(state, pyr2, cache2, pts1, pts2, valid, K,
                          cfg: VOConfig, fallback: bool, slot=None):
    new_pose, cur3d, cur3d_valid, s, n_inl, pose_ok = _pose_scale_chain(
        pts1, pts2, valid, K, state.prev3d, state.prev3d_valid, state.pose,
        state.gen, cfg, slot,
    )
    n_assoc = valid.sum().to(torch.int32)
    health = torch.where(pose_ok, n_assoc, torch.zeros_like(n_assoc))
    dip_now = (health < cfg.min_tracked).to(torch.int32)
    # the latch restarts at a re-detect and accumulates across track steps
    dipped = dip_now if fallback else torch.maximum(state.dipped, dip_now)
    new_state = TrackingState(
        pyramid=pyr2, lk_cache=cache2, pts=pts2, pts_valid=valid,
        prev3d=cur3d, prev3d_valid=cur3d_valid, pose=new_pose,
        gen=state.gen, health=health, dipped=dipped,
    )
    out = FrameOutput(
        pose=new_pose,
        scale=s,
        n_assoc=n_assoc,
        n_inliers=n_inl,
        fallback=torch.full((), fallback, device=new_pose.device),
        health=health,
        gate=torch.stack([dipped, health]),
    )
    return new_state, out


def _track_step(state: TrackingState, img, K, cfg: VOConfig, slot=None):
    """Pure LK-tracking step: the hot path of every frame."""
    pyr2 = lk_build_pyramid(img, cfg.lk)
    tracked, status, cache2 = lk_pyramid_track_cached(
        state.lk_cache, state.pyramid, pyr2, state.pts, state.pts_valid,
        cfg.lk,
    )
    return _finish_tracking_step(state, pyr2, cache2, state.pts, tracked,
                                 status, K, cfg, fallback=False, slot=slot)


def _refresh_core(state: TrackingState, img, feats1, feats2, K,
                  cfg: VOConfig, slot=None):
    """Re-detect on both frames + knn matching in the detector's metric
    (feature_tracking.cpp:195-220); replaces tracking for this pair."""
    pyr2 = lk_build_pyramid(img, cfg.lk)
    p1, d1, v1 = feats1
    p2, d2, v2 = feats2
    m = match_features(d1, d2, v1, v2, cfg)
    pts2 = p2[m.idx]
    cache2 = lk_make_cache(pyr2, pts2, cfg.lk)
    return _finish_tracking_step(state, pyr2, cache2, p1, pts2, m.valid, K,
                                 cfg, fallback=True, slot=slot)


class _Pipeline:
    """What every pipeline shares: configuration, device, intrinsics and
    the frontend. Runs on `device` (``cuda`` unless told otherwise)."""

    def __init__(self, K, config: VOConfig = VOConfig(), device=None):
        if config.detector not in ("orb", "sift"):
            raise ValueError(f"unknown detector {config.detector!r}")
        if config.scale_mode not in ("matched", "unmatched"):
            raise ValueError(f"unknown scale mode {config.scale_mode!r}")
        self.cfg = config
        self.device = resolve_device(device)
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32,
                                 device=self.device)
        self.capacity = _feature_capacity(config)

    def _image(self, img) -> torch.Tensor:
        return torch.as_tensor(img).to(self.device, torch.float32)

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def detect(self, img: torch.Tensor):
        """(pts (K, 2), descriptors, valid (K,)) of one frame."""
        return detect_and_describe(img, self.cfg)


class TrackingVO(_Pipeline):
    """vo_tracking-equivalent pipeline: `init(img0)`, then `step(...)` per
    frame."""

    def __init__(self, K, config: VOConfig = VOConfig(), device=None):
        super().__init__(K, config, device)
        self._gate = _AsyncScalarGate(config.fallback_gate,
                                      config.gate_max_lag)

    def init(self, img0, seed: int = 0) -> TrackingState:
        self._gate.reset()
        img0 = self._image(img0)
        return _tracking_init(self.detect(img0), img0, self._generator(seed),
                              self.cfg)

    def step(self, state: TrackingState, img, slot=None):
        """One frame. `slot` (ransac_iters, 5) replaces this step's RANSAC
        draws (tests feed the reference's)."""
        img = self._image(img)
        if self._gate.update():
            f1 = self.detect(state.pyramid[0])
            f2 = self.detect(img)
            state, out = _refresh_core(state, img, f1, f2, self.K, self.cfg,
                                       slot)
        else:
            state, out = _track_step(state, img, self.K, self.cfg, slot)
        self._gate.push(out.gate)
        return state, out


# ---------------------------------------------------------------- matching


class MatchingState(NamedTuple):
    pts: torch.Tensor  # (K, 2) previous frame's keypoints
    desc: torch.Tensor  # ORB bit planes or SIFT float descriptors
    valid: torch.Tensor  # (K,) bool
    prev3d: torch.Tensor  # (K, 3) previous frame-pair cloud
    prev3d_valid: torch.Tensor  # (K,) bool
    pose: torch.Tensor  # (4, 4)
    gen: torch.Generator  # RANSAC draws


def _matching_init(feats, gen, cfg: VOConfig) -> MatchingState:
    pts, desc, valid = feats
    return MatchingState(
        pts=pts, desc=desc, valid=valid,
        prev3d=pts.new_zeros((pts.shape[0], 3)),
        prev3d_valid=torch.zeros_like(valid),
        pose=torch.eye(4, dtype=torch.float32, device=pts.device),
        gen=gen,
    )


def _matching_core(state: MatchingState, feats, K, cfg: VOConfig, slot=None):
    """knn-match the previous frame's features against this frame's, then
    pose, scale and chaining."""
    pts2_all, desc2, valid2 = feats
    m = match_features(state.desc, desc2, state.valid, valid2, cfg)
    new_pose, cur3d, cur3d_valid, s, n_inl, pose_ok = _pose_scale_chain(
        state.pts, pts2_all[m.idx], m.valid, K, state.prev3d,
        state.prev3d_valid, state.pose, state.gen, cfg, slot,
    )
    new_state = MatchingState(
        pts=pts2_all, desc=desc2, valid=valid2, prev3d=cur3d,
        prev3d_valid=cur3d_valid, pose=new_pose, gen=state.gen,
    )
    return new_state, _untracked_output(new_pose, s, m.count(), n_inl,
                                        pose_ok, cfg)


def _untracked_output(pose, scale, n_assoc, n_inliers, pose_ok,
                      cfg: VOConfig) -> FrameOutput:
    """FrameOutput of a pipeline without a re-detect gate: the dip flag is
    this frame's alone."""
    n_assoc = n_assoc.to(torch.int32)
    health = torch.where(pose_ok, n_assoc, torch.zeros_like(n_assoc))
    return FrameOutput(
        pose=pose,
        scale=scale,
        n_assoc=n_assoc,
        n_inliers=n_inliers,
        fallback=torch.zeros((), dtype=torch.bool, device=pose.device),
        health=health,
        gate=torch.stack([(health < cfg.min_tracked).to(torch.int32),
                          health]),
    )


class MatchingVO(_Pipeline):
    """vo_matching-equivalent pipeline: detect + knn-match every frame."""

    def init(self, img0, seed: int = 0) -> MatchingState:
        return _matching_init(self.detect(self._image(img0)),
                              self._generator(seed), self.cfg)

    def step(self, state: MatchingState, img, slot=None):
        """One frame. `slot` (ransac_iters, 5) replaces this step's RANSAC
        draws (tests feed the reference's)."""
        return _matching_core(state, self.detect(self._image(img)), self.K,
                              self.cfg, slot)


# ---------------------------------------------------------------- driver


class _ArrivedPoses:
    """The `on_frame` hook of a run: each step's pose is copied to pinned
    host memory as the step is dispatched, and `on_frame(i, out)` is called,
    in order, for the steps whose copy has arrived, with `out.pose` the
    host copy (the other fields stay on the device). Nothing waits: steps
    whose copy is still in flight when the loop ends are not reported."""

    def __init__(self, on_frame):
        self.on_frame = on_frame
        self._pending: list = []  # (FrameOutput, host pose, event or None)
        self._next = 1

    def push(self, frame: FrameOutput) -> None:
        self._pending.append((frame, *_start_host_copy(frame.pose)))

    def drain(self) -> None:
        while self._pending:
            frame, host, event = self._pending[0]
            if event is not None and not event.query():
                break
            self._pending.pop(0)
            self.on_frame(self._next, frame._replace(pose=host))
            self._next += 1


def _dispatch(seq, pipeline, verbose: bool = False, on_frame=None) -> list:
    """Every step's output over a sequence (frame(i), poses). The loop
    only dispatches: nothing is read back inside it. `on_frame(i, frame)`
    is called during the loop for steps whose pose has arrived on the host
    (`_ArrivedPoses`); `frame` is the step's FrameOutput."""
    state = pipeline.init(seq.frame(0))
    hook = _ArrivedPoses(on_frame) if on_frame is not None else None
    outs = []
    for i in range(1, len(seq)):
        state, out = pipeline.step(state, seq.frame(i))
        outs.append(out)
        if hook is not None:
            hook.push(getattr(out, "frame", out))
            hook.drain()
        if verbose and i % 100 == 0:
            print(f"dispatched frame {i}")
    return outs


def _read_back(outs: list, fields) -> dict:
    """Each field of the outputs stacked over the steps, in one copy to
    the host per field."""
    return {k: torch.stack([getattr(o, k) for o in outs]).cpu().numpy()
            for k in fields}


def _trajectory(gt_poses, cols: dict):
    """(est_path, gt_path, scales, stats) from the stacked FrameOutput
    columns: x/z of each pose, the ground truth's step lengths beside the
    estimator's scales, and per-frame counts."""
    est_path = [np.zeros(2)]
    gt_path = [gt_poses[0][[0, 2], 3]]
    scales, stats = [(1.0, 1.0)], [{}]
    for i in range(1, len(cols["pose"]) + 1):
        est_path.append(cols["pose"][i - 1][[0, 2], 3])
        gt_path.append(gt_poses[i][[0, 2], 3])
        gt_scale = float(
            np.linalg.norm(gt_poses[i][:3, 3] - gt_poses[i - 1][:3, 3])
        )
        est_scale = float(cols["scale"][i - 1])
        scales.append((max(gt_scale, 1e-9), max(est_scale, 1e-9)))
        stats.append({
            "n_assoc": int(cols["n_assoc"][i - 1]),
            "n_inliers": int(cols["n_inliers"][i - 1]),
            "scale": est_scale,
            "fallback": bool(cols["fallback"][i - 1]),
            "health": int(cols["health"][i - 1]),
        })
    return np.asarray(est_path), np.asarray(gt_path), np.asarray(scales), stats


def run_vo(seq, pipeline, verbose: bool = False, on_frame=None):
    """Host loop over a sequence (frame(i), poses) for any pipeline whose
    `step` returns (state, FrameOutput). Outputs are read back once, after
    the loop. `on_frame(i, out)` (optional) is the live-view hook: called
    during the run, in order, for steps whose pose has already arrived on
    the host (`out.pose` is that host copy); it lags the device a few
    frames and never blocks the loop.

    Returns (est_path (N, 2) x/z, gt_path (N, 2), scales (N, 2) [gt, est],
    stats list of per-frame dicts)."""
    outs = _dispatch(seq, pipeline, verbose, on_frame)
    cols = _read_back(outs, FrameOutput._fields) if outs else {"pose": []}
    return _trajectory(seq.poses, cols)
