"""Tracking VO with sliding-window bundle adjustment (port of
vo_tpu/models/vo_ba.py; the tracking_sift_ba and tracking_orb_ba presets).

Reference: with_bundle_adjustment.cpp, the tracking pipeline plus a
5-frame window refined by BA every 10 frames, with the estimated path of
the window's frames rewritten from the BA result (:237-247).

A step is one of four variants, track or re-detect by BA or not, chosen
on the host: the BA cadence is known there, and the re-detect comes from
the asynchronous gate, as in `TrackingVO`. The window is a set of
fixed-shape tensors in the state (ba/window.py): no image is kept and
nothing is tracked again.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ba.window import (
    WindowConfig,
    WindowState,
    run_window_ba,
    window_init,
    window_push,
    window_remap,
)
from ..ops.lk import LKCache, lk_build_pyramid, lk_make_cache, lk_pyramid_track_cached
from .vo import (
    FrameOutput,
    VOConfig,
    _AsyncScalarGate,
    _dispatch,
    _Pipeline,
    _pose_scale_chain,
    _read_back,
    _trajectory,
    match_features,
)


class BAFrameOutput(NamedTuple):
    frame: FrameOutput
    window_poses: torch.Tensor  # (W, 4, 4) BA-refined window poses
    window_count: torch.Tensor  # () frames in the window
    ba_ran: torch.Tensor  # () bool
    ba_cost0: torch.Tensor  # () robust cost before the solve
    ba_cost: torch.Tensor  # () and after it
    ba_landmarks: torch.Tensor  # () landmarks in the solve
    ba_accepted: torch.Tensor  # () window poses the solve rewrote


class TrackingBAState(NamedTuple):
    pyramid: tuple  # previous frame's halving pyramid
    lk_cache: LKCache  # previous frame's search-window origins
    pts: torch.Tensor  # (K, 2)
    pts_valid: torch.Tensor  # (K,) bool
    prev3d: torch.Tensor  # (K, 3)
    prev3d_valid: torch.Tensor  # (K,) bool
    pose: torch.Tensor  # (4, 4)
    window: WindowState
    # cross-window landmark map (WindowConfig.use_map), keyed by slot
    map_X: torch.Tensor  # (K, 3)
    map_ok: torch.Tensor  # (K,) bool
    frame_idx: torch.Tensor  # () int32
    gen: torch.Generator  # RANSAC draws
    dipped: torch.Tensor  # () int32 dip latch (see TrackingState)


def _ba_init(feats, img0, gen, cfg: VOConfig, wcfg: WindowConfig
             ) -> TrackingBAState:
    pts, _, valid = feats
    K_cap, dev = pts.shape[0], pts.device
    pyr = lk_build_pyramid(img0, cfg.lk)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    win = window_push(window_init(wcfg.window_size, K_cap, dev), eye, pts,
                      valid)
    return TrackingBAState(
        pyramid=pyr,
        lk_cache=lk_make_cache(pyr, pts, cfg.lk),
        pts=pts,
        pts_valid=valid,
        prev3d=pts.new_zeros((K_cap, 3)),
        prev3d_valid=torch.zeros_like(valid),
        pose=eye,
        window=win,
        map_X=pts.new_zeros((K_cap, 3)),
        map_ok=torch.zeros_like(valid),
        frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
        gen=gen,
        dipped=(valid.sum() < cfg.min_tracked).to(torch.int32),
    )


def _remap_to(pts_new, pts_old, valid_old, valid_new):
    """Each new slot's nearest valid old slot (the first of equals) and
    whether it lies within 1.5 px: the two detections of one frame."""
    d2 = ((pts_new[:, None, :] - pts_old[None, :, :]) ** 2).sum(-1)
    d2 = torch.where(valid_old[None, :], d2, torch.full_like(d2, torch.inf))
    old_idx = torch.argmin(d2, dim=1)
    near = torch.gather(d2, 1, old_idx[:, None])[:, 0] < 1.5 ** 2
    return old_idx, near & valid_new


def _no_ba(win: WindowState):
    zero = torch.zeros((), device=win.poses.device)
    izero = torch.zeros((), dtype=torch.int64, device=win.poses.device)
    info = {"ba_ran": izero.bool(), "ba_cost0": zero, "ba_cost": zero,
            "ba_landmarks": izero, "ba_accepted": izero}
    return win.poses, info


def _ba_step(state: TrackingBAState, img, K, cfg: VOConfig,
             wcfg: WindowConfig, feats=None, refresh: bool = False,
             do_ba: bool = False, slot=None):
    pyr2 = lk_build_pyramid(img, cfg.lk)
    if refresh:
        # re-detect + match (feature_tracking.cpp:195-220); the window's
        # tracks carry over: the fresh detection pts1 is on the same frame
        # as the old tracked points, so new slot j inherits the history of
        # the nearest old slot within 1.5 px
        (pts1, d1, v1), (p2, d2, v2) = feats
        m = match_features(d1, d2, v1, v2, cfg)
        pts2, valid = p2[m.idx], m.valid
        cache2 = lk_make_cache(pyr2, pts2, cfg.lk)
        old_idx, near_ok = _remap_to(pts1, state.pts, state.pts_valid, v1)
    else:
        pts1 = state.pts
        pts2, valid, cache2 = lk_pyramid_track_cached(
            state.lk_cache, state.pyramid, pyr2, state.pts, state.pts_valid,
            cfg.lk)

    new_pose, cur3d, cur3d_valid, s, n_inl, chain_ok = _pose_scale_chain(
        pts1, pts2, valid, K, state.prev3d, state.prev3d_valid, state.pose,
        state.gen, cfg, slot,
    )

    win, map_X, map_ok = state.window, state.map_X, state.map_ok
    if refresh:
        win = window_remap(win, old_idx, near_ok)
        map_X, map_ok = map_X[old_idx], map_ok[old_idx] & near_ok
    win = window_push(win, new_pose, pts2, valid)

    if not do_ba:
        new_win_poses, info = _no_ba(win)
    elif wcfg.use_map:
        new_win_poses, _, info, (map_X, map_ok) = run_window_ba(
            win, K, wcfg, lmap=(map_X, map_ok))
    else:
        new_win_poses, _, info = run_window_ba(win, K, wcfg)
    win = win._replace(poses=new_win_poses)
    new_pose = new_win_poses[-1]  # the (possibly refined) newest pose

    n_assoc = valid.sum().to(torch.int32)
    health = torch.where(chain_ok, n_assoc, torch.zeros_like(n_assoc))
    dip_now = (health < cfg.min_tracked).to(torch.int32)
    dipped = dip_now if refresh else torch.maximum(state.dipped, dip_now)
    new_state = TrackingBAState(
        pyramid=pyr2, lk_cache=cache2, pts=pts2, pts_valid=valid,
        prev3d=cur3d, prev3d_valid=cur3d_valid, pose=new_pose, window=win,
        map_X=map_X, map_ok=map_ok, frame_idx=state.frame_idx + 1,
        gen=state.gen, dipped=dipped,
    )
    out = BAFrameOutput(
        frame=FrameOutput(
            pose=new_pose,
            scale=s,
            n_assoc=n_assoc,
            n_inliers=n_inl,
            fallback=torch.full((), refresh, device=new_pose.device),
            health=health,
            gate=torch.stack([dipped, health]),
        ),
        window_poses=new_win_poses,
        window_count=win.count,
        ba_ran=info["ba_ran"],
        ba_cost0=info["ba_cost0"],
        ba_cost=info["ba_cost"],
        ba_landmarks=info["ba_landmarks"],
        ba_accepted=info["ba_accepted"],
    )
    return new_state, out


class TrackingBAVO(_Pipeline):
    """vo_ba-equivalent pipeline: `init(img0)`, then `step(state, img)`.

    BA runs on every `ba_every`-th frame once the window is full (a count
    the host keeps), re-detects when the asynchronous gate fires."""

    def __init__(self, K, config: VOConfig = VOConfig(),
                 window: WindowConfig = WindowConfig(), device=None):
        super().__init__(K, config, device)
        self.wcfg = window
        self._gate = _AsyncScalarGate(config.fallback_gate,
                                      config.gate_max_lag)
        self._frame_idx = 0
        self._win_fill = 0

    def init(self, img0, seed: int = 0) -> TrackingBAState:
        self._gate.reset()
        self._frame_idx = 0
        self._win_fill = 1  # init pushes frame 0
        img0 = self._image(img0)
        return _ba_init(self.detect(img0), img0, self._generator(seed),
                        self.cfg, self.wcfg)

    def step(self, state: TrackingBAState, img, slot=None):
        """One frame. `slot` (ransac_iters, 5) replaces this step's RANSAC
        draws (tests feed the reference's)."""
        refresh = self._gate.update()
        # the window's history survives re-detects (window_remap), so the
        # fill does not restart there
        self._win_fill = min(self._win_fill + 1, self.wcfg.window_size)
        self._frame_idx += 1
        do_ba = (self._frame_idx % self.wcfg.ba_every == 0
                 and self._win_fill >= self.wcfg.window_size)
        img = self._image(img)
        feats = ((self.detect(state.pyramid[0]), self.detect(img))
                 if refresh else None)
        state, out = _ba_step(state, img, self.K, self.cfg, self.wcfg, feats,
                              refresh, do_ba, slot)
        self._gate.push(out.frame.gate)
        return state, out


def run_vo_ba(seq, pipeline: TrackingBAVO, verbose: bool = False):
    """`run_vo` for the BA pipeline, with the reference's rewrite of the
    estimated path on BA frames (with_bundle_adjustment.cpp:237-247): each
    solve's window poses replace the path of the window's frames."""
    outs = _dispatch(seq, pipeline)
    if not outs:
        return _trajectory(seq.poses, {"pose": []})
    est, gt, scales, stats = _trajectory(
        seq.poses, _read_back([o.frame for o in outs], FrameOutput._fields))
    ba = _read_back(outs, BAFrameOutput._fields[1:])
    Wn = pipeline.wcfg.window_size
    for i in range(1, len(outs) + 1):
        k = i - 1
        if ba["ba_ran"][k]:
            for j in range(Wn):
                est[i - Wn + 1 + j] = ba["window_poses"][k][j][[0, 2], 3]
        stats[i].update({
            "ba_ran": bool(ba["ba_ran"][k]),
            "ba_cost0": float(ba["ba_cost0"][k]),
            "ba_cost": float(ba["ba_cost"][k]),
            "ba_landmarks": int(ba["ba_landmarks"][k]),
            "ba_accepted": int(ba["ba_accepted"][k]),
        })
        if verbose and stats[i]["ba_ran"]:
            print(f"frame {i}: BA cost {stats[i]['ba_cost0']:.1f} -> "
                  f"{stats[i]['ba_cost']:.1f} over {stats[i]['ba_landmarks']}"
                  f" landmarks, {stats[i]['ba_accepted']} poses accepted")
    return est, gt, scales, stats
