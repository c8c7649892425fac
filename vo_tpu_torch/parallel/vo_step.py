"""The whole tracking step with the keypoint axis sharded over ranks (port
of vo_tpu/parallel/vo_step.py).

vo_tpu jits its unmodified step over a mesh and lets GSPMD place the
collectives. PyTorch has no such compiler, so the port writes the one
collective the step needs: each rank tracks its block of keypoints
through kernel B1 (parallel/tracking.py, no collective), then one
all-gather, in rank order, brings back every rank's previous and tracked
points, their validity and the previous frame-pair cloud. Every rank runs
the replicated pose chain (`models/vo.py:_finish_tracking_step`: RANSAC
from one seed on every rank, triangulation, scale, chaining) on arrays
that equal the dense step's bit for bit, and keeps its block of the new
keypoint leaves. So the sharded step equals the dense step exactly where
vo_tpu can only bound the gap (`parity_vs_single_device`).

The pyramid, pose, generator, health and dip latch are replicated. A
re-detect (`ShardedTrackingVO`) gathers the state and runs the dense
refresh, as vo_tpu shards no refresh either. Every rank must take the
same branch, or their collectives no longer pair up, so on more than one
rank the re-detect gate reads each step's latch at once ("sync"): the
async gate's answer depends on when each rank's copy lands.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.vo import (
    TrackingState,
    TrackingVO,
    VOConfig,
    _AsyncScalarGate,
    _finish_tracking_step,
    _refresh_core,
    _track_step,
)
from ..ops.lk import LKCache, lk_build_pyramid
from .mesh import (
    all_gather_leading,
    axis_size,
    max_rank_deviation,
    rank_device,
    shard_leading,
)
from .tracking import sharded_lk_track

KP = "kp"


def tracking_state_specs(cfg: VOConfig, n_levels: int) -> TrackingState:
    """Which leaves of a TrackingState are keypoint-sharded: "kp" on the
    leaves that carry a keypoint axis (dim 0), None on the replicated
    ones (pyramid, pose, generator, health, dip latch)."""
    del cfg  # every LK layout of the port keeps origins keypoint-major
    return TrackingState(
        pyramid=(None,) * n_levels,
        lk_cache=LKCache(origins=(KP,) * n_levels),
        pts=KP,
        pts_valid=KP,
        prev3d=KP,
        prev3d_valid=KP,
        pose=None,
        gen=None,
        health=None,
        dipped=None,
    )


def _map_kp(fn, cfg: VOConfig, state: TrackingState) -> TrackingState:
    """`fn` applied to every keypoint-sharded leaf of `state`."""

    def walk(spec, x):
        if spec == KP:
            return fn(x)
        if isinstance(spec, tuple):
            vals = [walk(s, v) for s, v in zip(spec, x)]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        return x

    return walk(tracking_state_specs(cfg, cfg.lk.max_level + 1), state)


def pad_capacity(cfg: VOConfig, state: TrackingState, multiple: int
                 ) -> TrackingState:
    """Pad every keypoint leaf to the next multiple with invalid slots
    (zeros, False). The pipeline is masked and fixed-shape, so the extra
    slots flow through LK, RANSAC and scale as dead tracks."""

    def pad(x):
        k = -x.shape[0] % multiple
        return torch.cat([x, x.new_zeros((k,) + tuple(x.shape[1:]))]) \
            if k else x

    return _map_kp(pad, cfg, state)


def shard_state(mesh: DeviceMesh, cfg: VOConfig, state: TrackingState,
                axis: str = KP) -> TrackingState:
    """This rank's block of a (capacity-padded) TrackingState."""
    return _map_kp(lambda x: shard_leading(mesh, axis, x), cfg, state)


def gather_state(mesh: DeviceMesh, cfg: VOConfig, state: TrackingState,
                 axis: str = KP) -> TrackingState:
    """The whole TrackingState back from every rank's block."""
    group = mesh.get_group(axis)
    return _map_kp(lambda x: all_gather_leading(x, group), cfg, state)


def make_sharded_tracking_step(mesh: DeviceMesh, cfg: VOConfig,
                               axis: str = KP):
    """Returns ``fn(state, img, K, slot=None) -> (state, FrameOutput)``
    over this rank's block of a sharded TrackingState (`shard_state`);
    `img` and `K` are replicated, the FrameOutput comes out replicated.
    The capacity must be a multiple of the axis size (`pad_capacity`)."""
    group, i = mesh.get_group(axis), mesh.get_local_rank(axis)

    def step(state: TrackingState, img, K, slot=None):
        pyr2 = lk_build_pyramid(img, cfg.lk)
        tracked, status, cache2 = sharded_lk_track(
            mesh, state.lk_cache, state.pyramid, pyr2, state.pts,
            state.pts_valid, cfg.lk, axis)
        n = tracked.shape[0]
        # one gather for the five keypoint arrays the pose chain reads;
        # the flags travel as exact 0.0 / 1.0
        full = all_gather_leading(torch.cat([
            state.pts, tracked, state.prev3d, status[:, None].float(),
            state.prev3d_valid[:, None].float()], 1), group)
        pts1, pts2, prev3d = (full[:, a:b].contiguous()
                              for a, b in ((0, 2), (2, 4), (4, 7)))
        dense = state._replace(prev3d=prev3d, prev3d_valid=full[:, 8] > 0.5)
        new, out = _finish_tracking_step(
            dense, pyr2, cache2, pts1, pts2, full[:, 7] > 0.5, K, cfg,
            fallback=False, slot=slot)
        mine = slice(i * n, (i + 1) * n)
        return new._replace(pts=tracked, pts_valid=status,
                            prev3d=new.prev3d[mine],
                            prev3d_valid=new.prev3d_valid[mine]), out

    return step


class ShardedTrackingVO(TrackingVO):
    """TrackingVO with its track steps sharded over `axis` of `mesh`: every
    rank builds one with the same arguments and drives it with the same
    frames (e.g. through `run_vo`). `init` detects on the whole frame and
    keeps this rank's block; a re-detect gathers the state and runs the
    dense refresh. On more than one rank the gate runs in "sync" mode
    whatever `config.fallback_gate` says, so every rank re-detects on the
    same step (module docstring)."""

    def __init__(self, mesh: DeviceMesh, K, config: VOConfig = VOConfig(),
                 axis: str = KP):
        super().__init__(K, config, device=rank_device())
        self.mesh, self.axis = mesh, axis
        self._sharded_step = make_sharded_tracking_step(mesh, config, axis)
        if axis_size(mesh, axis) > 1:
            self._gate = _AsyncScalarGate("sync", config.gate_max_lag)

    def _shard(self, state: TrackingState) -> TrackingState:
        padded = pad_capacity(self.cfg, state, axis_size(self.mesh, self.axis))
        return shard_state(self.mesh, self.cfg, padded, self.axis)

    def init(self, img0, seed: int = 0) -> TrackingState:
        return self._shard(super().init(img0, seed))

    def step(self, state: TrackingState, img, slot=None):
        img = self._image(img)
        if self._gate.update():
            full = _map_kp(lambda x: x[:self.capacity], self.cfg,
                           gather_state(self.mesh, self.cfg, state, self.axis))
            f1 = self.detect(full.pyramid[0])
            f2 = self.detect(img)
            full, out = _refresh_core(full, img, f1, f2, self.K, self.cfg,
                                      slot)
            state = self._shard(full)
        else:
            state, out = self._sharded_step(state, img, self.K, slot)
        self._gate.push(out.gate)
        return state, out


def _clone_generator(gen: torch.Generator) -> torch.Generator:
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def parity_vs_single_device(mesh: DeviceMesh, cfg: VOConfig,
                            state: TrackingState, img, K, axis: str = KP
                            ) -> dict:
    """One sharded step against the dense step on the same capacity-padded
    state (`state` is the whole state, the same on every rank), each from
    its own copy of the generator. The port's step is exact, so this
    raises unless poses, n_assoc and n_inliers are bit-equal and every
    rank holds rank 0's pose (vo_tpu can only bound the gap: rotation
    0.01 deg, translation direction 0.5 deg, magnitude 5 %)."""
    state = pad_capacity(cfg, state, axis_size(mesh, axis))
    _, ref = _track_step(state._replace(gen=_clone_generator(
        state.gen)), img, K, cfg)
    sh = shard_state(mesh, cfg, state._replace(gen=_clone_generator(
        state.gen)), axis)
    _, out = make_sharded_tracking_step(mesh, cfg, axis)(sh, img, K)
    res = {
        "n_assoc_delta": abs(int(out.n_assoc) - int(ref.n_assoc)),
        "n_inlier_delta": abs(int(out.n_inliers) - int(ref.n_inliers)),
        "exact": bool(torch.equal(out.pose, ref.pose)
                      and int(out.n_assoc) == int(ref.n_assoc)
                      and int(out.n_inliers) == int(ref.n_inliers)),
        "rank_dev": max_rank_deviation(out.pose, mesh.get_group(axis)),
    }
    if not res["exact"] or res["rank_dev"] != 0.0:
        raise AssertionError(f"sharded step differs from the dense: {res}")
    return res
