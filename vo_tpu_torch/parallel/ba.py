"""Landmark-sharded windowed BA (port of vo_tpu/parallel/ba.py).

Each rank owns L/d landmarks: their 3x3 V blocks, observations and point
updates stay local. Only the small reduced camera system (6W x 6W), the
pose gradient, the costs and the gate counts are all-reduced, inside
`ba.schur.bundle_adjust(group=...)` and `ba.window.run_window_ba(group=
...)`; every rank then solves the same replicated dense system, the
re-expression of Ceres' SPARSE_SCHUR (with_bundle_adjustment.cpp:673)
that scales in the landmark count.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ba.schur import BAConfig, BAResult, bundle_adjust
from ..ba.window import WindowConfig, WindowState, run_window_ba
from .mesh import shard_leading


def sharded_bundle_adjust(
    mesh: DeviceMesh,
    poses: torch.Tensor,
    points: torch.Tensor,
    obs: torch.Tensor,
    obs_mask: torch.Tensor,
    point_mask: torch.Tensor,
    K: torch.Tensor,
    config: BAConfig = BAConfig(),
    axis: str = "kp",
) -> BAResult:
    """bundle_adjust with the landmark axis sharded over `axis`.

    `points` (L/d, 3), `obs` (W, L/d, 2), `obs_mask` (W, L/d) and
    `point_mask` (L/d,) are this rank's landmark block; `poses` and `K`
    are replicated. Returns replicated poses, costs and n_obs and this
    rank's refined points."""
    return bundle_adjust(poses, points, obs, obs_mask, point_mask, K,
                         config=config, group=mesh.get_group(axis))


def sharded_window_ba(
    mesh: DeviceMesh,
    st: WindowState,
    K: torch.Tensor,
    cfg: WindowConfig,
    lmap=None,
    axis: str = "kp",
):
    """The whole window step of `ba/window.py:run_window_ba` (landmark
    build, gates, hold-out accept, optional map reuse, Schur solve,
    per-pose accept) with the slot axis sharded over `axis`.

    `st.obs` (W, K/d, 2) and `st.valid` (W, K/d) are this rank's slot
    block (`st.poses` and `st.count` replicated); `lmap`, where given, is
    this rank's (map_X (K/d, 3), map_ok (K/d,)). The hold-out picks slots
    by global index, so the landmark and hold-out counts equal the dense
    window's; the sums differ from it by their association only. Returns
    what `run_window_ba` returns: poses, accepts and info replicated, the
    map this rank's block."""
    return run_window_ba(st, K, cfg, lmap=lmap, group=mesh.get_group(axis))


def shard_window(mesh: DeviceMesh, st: WindowState, axis: str = "kp"
                 ) -> WindowState:
    """This rank's block of a whole window's slot axis (equal blocks in
    rank order along `axis`)."""
    def cut(x):  # the slot axis is dim 1
        return shard_leading(mesh, axis, x.transpose(0, 1)).transpose(0, 1)

    return st._replace(obs=cut(st.obs), valid=cut(st.valid))
