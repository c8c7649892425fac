"""Keypoint-sharded LK tracking (port of vo_tpu/parallel/tracking.py).

The per-point work of the tracker is independent point by point, so the
"kp" axis shards it: points, their validity and their window origins are
split over the ranks, the pyramids are replicated (one frame), and each
rank tracks its block through kernel B1 with no collective at all. B1
ends each point on its own (no batch-wide early exit to agree on, unlike
vo_tpu's lanes loop, which must psum its counts across the mesh and pins
the sharded path to that layout), so a shard's points come out bit for bit
as the dense tracker's.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.lk import LKCache, LKConfig, lk_make_cache, lk_pyramid_track_cached


def sharded_lk_track(
    mesh: DeviceMesh,
    cache: LKCache,
    pyr1: tuple,
    pyr2: tuple,
    pts: torch.Tensor,
    valid: torch.Tensor,
    config: LKConfig = LKConfig(),
    axis: str = "kp",
):
    """lk_pyramid_track_cached on this rank's keypoint block along `axis`:
    `pts`, `valid` and `cache` are the block, the pyramids replicated.
    Returns this rank's (new_pts, status, cache2), equal to the dense
    tracker's rows."""
    del mesh, axis  # no collective: every point is tracked on its own
    return lk_pyramid_track_cached(cache, pyr1, pyr2, pts, valid, config)


def sharded_lk_make_cache(
    mesh: DeviceMesh,
    pyr: tuple,
    pts: torch.Tensor,
    config: LKConfig = LKConfig(),
    axis: str = "kp",
) -> LKCache:
    """This rank's block of the window cache (init and re-detects)."""
    del mesh, axis
    return lk_make_cache(pyr, pts, config)
