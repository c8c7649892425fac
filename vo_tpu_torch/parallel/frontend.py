"""Frame-parallel frontend: batched detect/describe and pair matching over
a frame axis sharded across ranks (port of vo_tpu/parallel/frontend.py).

The reference's serial frame loop (feature_tracking.cpp:53) becomes, for
throughput work, a batch of frames split over the "frame" axis: each rank
runs the ORB frontend (kernel B2 for its Harris canvas on the card) on its
own frames with no communication, and the features stay with their frames
for per-pair matching. The online VO loop stays on one card.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..frontend.orb import OrbConfig, OrbFeatures, orb_detect_and_compute
from ..ops.hamming import Matches, match_descriptors


def _stack(items, cls):
    return cls(*(torch.stack(f) for f in zip(*items)))


def batched_orb(
    mesh: DeviceMesh,
    config: OrbConfig = OrbConfig(),
    axis: str = "frame",
):
    """Returns fn: this rank's (b, H, W) block of frames -> OrbFeatures
    with a leading dim b (frames are split in equal blocks in rank order
    along `axis`)."""
    del mesh, axis  # frames are independent: no collective
    detect = functools.partial(orb_detect_and_compute, config=config)

    def fn(frames: torch.Tensor) -> OrbFeatures:
        return _stack([detect(f) for f in frames], OrbFeatures)

    return fn


def batched_pair_match(
    mesh: DeviceMesh,
    ratio: float = 0.8,
    axis: str = "frame",
):
    """Returns fn matching this rank's descriptor batches pair by pair:
    (b, K, 256) bits x2 + (b, K) masks -> Matches with a leading dim b.
    Consecutive frames (b, b+1) pair up through shifted views."""
    del mesh, axis

    def fn(bits1, bits2, valid1, valid2) -> Matches:
        return _stack([match_descriptors(*a, ratio=ratio)
                       for a in zip(bits1, bits2, valid1, valid2)], Matches)

    return fn
