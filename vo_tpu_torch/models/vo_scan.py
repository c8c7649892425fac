"""Scan-mode stepping (port of vo_tpu/models/vo_scan.py).

vo_tpu compiles a `lax.scan` over a staged chunk of frames, one device
program per chunk, for offline and batch work; its results are the step
loop's with the sync re-detect gate (`VOConfig.fallback_gate="sync"`):
a tracking step re-detects when the previous step's `state.health` is
below `min_tracked`. PyTorch eager builds no program per chunk, so the
port's scan mode is that step loop itself: `run_vo` over the pipeline with
the sync gate. The gate reads each step's count back as it is pushed, one
device sync per step, where vo_tpu's scan branches on the device.

As in vo_tpu, `MatchingVO` and `TrackingVO` (and their subclasses) are
accepted and other pipelines raise TypeError; the scan runs at the state's
capacity.
"""

from __future__ import annotations

import copy

from .vo import MatchingVO, TrackingVO, _AsyncScalarGate, run_vo


def run_vo_scan(seq, pipeline):
    """`run_vo` in scan mode. Returns the same (est_path, gt_path, scales,
    stats) tuple; a TrackingVO runs on a copy of `pipeline` with the sync
    gate, the caller's pipeline keeps its own."""
    if isinstance(pipeline, TrackingVO):
        pipeline = copy.copy(pipeline)
        pipeline.cfg = pipeline.cfg._replace(fallback_gate="sync")
        pipeline._gate = _AsyncScalarGate("sync", pipeline.cfg.gate_max_lag)
    elif not isinstance(pipeline, MatchingVO):
        raise TypeError(f"scan mode supports MatchingVO / TrackingVO, got "
                        f"{type(pipeline).__name__}")
    return run_vo(seq, pipeline)
