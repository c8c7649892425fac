"""Named pipeline presets (port of vo_tpu/runtime/presets.py; the tracking
presets, feature_tracking.cpp with ORB or SIFT keypoints)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..frontend.orb import OrbConfig
from ..frontend.sift import SiftConfig
from ..models.vo import TrackingVO, VOConfig, run_vo


@dataclass(frozen=True)
class Preset:
    name: str
    description: str
    make: Callable  # (K, vo_config, device) -> pipeline object
    config: VOConfig

    def build(self, K, device=None):
        return self.make(K, self.config, device=device)

    def run(self, seq, pipeline, verbose=False):
        return run_vo(seq, pipeline, verbose=verbose)


PRESETS = {
    "tracking_sift": Preset(
        "tracking_sift",
        "SIFT detect + pyramidal LK tracking, re-detect fallback <150",
        TrackingVO,
        VOConfig(detector="sift", sift=SiftConfig(nfeatures=3000)),
    ),
    "tracking_orb": Preset(
        "tracking_orb",
        "ORB detect + pyramidal LK tracking, re-detect fallback <150",
        TrackingVO,
        VOConfig(orb=OrbConfig(nfeatures=3000, fast_threshold=20.0)),
    ),
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
