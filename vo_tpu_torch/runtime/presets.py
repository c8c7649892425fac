"""Named pipeline presets (port of vo_tpu/runtime/presets.py): every
published configuration of the reference, under vo_tpu's names and with
its configurations."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..ba.window import WindowConfig
from ..frontend.orb import OrbConfig
from ..frontend.sift import SiftConfig
from ..models.vo import MatchingVO, TrackingVO, VOConfig, run_vo
from ..models.vo_3frame import ThreeFrameVO
from ..models.vo_ba import TrackingBAVO, run_vo_ba


@dataclass(frozen=True)
class Preset:
    name: str
    description: str
    make: Callable  # (K, vo_config[, window], device=...) -> pipeline
    config: VOConfig
    window: WindowConfig | None = None  # BA presets only

    def build(self, K, device=None):
        if self.window is not None:
            return self.make(K, self.config, self.window, device=device)
        return self.make(K, self.config, device=device)

    def run(self, seq, pipeline, verbose=False, on_frame=None):
        if self.window is not None:
            return run_vo_ba(seq, pipeline, verbose=verbose,
                             on_frame=on_frame)
        return run_vo(seq, pipeline, verbose=verbose, on_frame=on_frame)


_ORB = VOConfig(orb=OrbConfig(nfeatures=3000, fast_threshold=20.0))
_SIFT = VOConfig(detector="sift", sift=SiftConfig(nfeatures=3000))


PRESETS = {
    # feature_matching.cpp with cv::SIFT + FLANN KDTree
    "matching_sift": Preset(
        "matching_sift",
        "SIFT detect+describe every frame, L2 knn(2) ratio matching, "
        "unmatched-cloud scale (feature_matching.cpp)",
        MatchingVO,
        _SIFT._replace(scale_mode="unmatched"),
    ),
    # feature_matching.cpp with cv::ORB(3000) + FLANN LSH
    "matching_orb": Preset(
        "matching_orb",
        "ORB-3000 + exact Hamming knn(2) matching, unmatched-cloud scale",
        MatchingVO,
        _ORB._replace(scale_mode="unmatched"),
    ),
    # feature_tracking.cpp with SIFT keypoints
    "tracking_sift": Preset(
        "tracking_sift",
        "SIFT detect + pyramidal LK tracking, re-detect fallback <150",
        TrackingVO,
        _SIFT,
    ),
    # feature_tracking.cpp with ORB keypoints
    "tracking_orb": Preset(
        "tracking_orb",
        "ORB detect + pyramidal LK tracking, re-detect fallback <150",
        TrackingVO,
        _ORB,
    ),
    # feature_tracking_scale.py (3-frame matched-cloud scale)
    "matching_orb_3d_correspond": Preset(
        "matching_orb_3d_correspond",
        "ORB matching with 3-frame correspondence triplets and "
        "matched-pair scale (feature_tracking_scale.py)",
        ThreeFrameVO,
        _ORB,
    ),
    # no_feature_tracking_scale.py (independent-cloud scale)
    "matching_orb_3d_no_correspond": Preset(
        "matching_orb_3d_no_correspond",
        "ORB matching with unmatched consecutive-cloud scale "
        "(no_feature_tracking_scale.py)",
        MatchingVO,
        _ORB._replace(scale_mode="unmatched"),
    ),
    # with_bundle_adjustment.cpp (SIFT + LK + windowed BA)
    "tracking_sift_ba": Preset(
        "tracking_sift_ba",
        "SIFT + LK tracking + 5-frame windowed BA every 10 frames "
        "(with_bundle_adjustment.cpp)",
        TrackingBAVO,
        _SIFT,
        window=WindowConfig(window_size=5, ba_every=10),
    ),
    # ORB + BA (not a published reference configuration)
    "tracking_orb_ba": Preset(
        "tracking_orb_ba",
        "ORB + LK tracking + 5-frame windowed BA every 10 frames",
        TrackingBAVO,
        _ORB,
        window=WindowConfig(window_size=5, ba_every=10),
    ),
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
