"""The port's presets through their entry points, the port alone, on the
CPU at 240x320: all eight of vo_tpu's names with its configurations, the
matching presets over 8 frames and tracking_sift_ba over 24 with its
window solved twice. (vo_tpu's own runs of these presets would compile
its detect and LK programs: the per-step parity against vo_tpu is in
tests/test_torch_matching.py and tests/test_torch_ba.py.)
"""

import dataclasses

import numpy as np
import pytest

from vo_tpu.runtime.presets import PRESETS as JPRESETS
from vo_tpu_torch.ba.window import WindowConfig
from vo_tpu_torch.data.synthetic import SyntheticSequence
from vo_tpu_torch.frontend.orb import OrbConfig
from vo_tpu_torch.frontend.sift import SiftConfig
from vo_tpu_torch.models.vo_ba import TrackingBAVO
from vo_tpu_torch.runtime.presets import PRESETS
from vo_tpu_torch.utils.metrics import compute_ate
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")


# Fields of vo_tpu's configurations that the port does not have, none of
# them set by a preset. Three select a TPU implementation of one function:
# `layout` the LK window storage (the port has one layout), `exit_mult` the
# LK loop's early exit (the port ends each point on its own), `axis_name` a
# mesh axis inside LK (the port's sharded step needs no collective inside
# LK). `canvas` selects vo_tpu's per-level ORB and per-octave SIFT detects,
# slower duplicates of the canvas detect that every preset runs, and
# `tier_capacities` the tiered lane capacity, which no preset sets and
# whose B1 time on the H100 is in PERF.md.
NOT_PORTED = {"exit_mult", "axis_name", "layout", "canvas", "tier_capacities"}


def _same_config(t, j, where):
    extra = set(j._fields) - set(t._fields)
    assert extra <= NOT_PORTED, (where, extra)
    for k in t._fields:
        a, b = getattr(t, k), getattr(j, k)
        if hasattr(a, "_fields"):
            _same_config(a, b, f"{where}.{k}")
        else:
            assert a == b, (where, k, a, b)


def test_presets_match_vo_tpu():
    """The port's presets: vo_tpu's eight names, each with vo_tpu's
    configuration (field by field, nested configs included) and pipeline
    class name."""
    assert sorted(PRESETS) == sorted(JPRESETS)
    for name, p in PRESETS.items():
        j = JPRESETS[name]
        assert p.make.__name__ == j.make.__name__
        _same_config(p.config, j.config, name)
        assert (p.window is None) == (j.window is None)
        if p.window is not None:
            _same_config(p.window, j.window, name)


def _small(preset, window=None):
    """The preset at 240x320: 500 features (4 ORB levels), sync gate; a BA
    preset's window replaced by `window`."""
    cfg = preset.config._replace(
        orb=OrbConfig(nfeatures=500, n_levels=4),
        sift=SiftConfig(nfeatures=500), fallback_gate="sync",
        min_tracked=60 if preset.config.detector == "sift" else 150,
    )
    return dataclasses.replace(preset, config=cfg,
                               window=window or preset.window)


def _rotation_errors(seq, poses):
    """Per step, the angle (deg) between the estimated and the true
    relative rotation."""
    out = []
    for i in range(1, len(poses)):
        A = np.linalg.inv(seq.poses[i - 1]) @ seq.poses[i]
        B = np.linalg.inv(poses[i - 1]) @ poses[i]
        c = (np.trace(A[:3, :3].T @ B[:3, :3]) - 1.0) / 2.0
        out.append(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
    return np.array(out)


# matching_orb_3d_no_correspond is matching_orb under another name (the
# same pipeline and configuration in both packages): one run serves both.
TWINS = {"matching_orb": "matching_orb_3d_no_correspond"}


@pytest.mark.parametrize("name", ["matching_orb", "matching_sift",
                                  "matching_orb_3d_correspond"])
def test_preset_end_to_end(name):
    """Each matching preset through its entry points, the port alone, 8
    frames at 240x320. Healthy: finite, every step holds a pose, the
    rotations track the truth (median error < 0.5 deg), and the ATE is
    under half that of standing still. (At this size the translation
    direction of one step is poorly fixed: ~1 px of parallax, and ORB's
    FAST corners are pixel-quantised; the KITTI-shape run on the card
    holds ATE to vo_tpu's.)"""
    if name in TWINS:
        twin = PRESETS[TWINS[name]]
        assert twin.make is PRESETS[name].make
        assert twin.config == PRESETS[name].config and twin.window is None
    seq = SyntheticSequence.generate(n_frames=8, shape=(240, 320),
                                     n_points=3000)
    preset = _small(PRESETS[name])
    vo = preset.build(seq.K, device="cpu")
    outs, step = [], vo.step

    def recorded(state, img):
        state, out = step(state, img)
        outs.append(out)
        return state, out

    vo.step = recorded
    est, gt, _, stats = preset.run(seq, vo)
    assert np.isfinite(est).all()
    assert all(s["health"] > 0 for s in stats[1:])
    poses = [np.eye(4)] + [o.pose.double().numpy() for o in outs]
    assert np.median(_rotation_errors(seq, poses)) < 0.5
    ate, _ = compute_ate(gt, est)
    still, _ = compute_ate(gt, np.zeros_like(gt))
    assert ate < 0.5 * still, (ate, still)


def test_tracking_ba_end_to_end():
    """TrackingBAVO through the tracking_sift_ba preset, the port alone:
    24 frames at 240x320 with a 4-frame window solved every 8 frames. BA
    runs at frames 8 and 16, each solve lowers its cost, and poses are
    accepted; the path stays finite and the rewritten window frames too.
    (tracking_orb_ba, the same pipeline over ORB, runs on the card in
    tests/test_torch_cuda.py.)"""
    seq = SyntheticSequence.generate(n_frames=24, shape=(240, 320),
                                     n_points=3000)
    preset = _small(PRESETS["tracking_sift_ba"],
                    WindowConfig(window_size=4, ba_every=8))
    vo = preset.build(seq.K, device="cpu")
    assert isinstance(vo, TrackingBAVO)
    est, gt, _, stats = preset.run(seq, vo)
    assert np.isfinite(est).all() and len(est) == 24
    ran = [i for i, s in enumerate(stats) if s.get("ba_ran")]
    assert ran == [8, 16], ran
    for i in ran:
        s = stats[i]
        assert s["ba_cost"] < s["ba_cost0"], s
        assert s["ba_landmarks"] >= 20
    assert sum(stats[i]["ba_accepted"] for i in ran) > 0
    print([(stats[i]["ba_cost0"], stats[i]["ba_cost"],
            stats[i]["ba_accepted"]) for i in ran])
