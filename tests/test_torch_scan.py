"""Scan-mode stepping of the port (vo_tpu_torch.models.vo_scan) against the
port's own step loop, on the CPU (tracking at 240x320, matching at
120x160).

`run_vo_scan` must equal `run_vo` bit for bit: tracking with the sync gate
(the scan's re-detect rule) whatever gate the pipeline was given, matching
as it is, both drawing from the same RANSAC generator. vo_tpu's own scan
tests compile a whole JAX pipeline and are marked slow; the port's step
loop is held to vo_tpu's step by step in
tests/test_torch_pipeline.py and tests/test_torch_matching.py, so no JAX
runs here.
"""

import numpy as np
import pytest

from vo_tpu_torch.ba.window import WindowConfig
from vo_tpu_torch.data.synthetic import SyntheticSequence
from vo_tpu_torch.frontend.orb import OrbConfig
from vo_tpu_torch.models.vo import MatchingVO, TrackingVO, VOConfig, run_vo
from vo_tpu_torch.models.vo_3frame import ThreeFrameVO
from vo_tpu_torch.models.vo_ba import TrackingBAVO
from vo_tpu_torch.models.vo_scan import run_vo_scan
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")

BLANK = 6


class _Blanked:
    """A sequence with one frame replaced by the flat background: the step
    out of it finds no texture and the step after re-detects."""

    def __init__(self, seq, blank: int):
        self.seq, self.blank, self.poses = seq, blank, seq.poses

    def __len__(self):
        return len(self.seq)

    def frame(self, i):
        img = self.seq.frame(i)
        return np.full_like(img, 128.0) if i == self.blank else img


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence.generate(n_frames=12, shape=(240, 320), seed=3)


@pytest.fixture(scope="module")
def small():
    """Matching detects every frame: 7 frames at 120x160."""
    return SyntheticSequence.generate(n_frames=7, shape=(120, 160), seed=3)


def _cfg(**kw):
    return VOConfig(orb=OrbConfig(nfeatures=400, n_levels=3),
                    ransac_iters=128, fallback_gate="sync", **kw)


def _same_run(a, b):
    est_a, gt_a, sc_a, st_a = a
    est_b, gt_b, sc_b, st_b = b
    np.testing.assert_array_equal(est_b, est_a)
    np.testing.assert_array_equal(gt_b, gt_a)
    np.testing.assert_array_equal(sc_b, sc_a)
    assert st_b == st_a  # n_assoc, n_inliers, scale, fallback, health


def test_tracking_scan_equals_sync_step_loop(seq):
    blanked = _Blanked(seq, BLANK)
    loop = run_vo(blanked, TrackingVO(seq.K, _cfg(), device="cpu"))
    scan = run_vo_scan(blanked, TrackingVO(seq.K, _cfg(), device="cpu"))
    _same_run(loop, scan)
    redetects = [i for i, s in enumerate(scan[3]) if s.get("fallback")]
    # the step out of the blank frame keeps no track; the next re-detects
    assert any(BLANK < i <= BLANK + 3 for i in redetects), redetects
    assert all(s["n_assoc"] > 0 for s in scan[3][1:BLANK + 1])


def test_tracking_scan_uses_the_sync_gate(seq):
    """A pipeline built with the async gate scans with the sync gate, as
    vo_tpu's scan does, and keeps its own gate for the step loop."""
    blanked = _Blanked(seq, BLANK)
    vo = TrackingVO(seq.K, _cfg()._replace(fallback_gate="async"),
                    device="cpu")
    _same_run(run_vo(blanked, TrackingVO(seq.K, _cfg(), device="cpu")),
              run_vo_scan(blanked, vo))
    assert vo.cfg.fallback_gate == "async" and vo._gate.mode == "async"


def test_matching_scan_equals_step_loop(small):
    cfg = _cfg(scale_mode="unmatched")
    loop = run_vo(small, MatchingVO(small.K, cfg, device="cpu"))
    scan = run_vo_scan(small, MatchingVO(small.K, cfg, device="cpu"))
    _same_run(loop, scan)
    assert np.isfinite(scan[0]).all()


@pytest.mark.parametrize("make", [
    lambda K, cfg: TrackingBAVO(K, cfg, WindowConfig(window_size=4,
                                                     ba_every=8),
                                device="cpu"),
    lambda K, cfg: ThreeFrameVO(K, cfg, device="cpu"),
], ids=["TrackingBAVO", "ThreeFrameVO"])
def test_scan_rejects_other_pipelines(seq, make):
    with pytest.raises(TypeError, match="scan mode"):
        run_vo_scan(seq, make(seq.K, _cfg()))


def test_scan_runs_a_subclass_own_step(small):
    """A TrackingVO subclass scans through its own step, with the sync
    gate."""
    modes = []

    class OwnStep(TrackingVO):
        def step(self, state, img, slot=None):
            modes.append(self._gate.mode)
            return super().step(state, img, slot)

    cfg = _cfg()._replace(fallback_gate="async")
    scan = run_vo_scan(small, OwnStep(small.K, cfg, device="cpu"))
    assert modes == ["sync"] * (len(small) - 1)
    _same_run(run_vo(small, TrackingVO(small.K, _cfg(), device="cpu")), scan)
