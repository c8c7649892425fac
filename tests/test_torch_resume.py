"""Interrupted and resumed runs of the port's CheckpointingRunner, held
exactly to the uninterrupted checkpointed run (the vo_tpu runner's
contract, tests/test_checkpoint.py): `tracking_orb` at 240x320 through a
textureless frame whose dip the checkpoint carries in its gate snapshot
(the re-detect comes after the resume), and the BA
pipeline resumed just before a BA step. Both use the sync re-detect gate,
whose decisions do not depend on timing."""

import numpy as np
import pytest

from vo_tpu_torch.ba.window import WindowConfig
from vo_tpu_torch.data.synthetic import SyntheticSequence
from vo_tpu_torch.frontend.orb import OrbConfig
from vo_tpu_torch.models.vo import TrackingVO, VOConfig
from vo_tpu_torch.models.vo_ba import TrackingBAVO
from vo_tpu_torch.runtime.checkpoint import CheckpointingRunner
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")

CFG = VOConfig(orb=OrbConfig(nfeatures=500, n_levels=4), ransac_iters=64,
               fallback_gate="sync")


class _Frames:
    """The first `n` frames of a sequence, frame `blank` textureless."""

    def __init__(self, seq, n, blank=None):
        self.poses, self.K = seq.poses[:n], seq.K
        self._seq, self._n, self._blank = seq, n, blank

    def __len__(self):
        return self._n

    def frame(self, i):
        if i == self._blank:
            return np.full(self._seq.frame(0).shape, 128.0, np.float32)
        return self._seq.frame(i)


def _steps(vo):
    """Record each step's FrameOutput / BAFrameOutput fields on the host."""
    log = []
    step = vo.step

    def spy(state, img):
        state, out = step(state, img)
        f = getattr(out, "frame", out)
        rec = {"fallback": bool(f.fallback), "n_assoc": int(f.n_assoc)}
        if hasattr(out, "ba_ran"):
            rec.update(ba_ran=bool(out.ba_ran),
                       ba_accepted=int(out.ba_accepted),
                       window_poses=out.window_poses.numpy().copy())
        log.append(rec)
        return state, out

    vo.step = spy
    return log


def _interrupted(make, seq, n, cut, every, tmp_path):
    """(uninterrupted run, its step log, resumed run, the resumed half's
    step log): the second run stops after `cut` frames, the third resumes
    from its checkpoint over all `n`."""
    full_vo = make()
    full_log = _steps(full_vo)
    full = CheckpointingRunner(full_vo, str(tmp_path / "full.npz"),
                               every=every).run(seq(n))
    ckpt = str(tmp_path / "cut.npz")
    CheckpointingRunner(make(), ckpt, every=every).run(seq(cut))
    resumed_vo = make()
    resumed_log = _steps(resumed_vo)
    resumed = CheckpointingRunner(resumed_vo, ckpt, every=every).run(
        seq(n), verbose=True)
    return full, full_log, resumed, resumed_log


def _assert_same(full, resumed):
    for a, b in zip(full[:3], resumed[:3]):  # est, gt, scales
        np.testing.assert_array_equal(b, a)


def test_resume_tracking_orb(tmp_path, capsys):
    base = SyntheticSequence.generate(n_frames=12, shape=(240, 320))
    full, full_log, resumed, log = _interrupted(
        lambda: TrackingVO(base.K, CFG, device="cpu"),
        lambda n: _Frames(base, n, blank=7), 12, 9, 4, tmp_path)
    assert "resumed at frame 9" in capsys.readouterr().out
    _assert_same(full, resumed)
    assert len(log) == 12 - 9  # steps 9..11 only
    # step 8 finds no texture after the blank frame 7; its dip is still in
    # the gate's inbox at the checkpoint (cursor 9), so the re-detect at
    # step 9 comes from the gate snapshot
    redetects = [i + 1 for i, r in enumerate(full_log) if r["fallback"]]
    assert redetects == [9]
    assert [9 + i for i, r in enumerate(log) if r["fallback"]] == redetects
    assert resumed[3][1:9] == [{"resumed": True}] * 8


def test_resume_tracking_ba_before_a_ba_step(tmp_path):
    base = SyntheticSequence.generate(n_frames=10, shape=(240, 320),
                                      n_points=3000)
    wcfg = WindowConfig(window_size=3, ba_every=4)
    # the cut run checkpoints after step 3 (cursor 4): the resumed run's
    # first step is a BA step, and the BA cadence and window fill come from
    # the checkpoint's host counters
    full, full_log, resumed, log = _interrupted(
        lambda: TrackingBAVO(base.K, CFG, wcfg, device="cpu"),
        lambda n: _Frames(base, n), 10, 5, 3, tmp_path)
    _assert_same(full, resumed)
    tail = full_log[3:]
    assert [r["ba_ran"] for r in log] == [r["ba_ran"] for r in tail]
    assert [i + 4 for i, r in enumerate(log) if r["ba_ran"]] == [4, 8]
    assert [r["ba_accepted"] for r in log] == [r["ba_accepted"] for r in tail]
    assert any(r["ba_accepted"] for r in log)
    for a, b in zip(tail, log):
        np.testing.assert_array_equal(b["window_poses"], a["window_poses"])
    # each solve's window poses replace the path of its frames (2..4 at
    # step 4, 6..8 at step 8), in the resumed path too
    for k in (4, 8):
        wp = log[k - 4]["window_poses"]
        for j in range(3):
            np.testing.assert_array_equal(resumed[0][k - 2 + j],
                                          wp[j][[0, 2], 3])
