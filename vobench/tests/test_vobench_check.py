"""The comparison that decides `correct`, shown to fail: at a size the CPU
runs, a sound run passes, the control (the reference in lower precision
in the program's place) fails on every seed, and a run whose timed path
is broken underneath fails, once for each fault a cell can have."""

import pytest
import torch
import vobench_tiny as tiny

from vobench import compare

CELLS = ["tracking_orb.drive.x6", "matching_sift.drive.x6"]


class Broken:
    """A pipeline whose `step` is broken after it runs: the rest of the
    pipeline (init, the gate the harness reads) is the program's."""

    def __init__(self, pipeline, fault: str):
        self._p, self._fault = pipeline, fault

    def __getattr__(self, name):
        return getattr(self._p, name)

    def step(self, state, img):
        new, out = self._p.step(state, img)
        if self._fault == "state_unchanged":
            return state, out._replace(pose=state.pose)
        if self._fault == "half_the_points":
            field = "pts_valid" if hasattr(new, "pts_valid") else "valid"
            valid = getattr(new, field)
            half = torch.arange(valid.shape[0], device=valid.device) % 2 == 0
            return new._replace(**{field: valid & half}), out
        if self._fault == "points_altered":
            return new._replace(pts=new.pts + 0.5), out
        if self._fault == "cloud_altered":  # in the state alone
            return new._replace(prev3d=new.prev3d * 2.0), out
        if self._fault == "pose_altered":
            pose = out.pose.clone()
            pose[:3, 3] = state.pose[:3, 3] + 1.5 * (out.pose[:3, 3]
                                                     - state.pose[:3, 3])
            return new._replace(pose=pose), out._replace(pose=pose)
        raise ValueError(self._fault)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    line = tiny.run_in_process(tiny.tiny_cell(cell), seed=2**32 + 3)
    assert line["correct"], line["check"]


@pytest.mark.parametrize("seed", [11, 2**31 + 5, 3000000019])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell, seed):
    line = tiny.run_in_process(tiny.tiny_cell(cell), seed=seed, control=True)
    assert line["correct"], line["check"]
    # the harness judges the control by the cell's limits
    ok, rows = compare.judge(line["control"], tiny.tiny_cell(cell).config[
        "limits"])
    assert line["control_correct"] is ok is False, rows


# each fault a cell can have, and a fault in the state alone (the cloud
# that the next step's scale reads), which only the reference's own state
# over a chain of steps can show
FAULTS = [(cell, fault) for cell in CELLS
          for fault in ("state_unchanged", "half_the_points", "pose_altered",
                        "points_altered", "cloud_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_step_is_not_correct(cell, fault):
    line = tiny.run_in_process(tiny.tiny_cell(cell), seed=2**33 + 1,
                               wrap=lambda p: Broken(p, fault))
    assert not line["correct"], line["check"]
