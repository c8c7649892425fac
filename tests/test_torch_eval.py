"""The port's long-sequence eval (scripts/eval_torch_synthetic.py) against
vo_tpu's (scripts/eval_synthetic.py): the same sequences, the same results
document from the same bundles, the hold against vo_tpu's bundles, and the
bundle layout of a run."""

import importlib.util
import json
import os

import numpy as np
import pytest

from vo_tpu.data.synthetic import SyntheticSequence as RefSequence
from vo_tpu_torch.data.synthetic import SyntheticSequence
from vo_tpu_torch.frontend.orb import OrbConfig
from vo_tpu_torch.models.vo import TrackingVO, VOConfig
from vo_tpu_torch.runtime.presets import PRESETS, Preset

from torch_parity import low_cpu_priority  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("low_cpu_priority")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ev = _load("eval_torch_synthetic")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sequence", ["hard", "clean"])
def test_sequences_match_vo_tpu(sequence, seed):
    """40 frames (k = 4: dropouts 12-13, 24, 32-33 on the hard sequence):
    poses, K and the landmarks bit for bit, and the frames outside and
    inside each dropout stretch."""
    gen = "generate_hard" if sequence == "hard" else "generate_clean"
    ref = getattr(RefSequence, gen)(n_frames=40, seed=seed)
    port = ev.make_sequence(sequence, 40, seed)
    assert isinstance(port, SyntheticSequence)
    for a, b in ((port.poses, ref.poses), (port.K, ref.K),
                 (port.points_w, ref.points_w),
                 (port.contrast, ref.contrast)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert port.dropouts == ref.dropouts
    assert port.dropouts == (((12, 14), (24, 25), (32, 34))
                             if sequence == "hard" else ())
    for i in (0, 13, 24, 33):
        a, b = port.frame(i), ref.frame(i)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    staged = ev.StagedSequence(np.stack([port.frame(0), port.frame(13)]),
                               port.poses, port.K, "cpu")
    assert np.array_equal(staged.frame(1).numpy(), ref.frame(13))


def test_render_gives_every_frame():
    seq = SyntheticSequence.generate(n_frames=3, seed=2)
    frames = ev.render(seq)
    assert frames.shape == (3, 240, 320) and frames.dtype == np.float32
    for i in range(3):
        assert np.array_equal(frames[i], RefSequence.generate(
            n_frames=3, seed=2).frame(i))


@pytest.mark.parametrize("sequence", ["hard", "clean"])
def test_results_md_matches_vo_tpu(sequence, tmp_path):
    """Both writers over vo_tpu's committed bundles give the same
    document, line for line."""
    orig = _load("eval_synthetic")
    out = os.path.join(REPO, ev.REF_OUT[sequence])
    docs = [str(tmp_path / "vo_tpu.md"), str(tmp_path / "port.md")]
    orig.write_results_md(out, 1000, doc=docs[0], sequence=sequence)
    ev.write_results_md(out, 1000, doc=docs[1], sequence=sequence)
    lines = []
    for d in docs:
        with open(d) as f:
            lines.append(f.read().splitlines())
    assert lines[0] == lines[1]
    assert sum(line.startswith("| ") for line in lines[1]) == 13  # 12 rows


def _row(name, seed, ate, rpe):
    return {"config": name, "seed": seed, "ate_rmse": ate, "rpe_rmse": rpe,
            "drift100": 1.0}


def _tree(ate, rpe, anchor=None, name="tracking_orb"):
    per = {name: {s: _row(name, s, a, rpe[s]) for s, a in enumerate(ate)}}
    if anchor is not None:
        per[ev.ANCHORS[name]] = {s: _row(ev.ANCHORS[name], s, anchor, 1.0)
                                 for s in range(3)}
    return per


# vo_tpu: median ATE 30 (worst 33), median RPE 0.4, cv2 anchor 35, so the
# limits are (a) ATE <= max(37.5, 33), (b) RPE <= 0.5, (c) ATE <= 35; (a)
# is broken alone against an anchor of 100
REF = _tree([33.0, 30.0, 23.0], [0.4, 0.4, 0.5], anchor=35.0)
REF_FAR = _tree([33.0, 30.0, 23.0], [0.4, 0.4, 0.5], anchor=100.0)
BROKEN = {
    "a": (_tree([40.0, 38.0, 20.0], [0.4, 0.4, 0.4]), REF_FAR),
    "b": (_tree([30.0, 30.0, 30.0], [0.6, 0.55, 0.4]), REF),
    "c": (_tree([36.0, 36.0, 20.0], [0.4, 0.4, 0.4]), REF),
}


def test_hold_passes_a_row_inside():
    port = _tree([31.0, 34.0, 20.0], [0.45, 0.49, 0.3])
    (row,) = ev.hold(port, REF)
    assert row["verdict"] == "pass" and row["failed"] == []
    assert (row["a"], row["b"], row["c"], row["d"]) == (True, True, True,
                                                        None)
    assert row["ate_limit"] == 37.5 and row["rpe_limit"] == 0.5
    (row,) = ev.hold({}, REF)
    assert row["verdict"].startswith("not run")


@pytest.mark.parametrize("limit", ["a", "b", "c"])
def test_hold_fails_each_limit_alone(limit):
    (row,) = ev.hold(*BROKEN[limit])
    assert row["verdict"] == "FAIL"
    assert [row[k] for k in "abc"] == [k != limit for k in "abc"]
    (msg,) = row["failed"]
    assert msg.startswith(f"tracking_orb: ({limit})")


def test_hold_c_applies_only_where_vo_tpu_beats_its_anchor():
    ref = _tree([33.0, 30.0, 23.0], [0.4, 0.4, 0.5], anchor=25.0)
    (row,) = ev.hold(BROKEN["c"][0], ref)
    assert row["c"] is None and row["verdict"] == "pass"


def _twin_bundles(base, est_b=b"1 2\n"):
    for name, est in zip(ev.TWINS, (b"1 2\n", est_b)):
        d = os.path.join(base, name)
        os.makedirs(d)
        for f in ev.BUNDLE_FILES:
            with open(os.path.join(d, f), "wb") as fh:
                fh.write(est if f == "est_path.txt" else b"0 0\n")
        with open(os.path.join(d, "metrics.json"), "w") as fh:
            json.dump(_row(name, 0, 1.0, 0.1), fh, indent=1)


def test_hold_fails_twins_that_differ(tmp_path):
    same, differ = str(tmp_path / "same"), str(tmp_path / "differ")
    _twin_bundles(same)
    _twin_bundles(differ, est_b=b"1 2.5\n")
    assert ev.twins_equal(same, 0) is True
    assert ev.twins_equal(differ, 0) is False
    assert ev.twins_equal(str(tmp_path), 0) is None
    ref, port = {}, {}
    for name in ev.TWINS:
        ref.update(_tree([1.0] * 3, [0.1] * 3, name=name))
        port.update(_tree([1.0] * 3, [0.1] * 3, name=name))
    rows = ev.hold(port, ref, {0: True, 1: True, 2: True})
    assert [r["verdict"] for r in rows] == ["pass", "pass"]
    rows = ev.hold(port, ref, {0: True, 1: False, 2: True})
    for r, name in zip(rows, ev.TWINS):
        assert r["d"] is False and r["verdict"] == "FAIL"
        (msg,) = r["failed"]
        assert msg.startswith(f"{name}: (d)") and "seeds [1]" in msg


def test_held_gate_answers_max_lag_steps_late():
    """hold_back: a dip pushed at step 1 triggers a re-detect at once on
    the port's gate, and only once it is max_lag = 4 steps old on a held
    gate."""
    import torch

    from vo_tpu_torch.models.vo import _AsyncScalarGate

    fired = []
    for held in (False, True):
        gate = _AsyncScalarGate("async", max_lag=4)
        if held:
            ev.hold_back(gate)
        steps = []
        for step in range(1, 8):
            gate.push(torch.tensor([int(step == 1), 100]))
            if gate.update():
                steps.append(step)
        fired.append(steps)
    assert fired == [[1], [5]]


SMALL = VOConfig(orb=OrbConfig(nfeatures=300, n_levels=3), ransac_iters=64)


def test_cpu_run_writes_vo_tpu_bundle_and_reuses_it(tmp_path, monkeypatch,
                                                    capsys):
    """A 16-frame CPU run of a small tracking_orb writes vo_tpu's bundle
    (its files, metrics.json's keys in order) plus run.json and the
    document; a second call runs nothing and keeps the bundle."""
    monkeypatch.setitem(PRESETS, "tracking_orb", Preset(
        "tracking_orb", "small", TrackingVO, SMALL))
    out, doc = tmp_path / "results_gpu", tmp_path / "RESULTS_GPU.md"
    argv = ["--device", "cpu", "--frames", "16", "--seeds", "0",
            "--presets", "tracking_orb", "--out", str(out), "--doc", str(doc)]
    (run,) = ev.main(argv)
    bundle = out / "tracking_orb"
    ref = os.path.join(REPO, "results_tpu", "tracking_orb")
    assert set(os.listdir(bundle)) == set(os.listdir(ref)) | {"run.json"}
    with open(bundle / "metrics.json") as f:
        row = json.load(f)
    with open(os.path.join(ref, "metrics.json")) as f:
        assert list(row) == list(json.load(f))
    assert row["config"] == "tracking_orb" and row["seed"] == 0
    assert np.isfinite(row["ate_rmse"]) and np.isfinite(row["rpe_rmse"])
    assert len(np.loadtxt(bundle / "est_path.txt")) == 16
    assert run["frames"] == 16 and run["device"] == "cpu"
    assert run["card"] is None and run["ba_runs"] == 0
    with open(bundle / "run.json") as f:
        assert json.load(f) == run
    text = doc.read_text()
    assert "| tracking_orb | " in text and "not run (seeds [1, 2])" in text
    mtime = os.path.getmtime(bundle / "metrics.json")
    capsys.readouterr()
    assert ev.main(argv) == []
    assert "# tracking_orb seed 0: cached" in capsys.readouterr().out
    assert os.path.getmtime(bundle / "metrics.json") == mtime
