"""The benchmark's `matching_orb.drive.x6` cell on the CPU, at a small frame
size: the port's `matching_orb` steps judged against the plain reference
(`vobench/reference/`) are correct, the control in lower precision and
each fault of a broken step are not; the ORB detect's three spans nest
under `detect` and cover it; and the cell's five readers read known values
from hand-made rows and a number from a traced run through the worker."""

import argparse
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "vobench"
                       / "tests"))

import vobench_tiny as tiny  # noqa: E402
from test_vobench_check import Broken  # noqa: E402

from vobench import compare, run, spec  # noqa: E402
from vobench.worker import Stream  # noqa: E402

CELL = "matching_orb.drive.x6"
ORB_SPANS = ("orb_maps", "orb_select", "orb_describe")
METRICS = ("orb_maps_host_ms", "orb_select_host_ms", "orb_describe_host_ms",
           "hamming_host_ms", "orb_waits_per_frame")


def _cell():
    """The tiny cell on one stream with a 12-frame bank: a run in a few
    seconds."""
    cell = tiny.tiny_cell(CELL)
    cell.traffic["streams"] = 1
    cell.config["bank_frames"] = 12
    return cell


def test_the_cell_runs_the_matching_orb_preset():
    cell = spec.load_cell(tiny.REPO, CELL)
    assert cell.chips == 1 and cell.config["preset"] == "matching_orb"
    assert cell.config["vo"]["detector"] == "orb"
    assert [m["name"] for m in cell.per_layer] == list(METRICS)


def test_a_sound_run_is_correct():
    line = tiny.run_in_process(_cell(), seed=2**32 + 3, seconds=0.5)
    assert line["correct"], line["check"]


@pytest.mark.parametrize("seed", [11, 2**31 + 5, 3000000019])
def test_the_control_fails(seed):
    cell = _cell()
    line = tiny.run_in_process(cell, seed=seed, seconds=0.5, control=True)
    assert line["correct"], line["check"]
    ok, rows = compare.judge(line["control"], cell.config["limits"])
    assert line["control_correct"] is ok is False, rows


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_points",
                                   "pose_altered", "points_altered",
                                   "cloud_altered"])
def test_a_broken_step_is_not_correct(fault):
    line = tiny.run_in_process(_cell(), seed=2**33 + 1, seconds=0.5,
                               wrap=lambda p: Broken(p, fault))
    assert not line["correct"], line["check"]


def test_the_orb_spans_cover_the_detect():
    from vo_tpu_torch.frontend.orb import OrbConfig
    from vo_tpu_torch.models.vo import VOConfig, detect_and_describe
    from vo_tpu_torch.utils import profiling

    img = torch.rand((120, 160), generator=torch.Generator().manual_seed(3))
    cfg = VOConfig(orb=OrbConfig(nfeatures=300, n_levels=4))
    detect_and_describe(img * 255.0, cfg)  # caches filled, as in a run
    profiling.enable()
    try:
        detect_and_describe(img * 255.0, cfg)
        spans = profiling.take().spans
    finally:
        profiling.disable()
    assert [s[0] for s in spans] == ["detect", *ORB_SPANS]
    (_, d0, d1, _, _), kids = spans[0], spans[1:]
    assert all(s[3] == 0 for s in kids)  # each a child of `detect`
    ends = [d0] + [t for s in kids for t in s[1:3]] + [d1]
    assert ends == sorted(ends)  # in order, none overlapping
    covered = sum(s[2] - s[1] for s in kids)
    assert covered >= 0.9 * (d1 - d0), (covered, d1 - d0)


# rows as a metric receives them, (name, start_ns, end_ns, counts), of two
# matching steps; a span that a metric does not keep comes back empty
ROWS = [
    ("step", 0, 1000, {"host_sync": 5}),
    ("detect", 10, 400, {"host_sync": 1}),
    ("orb_maps", 20, 120, {}),
    ("orb_select", 120, 300, {"host_sync": 2}),
    ("orb_describe", 300, 390, {}),
    ("match", 400, 440, {"host_sync": 1}),
    ("pose", 440, 990, {"host_sync": 9}),
    ("step", 1000, 2000, {}),
    ("detect", 1010, 1300, {}),
    ("orb_maps", 1010, 1090, {}),
    ("orb_select", 1090, 1200, {}),
    ("orb_describe", 1200, 1300, {"host_sync": 4}),
    ("match", 1300, 1350, {}),
    (),
]


def _data(traced, work):
    return run.RunData(traced=traced, frames=2, fallback_frames=None,
                       window_s=1.0, work=work)


def test_the_readers_on_hand_made_rows():
    read = {m: spec.load_metric(tiny.REPO, m).read for m in METRICS}
    data = _data(True, ROWS)
    assert read["orb_maps_host_ms"](data) == pytest.approx(180 / 1e6 / 2)
    assert read["orb_select_host_ms"](data) == pytest.approx(290 / 1e6 / 2)
    assert read["orb_describe_host_ms"](data) == pytest.approx(190 / 1e6 / 2)
    assert read["hamming_host_ms"](data) == pytest.approx(90 / 1e6 / 2)
    # the detect's, its stages' and the match's, not the step's or pose's
    assert read["orb_waits_per_frame"](data) == 4.0  # (1 + 2 + 1 + 4) / 2
    older = [r for r in ROWS if not r or r[0] not in ORB_SPANS]
    for m in METRICS:
        assert read[m](_data(False, ROWS)) is None  # untraced
        assert read[m](_data(True, [])) is None  # no recorder
        assert read[m](_data(True, ROWS[1:7])) is None  # no step
    for m in METRICS[:3]:  # a detect without the stages' spans
        assert read[m](_data(True, older)) is None
    assert read["hamming_host_ms"](_data(True, older)) == read[
        "hamming_host_ms"](data)
    assert read["orb_waits_per_frame"](_data(True, older)) == 1.0


def test_a_traced_run_reads_every_metric():
    cell = _cell()
    seed = 3_000_000_011
    sp = {"stream": 0, "n_streams": 1, "seed": seed, "config": cell.config,
          "traffic": cell.traffic, "trace": True,
          "metrics": [m["name"] for m in cell.per_layer]}
    st = Stream(sp, torch.device("cpu"))
    ready = st.setup()
    t0 = time.time_ns()
    window = st.window(t0, t0 + int(1e9))
    got = {"ready": [{"ready": ready}], "setup_s": 1.0,
           "windows": [{"window": window}],
           "checks": [{"check": st.check(), "forbidden": []}]}
    args = argparse.Namespace(seed=seed, seconds=1.0, trace=1, control=0,
                              device="cpu")
    metrics = run.result_line(cell, args, got)["metrics"]
    assert sorted(metrics) == sorted(METRICS)
    for m in METRICS[:4]:
        assert metrics[m]["value"] > 0, m
    assert metrics["orb_waits_per_frame"]["value"] == 0.0  # no card
