"""The readers of the program's spans (vobench/spans.py and the metrics that
read spans): host times and counts over the steps whose span opened in the
window, on hand-made rows and through the recorder; the metrics read
nothing in an untraced run or from a program without the recorder; and a
traced run on the CPU, through the worker, reads the pose chain's host
time, each step's span inside the worker's own record of that step."""

import argparse
import time

import pytest
import torch
import vobench_tiny as tiny

from vobench import run, spans, spec
from vobench.worker import EntryCalls, Stream

METRICS = ("pose_host_ms", "lk_host_ms", "frontend_host_ms",
           "host_waits_per_frame", "ransac_host_ms")

# rows as a metric receives them, (name, start_ns, end_ns, counts), of two
# steps: the pose chain and its RANSAC in the first, LK in the second,
# which opened in the window and ended after it
ROWS = [
    ("step", 0, 100, {"gate_wait": 1}),
    ("pose", 20, 80, {"host_sync": 2}),
    ("ransac", 30, 60, {}),
    ("step", 50, 150, {}),
    ("lk", 60, 90, {"host_sync": 1}),
]


def test_entries_keep_the_named_spans_and_the_steps():
    from vo_tpu_torch.utils import profiling

    on_span = spans.entries(("pose",))[spans.ENTRY]
    made = []

    def span(*a):  # as the worker's wrapper calls it
        made.append(on_span(a))
        return profiling.span(*a)

    try:
        with span("step", 4):
            with span("pose"):
                profiling.count("host_sync", 2)
            with span("lk"):
                pass
        rows = [f() for f in made]
    finally:
        profiling.disable()
    assert [r[0] if r else None for r in rows] == ["step", "pose", None]
    assert rows[1][1] <= rows[1][2] and rows[1][3] == {"host_sync": 2}
    assert rows[0][1] <= rows[1][1] and rows[1][2] <= rows[0][2]
    assert profiling.span("x") is profiling.span("y")  # the first row: off


def _data(traced, frames, work):
    return run.RunData(traced=traced, frames=frames, fallback_frames=None,
                       window_s=1.0, work=work)


def test_metrics_on_hand_made_rows():
    read = {m: spec.load_metric(tiny.REPO, m).read for m in METRICS}
    data = _data(True, 1, [list(r) for r in ROWS] + [[], []])  # as sent
    assert read["pose_host_ms"](data) == pytest.approx(60 / 1e6 / 2)
    assert read["ransac_host_ms"](data) == pytest.approx(30 / 1e6 / 2)
    assert read["lk_host_ms"](data) == pytest.approx(30 / 1e6 / 2)
    assert read["frontend_host_ms"](data) == 0.0
    assert read["host_waits_per_frame"](data) == 2.0  # (1 + 2 + 1) / 2
    for m in METRICS:
        # the steps opened in the window, whatever completed by its end
        assert read[m](_data(True, 5, ROWS)) == read[m](data)
        assert read[m](_data(False, 2, ROWS)) is None  # untraced
        assert read[m](_data(True, 2, [])) is None  # no span: no recorder
        assert read[m](_data(True, 2, ROWS[1:3])) is None  # no step


def test_a_program_without_the_recorder_is_left_alone(monkeypatch):
    from vo_tpu_torch.utils import profiling

    assert set(spans.entries()) == {spans.ENTRY}
    monkeypatch.delattr(profiling, "enable")
    assert spans.entries() == {}
    calls = EntryCalls({m: spec.load_metric(tiny.REPO, m) for m in METRICS})
    calls.install()
    assert not calls._saved  # nothing wrapped
    calls.uninstall()


def test_a_traced_run_reads_the_spans():
    cell = tiny.tiny_cell("tracking_orb.drive.x6")
    cell.traffic["streams"] = 1
    seed = 3_000_000_007
    sp = {"stream": 0, "n_streams": 1, "seed": seed, "config": cell.config,
          "traffic": cell.traffic, "trace": True,
          "metrics": [m["name"] for m in cell.per_layer]}
    st = Stream(sp, torch.device("cpu"))
    ready = st.setup()
    t0 = time.time_ns()
    window = st.window(t0, t0 + int(2e9))
    rows = window["trace"]["work"]["host_waits_per_frame"]
    steps = [r for r in rows if r[0] == "step"]
    # a step that started just before the window's end may open its span
    # just after it
    assert len(st.recs) - 1 <= len(steps) <= len(st.recs) and steps
    for r, rec in zip(steps, st.recs):  # the one clock
        assert rec.t_start <= r[1] <= r[2] <= rec.t_return
    got = {"ready": [{"ready": ready}], "setup_s": 1.0,
           "windows": [{"window": window}],
           "checks": [{"check": st.check(), "forbidden": []}]}
    args = argparse.Namespace(seed=seed, seconds=2.0, trace=1, control=0,
                              device="cpu")
    line = run.result_line(cell, args, got)
    metrics = line["metrics"]
    assert metrics["pose_host_ms"]["value"] > 0
    assert 0 < metrics["ransac_host_ms"]["value"] \
        < metrics["pose_host_ms"]["value"]
    assert metrics["lk_host_ms"]["value"] > 0
    assert metrics["host_waits_per_frame"]["value"] == 0.0  # no card
    assert "frontend_host_ms" not in metrics  # not this cell's
    from vo_tpu_torch.utils import profiling

    assert profiling.span("x") is profiling.span("y")  # off again
