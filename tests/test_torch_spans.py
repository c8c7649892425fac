"""The port's span recorder (`vo_tpu_torch.utils.profiling`: span, count,
wait, enable, disable, take) and its call sites in `models/vo.py`, on the
CPU, with no JAX.

Off, the recorder reads no clock and records nothing. On, a step's spans
nest as the step's code does (a track step, a re-detect, a matching step),
every child inside its parent and every span of a step under its
identifier; the re-detect gate counts the waits that block, and disable()
puts back torch's sync debug mode and the warning handling it found.
"""

import time
import timeit
import warnings

import numpy as np
import pytest
import torch

from vo_tpu_torch.data.synthetic import SyntheticSequence
from vo_tpu_torch.frontend.orb import OrbConfig
from vo_tpu_torch.models.vo import (
    MatchingVO,
    TrackingVO,
    VOConfig,
    _AsyncScalarGate,
)
from vo_tpu_torch.utils import profiling
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")

SYNC = "called a synchronizing CUDA operation"


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.disable()
    yield
    profiling.disable()


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence.generate(n_frames=4, shape=(120, 160),
                                      n_points=800, seed=2)


def _cfg(**kw):
    return VOConfig(orb=OrbConfig(nfeatures=300, n_levels=4),
                    ransac_iters=64, fallback_gate="sync", **kw)


def _tree(records) -> list:
    """The spans as nested (name, children) lists, after checking that
    each parent is valid and opened first, that each child lies inside its
    parent, and that a child carries its parent's step."""
    spans = records.spans
    kids = {-1: []}
    for i, (name, start, end, parent, step) in enumerate(spans):
        assert start <= end, name
        assert -1 <= parent < i, name
        if parent >= 0:
            p = spans[parent]
            assert p[1] <= start and end <= p[2], (name, p[0])
            assert step == p[4], name
        kids.setdefault(parent, []).append(i)

    def build(i):
        return (spans[i][0], [build(k) for k in kids.get(i, [])])

    return [build(i) for i in kids[-1]]


def _steps(records) -> list:
    return [s[4] for s in records.spans if s[3] == -1]


POSE = ("pose", [("ransac", [])])
# an ORB detect's stages, one after another
DETECT = ("detect", [("orb_maps", []), ("orb_select", []),
                     ("orb_describe", [])])


def test_off_records_nothing_reads_no_clock_touches_no_cuda(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called while the recorder is off")

    monkeypatch.setattr(time, "time_ns", boom)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", boom)
    monkeypatch.setattr(torch.cuda, "is_available", boom)

    class Event:
        waited = 0

        def query(self):
            boom()

        def synchronize(self):
            self.waited += 1

    ev = Event()
    assert profiling.span("a") is profiling.span("b")  # one shared object
    with profiling.span("step", 1):
        with profiling.span("pose"):
            profiling.count("host_sync")
            profiling.wait(ev, "gate_wait")
    assert ev.waited == 1
    assert profiling.take() == profiling.Records([], {})


def test_span_call_off_costs_under_a_microsecond():
    n = 20000
    best = min(timeit.repeat("span('pose')", globals={"span": profiling.span},
                             number=n, repeat=5)) / n
    assert best < 1e-6, best


def test_track_step_spans(seq):
    vo = TrackingVO(seq.K, _cfg(), device="cpu")
    state = vo.init(seq.frame(0), seed=1)
    profiling.enable()
    state, _ = vo.step(state, seq.frame(1))
    state, _ = vo.step(state, seq.frame(2))
    rec = profiling.take()
    step = ("step", [("lk", []), POSE])
    assert _tree(rec) == [step, step]
    assert _steps(rec) == [1, 2]
    assert rec.counts == {}  # no card: nothing waits
    assert profiling.take() == profiling.Records([], {})  # take() cleared


def test_redetect_spans(seq):
    vo = TrackingVO(seq.K, _cfg(), device="cpu")
    state = vo.init(seq.frame(0), seed=1)
    # a flat frame: the step after it loses its tracks, the next re-detects
    state, _ = vo.step(state, np.full_like(seq.frame(1), 128.0))
    state, out = vo.step(state, seq.frame(2))
    assert not bool(out.fallback)
    profiling.enable()
    state, out = vo.step(state, seq.frame(3))
    rec = profiling.take()
    assert bool(out.fallback)
    assert _tree(rec) == [("step", [DETECT, DETECT, ("match", []), POSE])]
    assert _steps(rec) == [3]


def test_matching_step_spans(seq):
    vo = MatchingVO(seq.K, _cfg(scale_mode="unmatched"), device="cpu")
    state = vo.init(seq.frame(0), seed=1)
    profiling.enable()
    state, _ = vo.step(state, seq.frame(1))
    rec = profiling.take()
    assert _tree(rec) == [("step", [DETECT, ("match", []), POSE])]
    assert _steps(rec) == [1]


class _Event:
    """A CUDA event's stand-in: `done` says whether it has completed."""

    def __init__(self, done: bool):
        self.done, self.waited = done, 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True


def test_gate_counts_the_waits_that_block():
    gate = _AsyncScalarGate("async", max_lag=2)
    host = torch.tensor([0, 200], dtype=torch.int32)
    fresh, late, stale = _Event(True), _Event(False), _Event(False)
    profiling.enable()
    gate._step = 3
    gate._inbox = [(3, host, fresh)]  # arrived: read without a wait
    gate.update()
    assert fresh.waited == 1 and profiling.take().counts == {}
    gate._inbox = [(3, host, late)]  # in flight, not stale: left for later
    gate.update()
    assert late.waited == 0 and len(gate._inbox) == 1
    assert profiling.take().counts == {}
    gate._inbox = [(1, host, stale)]  # 2 steps old: waited for
    gate.update()
    rec = profiling.take()
    assert stale.waited == 1 and gate._inbox == []
    assert rec.counts == {-1: {"gate_wait": 1}}  # outside every span
    with profiling.span("step", 4):  # under a step's span, as in a step
        gate._inbox = [(1, host, _Event(False))]
        gate.update()
    assert profiling.take().counts == {0: {"gate_wait": 1}}


def test_disable_restores_sync_mode_and_warnings(monkeypatch):
    modes, shown = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(warnings, "showwarning",
                        lambda message, *a, **k: shown.append(str(message)))
    filters, show = list(warnings.filters), warnings.showwarning
    profiling.enable()
    assert modes == ["warn"]
    with profiling.span("step", 7):
        with profiling.span("pose"):
            for _ in range(3):  # each occurrence counts, from one line
                warnings.warn(SYNC, UserWarning)
        warnings.warn("another warning", UserWarning)
    rec = profiling.take()
    profiling.disable()
    assert rec.counts == {1: {"host_sync": 3}}  # under "pose"
    assert shown == ["another warning"]  # passed on; the syncs swallowed
    assert modes == ["warn", 0]
    assert warnings.filters == filters and warnings.showwarning is show
    profiling.disable()  # a second disable() changes nothing
    assert modes == ["warn", 0]
