"""Profiling & timing harness (port of vo_tpu/utils/profiling.py, rewritten
for PyTorch: vo_tpu's imports jax and parses a perfetto trace).

The reference's tracing is wall-clock `std::chrono` around the frame loop
plus cudaEvent timing inside two kernels (SURVEY.md §5). Here:
- every timed region ends with `torch.cuda.synchronize()` where the work
  ran on the card, because PyTorch returns before the device finishes: a
  host clock without it measures the enqueue;
- timing chains data between iterations, as vo_tpu's does.

Tools:
- chained_timeit: per-call wall time with a data dependency.
- trace(): context manager around `torch.profiler`; summarize() gives
  per-op totals from its `key_averages()`.
- span() / count(): the host's own spans and counters inside a step,
  recorded in memory between enable() and disable() and read by take().
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import NamedTuple

import torch


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _tensors(x)


def _wait(out) -> None:
    """Wait until the device work that produced `out` has finished."""
    devices = {t.device for t in _tensors(out) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


def chained_timeit(fn, init_args, chain, n: int = 50, warmup: int = 2):
    """Time `fn(*args)` per call with `args = chain(out, *args)` threading
    a data dependency between iterations.

    Returns seconds per call."""
    args = init_args
    out = fn(*args)
    for _ in range(warmup - 1):
        args = chain(out, *args)
        out = fn(*args)
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(n):
        args = chain(out, *args)
        out = fn(*args)
    _wait(out)
    return (time.perf_counter() - t0) / n


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """`torch.profiler` over the block, CUDA activity included when a card
    is present; yields the profile (pass it to summarize()). With
    `log_dir`, the Chrome trace is written there as trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def summarize(prof, top: int = 25, min_us: float = 500.0) -> list:
    """Per-op totals of a trace() profile: [(total_ms, op_name, count)]
    sorted descending, ops under `min_us` in total dropped, at most `top`
    rows. Totals are self device time where the profile saw the device,
    else self CPU time."""
    rows = list(prof.key_averages())
    on_device = any(r.self_device_time_total > 0 for r in rows)
    totals = [
        (r.self_device_time_total if on_device else r.self_cpu_time_total,
         r.key, r.count)
        for r in rows
    ]
    totals.sort(key=lambda t: -t[0])
    return [(us / 1e3, name, count) for us, name, count in totals
            if us >= min_us][:top]


# ------------------------------------------------------------------ spans
#
# The host's own record of a step: named spans (start, end, the span open
# around each) and counters, on `time.time_ns()`, the clock on which the
# profiler stamps the card's activity, so spans and the device trace line
# up without conversion. Off by default: span() then returns one shared
# object after one check and count() returns at once; neither reads a
# clock, allocates or touches CUDA.

# the text of the warning that torch's sync debug mode gives at each
# operation that makes the host wait for the card
_SYNC_WARNING = "called a synchronizing CUDA operation"


class Records(NamedTuple):
    """A recorder's contents.

    `spans`: one [name, start_ns, end_ns, parent, step] per span, in the
    order they opened; `parent` is the index of the innermost span open at
    its start (-1 for a root), `step` the identifier its root was given
    (-1 for none), `end_ns` -1 while it is open. `counts`: {index of the
    innermost open span (-1 outside every span): {counter: n}}."""

    spans: list
    counts: dict


class Recorder:
    """Spans and counts in memory, read only by `take()`. While it watches
    synchronizations (enable() on a CUDA host), each operation that makes
    the host wait for the card counts `host_sync`."""

    def __init__(self):
        self.spans: list = []
        self.counts: dict = {}
        self._open: list = []  # indices of the open spans, innermost last
        self._restore = None  # (sync debug mode, warnings state) to put back

    def open(self, name: str, step: int | None = None) -> int:
        i = len(self.spans)
        parent = self._open[-1] if self._open else -1
        if step is None:
            step = self.spans[parent][4] if parent >= 0 else -1
        self.spans.append([name, time.time_ns(), -1, parent, step])
        self._open.append(i)
        return i

    def close(self, i: int) -> None:
        self.spans[i][2] = time.time_ns()
        self._open.pop()

    def count(self, name: str, n: int = 1) -> None:
        c = self.counts.setdefault(self._open[-1] if self._open else -1, {})
        c[name] = c.get(name, 0) + n

    def take(self) -> Records:
        if self._open:
            raise RuntimeError(f"take() inside {len(self._open)} open span(s)")
        out = Records(self.spans, self.counts)
        self.spans, self.counts = [], {}
        return out

    def watch_syncs(self) -> None:
        """Set torch's sync debug mode to "warn" and count each such
        warning as `host_sync` under the innermost open span, showing none
        of them; `unwatch()` puts back the mode and the warning handling."""
        mode = torch.cuda.get_sync_debug_mode()
        caught = warnings.catch_warnings()
        caught.__enter__()
        # every occurrence, not once per source line
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        show = warnings.showwarning

        def on_warning(message, category, filename, lineno, file=None,
                       line=None):
            if _SYNC_WARNING in str(message):
                self.count("host_sync")
            else:
                show(message, category, filename, lineno, file, line)

        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        self._restore = (mode, caught)

    def unwatch(self) -> None:
        if self._restore is not None:
            mode, caught = self._restore
            self._restore = None
            torch.cuda.set_sync_debug_mode(mode)
            caught.__exit__(None, None, None)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_rec", "_name", "_step", "_i")

    def __init__(self, rec: Recorder, name: str, step: int | None):
        self._rec, self._name, self._step = rec, name, step

    def __enter__(self):
        self._i = self._rec.open(self._name, self._step)
        return self

    def __exit__(self, *exc):
        self._rec.close(self._i)
        return False


_active: Recorder | None = None


def span(name: str, /, step: int | None = None):
    """Context manager: the block is one span `name`, a child of the
    innermost open span. A root span takes `step`, the identifier that all
    spans inside it share (a pipeline's step counter). `name` is
    positional: a benchmark that wraps span() reads it as the first
    argument."""
    rec = _active
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, step)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the innermost open span."""
    rec = _active
    if rec is not None:
        rec.count(name, n)


def wait(event, name: str) -> None:
    """`event.synchronize()`. While recording, a wait that blocks (the
    event has not completed) counts `name`."""
    rec = _active
    if rec is not None and not event.query():
        rec.count(name)
    event.synchronize()


def enable() -> Recorder:
    """Start recording, on a CUDA host with the synchronizations watched;
    the active recorder (the same one when already on)."""
    global _active
    if _active is None:
        rec = Recorder()
        if torch.cuda.is_available():
            rec.watch_syncs()
        _active = rec
    return _active


def disable() -> None:
    """Stop recording and put back what enable() changed; what was recorded
    stays in the recorder that enable() returned."""
    global _active
    rec, _active = _active, None
    if rec is not None:
        rec.unwatch()


def take() -> Records:
    """The spans and counts recorded since enable() or the last take(),
    cleared from the recorder (empty when off)."""
    return _active.take() if _active is not None else Records([], {})
