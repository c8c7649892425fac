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
- FrameRateMeter: frames/s over a dispatch-only loop.
- trace(): context manager around `torch.profiler`; summarize() gives
  per-op totals from its `key_averages()`.
"""

from __future__ import annotations

import contextlib
import os
import time

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


class FrameRateMeter:
    """Dispatch-only frames/s: mark() per frame, report() waits once."""

    def __init__(self):
        self._t0 = None
        self._n = 0
        self._last = None

    def mark(self, out) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._n += 1
        self._last = out

    def report(self) -> dict:
        if self._last is not None:
            _wait(self._last)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        fps = self._n / dt if dt > 0 else float("nan")
        return {"frames": self._n, "seconds": round(dt, 4), "fps": round(fps, 2)}


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
