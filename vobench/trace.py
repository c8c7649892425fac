"""The traced run's reading of the card: the profiler's CUDA activity
(kernels, copies and sets) of one worker, reduced in memory.

The profiler is driven through its low-level calls, which keep its events
in C++ until they are read: a window holds millions of launches, and the
high-level profiler would build a Python object for each and could export
gigabytes of trace. The reduction keeps, of the operations that overlap
the window: their time and count by name, the number of kernel launches,
and the union of their intervals (ns from the window's start), which
`run.py` merges across workers into the card's busy time. Event times are
on the host's realtime clock, the clock of `time.time_ns()`, on which the
window is set.
"""

from __future__ import annotations

import numpy as np


def _config():
    from torch.autograd.profiler import (
        ProfilerConfig,
        ProfilerState,
        _ExperimentalConfig,
    )

    return ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                          False, _ExperimentalConfig())


def start(device) -> None:
    """Start collecting the device's activity (nothing on a CPU run)."""
    from torch.autograd.profiler import _enable_profiler, _prepare_profiler
    from torch.profiler import ProfilerActivity

    if device.type != "cuda":
        return
    acts = {ProfilerActivity.CUDA}
    _prepare_profiler(_config(), acts)
    _enable_profiler(_config(), acts)


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMem"))


def reduce_events(events, t0: int, t1: int) -> dict:
    """The window's reduction of (name, start_ns, duration_ns) device
    events: by-name seconds and counts, kernel launches, and the merged
    busy intervals (int64 ns from t0)."""
    by_name: dict = {}
    starts, ends = [], []
    launches, first, last = 0, None, None
    for name, s, d in events:
        first = s if first is None else min(first, s)
        last = s if last is None else max(last, s)
        e = s + d
        if e <= t0 or s >= t1:
            continue
        s, e = max(s, t0), min(e, t1)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s) / 1e9, n + 1)
        starts.append(s - t0)
        ends.append(e - t0)
        launches += _is_kernel(name)
    iv = merge(np.asarray(starts, np.int64), np.asarray(ends, np.int64))
    # where the events lie against the window: a trace on another clock
    # than the window's shows here
    clock = {"first_from_t0_s": None if first is None else (first - t0) / 1e9,
             "last_from_t1_s": None if last is None else (last - t1) / 1e9}
    return {"by_name": {k: list(v) for k, v in by_name.items()},
            "launches": launches, "intervals": iv, "window_ns": t1 - t0,
            "clock_check": clock}


def stop(t0: int, t1: int) -> dict:
    """Stop collecting; the reduction of what ran in [t0, t1)."""
    import torch
    from torch.autograd import DeviceType
    from torch.autograd.profiler import _disable_profiler

    if not torch.cuda.is_available():
        return reduce_events([], t0, t1)
    res = _disable_profiler()
    cuda = DeviceType.CUDA
    events = ((e.name(), e.start_ns(), e.duration_ns())
              for e in res.events() if e.device_type() == cuda)
    return reduce_events(events, t0, t1)


def merge(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """(n, 2) int64: the union of intervals [start, end) as disjoint sorted
    intervals."""
    if starts.size == 0:
        return np.zeros((0, 2), np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    first = np.flatnonzero(new)
    last = np.r_[first[1:] - 1, s.size - 1]
    return np.stack([s[first], run_end[last]], axis=1)


def pop_blobs(result: dict) -> dict:
    """The numpy arrays of a window's result, taken out of it to travel
    as raw bytes."""
    tr = result.get("trace")
    if not tr:
        return {}
    return {"intervals": tr.pop("intervals")}


def busy_and_gaps(interval_sets: list, window_ns: int):
    """(busy seconds, gaps (n, 2) ns) of the union of the workers' busy
    intervals over [0, window_ns)."""
    iv = [a for a in interval_sets if a.size]
    if not iv:
        return 0.0, np.array([[0, window_ns]], np.int64)
    allv = np.concatenate(iv)
    u = merge(allv[:, 0], allv[:, 1])
    busy = float((u[:, 1] - u[:, 0]).sum()) / 1e9
    edges = np.r_[0, u.reshape(-1), window_ns].reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    return busy, gaps
