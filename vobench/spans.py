"""The program's own spans and counters (`vo_tpu_torch.utils.profiling`) as
the traced run's per-layer metrics read them.

A metric that reads spans names the recorder's `span` as its entry point
(`ENTRIES = spans.entries(...)`), so a traced worker wraps it for the
window (`worker.EntryCalls`). The window's first span turns the recorder
on; after the window each span opened in [t0, t_end) gives its row, and
the first row asked for turns the recorder off. A row is

    (name, start_ns, end_ns, counts)

where `counts` holds the counters made while the span was the innermost
open one. Times are `time.time_ns()`, the clock of the profiler's device
events. Every metric divides by the `step` spans opened in the window, so
numerator and denominator count the same steps (a step is one frame). A
program without the recorder gives no entry point, and every metric that
reads spans reads None.
"""

from __future__ import annotations

ENTRY = "vo_tpu_torch.utils.profiling.span"
STEP = "step"  # the root span of each pipeline step


def entries(names=None) -> dict:
    """The `ENTRIES` of a metric that reads the rows of the spans named in
    `names` (of every span: None) and of every `step` span; {} where the
    program has no recorder."""
    from vo_tpu_torch.utils import profiling

    if not hasattr(profiling, "enable"):  # a program before the recorder
        return {}

    def on_span(args):
        rec = profiling.enable()
        j = len(rec.spans)  # the index of the span about to open
        keep = names is None or args[0] in names or args[0] == STEP
        return lambda: _row(profiling, rec, j, keep)

    return {ENTRY: on_span}


def _row(profiling, rec, j: int, keep: bool) -> tuple:
    profiling.disable()  # the window is over; idempotent
    if not keep:
        return ()
    name, start, end = rec.spans[j][:3]
    return (name, start, end, rec.counts.get(j, {}))


def _per_step(run, total) -> float | None:
    """`total(rows)` over the `step` spans opened in the window, or None
    where the run holds none (untraced, or no recorder)."""
    rs = [r for r in run.work if r] if run.traced else []
    steps = sum(1 for r in rs if r[0] == STEP)
    return total(rs) / steps if steps else None


def host_ms_per_step(run, names) -> float | None:
    """Host ms inside the spans named in `names`, a step."""
    return _per_step(run, lambda rs: sum(
        r[2] - r[1] for r in rs if r[0] in names) / 1e6)


def counts_per_step(run, counters) -> float | None:
    """The counters `counters` summed over every span, a step."""
    return _per_step(run, lambda rs: sum(
        r[3].get(c, 0) for r in rs for c in counters))
