"""LK tracking: host ms a step inside the program's `lk` spans (the
pyramid and `lk_pyramid_track_cached` of `models/vo.py:_track_step`), all
streams, over the steps started in the traced window (one frame each)."""

from vobench import spans

NAMES = ("lk",)
# the program's span recorder, whose spans this metric reads
ENTRIES = spans.entries(NAMES)


def read(run):
    return spans.host_ms_per_step(run, NAMES)
