"""SIFT frontend: host ms a step inside the program's `detect` and
`match` spans (`models/vo.py:detect_and_describe`, `match_features`), all
streams, over the steps started in the traced window (one frame each)."""

from vobench import spans

NAMES = ("detect", "match")
# the program's span recorder, whose spans this metric reads
ENTRIES = spans.entries(NAMES)


def read(run):
    return spans.host_ms_per_step(run, NAMES)
