"""ORB frontend: host ms a step inside the program's `match` spans
(`models/vo.py:match_features`: the exact Hamming knn(2) and its ratio
test in an ORB pipeline), all streams, over the steps started in the
traced window (one frame each)."""

from vobench import spans

NAMES = ("match",)
# the program's span recorder, whose spans this metric reads
ENTRIES = spans.entries(NAMES)


def read(run):
    return spans.host_ms_per_step(run, NAMES)
