"""pose chain: host ms a step inside the program's `pose` spans
(`models/vo.py:_pose_scale_chain`, its `ransac` span within), all streams,
over the steps started in the traced window (one frame each)."""

from vobench import spans

NAMES = ("pose",)
# the program's span recorder, whose spans this metric reads
ENTRIES = spans.entries(NAMES)


def read(run):
    return spans.host_ms_per_step(run, NAMES)
