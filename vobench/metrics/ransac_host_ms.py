"""pose chain: host ms a step inside the program's `ransac` spans (the
`ransac_essential` call of `models/vo.py:_pose_scale_chain`), all streams,
over the steps started in the traced window (one frame each)."""

from vobench import spans

NAMES = ("ransac",)
# the program's span recorder, whose spans this metric reads
ENTRIES = spans.entries(NAMES)


def read(run):
    return spans.host_ms_per_step(run, NAMES)
