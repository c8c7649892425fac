"""ORB frontend: host ms a step inside the program's `orb_describe` spans
(`frontend/orb.py:orb_detect_and_compute`: orientation, rBRIEF and the
keypoints mapped back to level 0), all streams, over the steps started in
the traced window (one frame each)."""

from vobench import spans

NAMES = ("orb_describe",)
# the program's span recorder, whose spans this metric reads
ENTRIES = spans.entries(NAMES)


def read(run):
    if not any(r and r[0] in NAMES for r in run.work):
        return None  # a program whose detect has no such span
    return spans.host_ms_per_step(run, NAMES)
