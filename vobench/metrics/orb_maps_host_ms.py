"""ORB frontend: host ms a step inside the program's `orb_maps` spans
(`frontend/orb.py:orb_detect_and_compute`: the pyramid, the canvas, FAST,
NMS and Harris), all streams, over the steps started in the traced window
(one frame each)."""

from vobench import spans

NAMES = ("orb_maps",)
# the program's span recorder, whose spans this metric reads
ENTRIES = spans.entries(NAMES)


def read(run):
    if not any(r and r[0] in NAMES for r in run.work):
        return None  # a program whose detect has no such span
    return spans.host_ms_per_step(run, NAMES)
