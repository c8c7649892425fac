"""ORB frontend: the times a step's host waited for the card inside the
detect and the match, over the steps started in the traced window (one
frame each): each synchronizing CUDA operation that torch's sync debug
mode reports (`host_sync`) while the innermost open span is `detect`, one
of the ORB detect's own spans or `match`."""

from vobench import spans

NAMES = ("detect", "orb_maps", "orb_select", "orb_describe", "match")
# the program's span recorder, whose spans this metric reads
ENTRIES = spans.entries(NAMES)


def read(run):
    # the rows also hold the `step` spans, whose own counts are not the
    # frontend's
    return spans._per_step(run, lambda rows: sum(
        r[3].get("host_sync", 0) for r in rows if r[0] in NAMES))
