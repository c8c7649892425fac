"""host loop: the times a step's host waited for the card, over the steps
started in the traced window (one frame each): `host_sync`, each
synchronizing CUDA operation that torch's sync debug mode reports inside a
span, and `gate_wait`, each wait of the re-detect gate (`models/vo.py:
_AsyncScalarGate.update`) on a copy that had not arrived."""

from vobench import spans

COUNTERS = ("host_sync", "gate_wait")
# the program's span recorder: every span, for the counts it carries
ENTRIES = spans.entries()


def read(run):
    return spans.counts_per_step(run, COUNTERS)
