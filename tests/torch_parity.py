"""Shared support for the port's parity tests (tests/test_torch_*.py)."""

import os

import pytest
import torch


def _threads():
    try:
        return [int(t) for t in os.listdir("/proc/self/task")]
    except FileNotFoundError:  # no procfs: the calling thread only
        return [0]


@pytest.fixture(scope="module")
def low_cpu_priority():
    """Run the module's tests at the lowest CPU priority (nice 19), with
    one PyTorch CPU thread.

    The parity tests compile vo_tpu's JAX references, minutes of CPU in
    all. Under pytest-xdist they share the cores with the suite's longest
    file, whose pace sets the suite's wall time; at nice 19 they take the
    cores the rest of the suite leaves idle. Linux keeps a priority per
    thread, so every thread of the process is lowered (threads started
    later inherit it), and the old priorities are restored afterwards
    where the process may raise them again. The port's small CPU tensors
    gain little from PyTorch's intra-op threads, which would only add to
    the cores' oversubscription."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old = {}
    for t in _threads():
        try:
            old[t] = os.getpriority(os.PRIO_PROCESS, t)
            os.setpriority(os.PRIO_PROCESS, t, 19)
        except ProcessLookupError:  # the thread has ended
            pass
    yield
    torch.set_num_threads(torch_threads)
    for t, prio in old.items():
        try:
            os.setpriority(os.PRIO_PROCESS, t, prio)
        except (PermissionError, ProcessLookupError):
            pass
