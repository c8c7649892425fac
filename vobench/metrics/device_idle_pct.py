"""device: the share of the traced window in which no operation of any
stream ran on the card (the union of every worker's kernel, copy and set
intervals from the profiler's CUDA activity, on one clock)."""


def read(run):
    if not run.traced or not run.window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
