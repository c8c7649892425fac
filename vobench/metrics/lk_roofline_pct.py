"""kernels: B1 (`csrc/lk_refine.cu`, the LK level solve) as a share of its
roofline over the traced window: the bounds of its calls (`work.b1_work`,
from each call's level shapes, slots and refined points) over its kernels'
device time."""

from vobench.metrics import work

KERNELS = ("lk_refine_kernel",)
# the program's entry point whose calls this metric counts
ENTRIES = {"vo_tpu_torch.ops.lk_cuda.refine_level": work.b1_call}


def read(run):
    if not run.traced:
        return None
    return work.share_pct(run.work,
                          work.kernel_seconds(run.kernel_time, KERNELS))
