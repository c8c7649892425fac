"""kernels: B2 (`csrc/separable_blur.cu`), B3 (`csrc/crop_windows.cu`) and
B4 (`csrc/row_conv.cu`) together, the kernels of a SIFT detect, as a share
of their roofline over the traced window: the sum of their calls' bounds
(`work.b2_work`, `b3_work`, `b4_work`) over the sum of their kernels'
device time."""

from vobench.metrics import work

KERNELS = ("blur_fixed", "blur_generic", "crop_kernel", "conv_small_kernel",
           "row_conv_wide_kernel")
# the program's entry points whose calls this metric counts
ENTRIES = {
    "vo_tpu_torch.ops.blur_cuda.separable_blur": work.b2_call,
    "vo_tpu_torch.ops.crop_cuda.crop_windows": work.b3_call,
    "vo_tpu_torch.ops.crop_cuda.crop_windows_pair": work.b3_pair_call,
    "vo_tpu_torch.ops.rowconv_cuda.conv_rows_cols": work.b4_call,
}


def read(run):
    if not run.traced:
        return None
    return work.share_pct(run.work,
                          work.kernel_seconds(run.kernel_time, KERNELS))
