"""The least time the H100 could take for each hand-written kernel's call:
the work the call's inputs need, over the card's published peaks.

A call's bound is the larger of its bytes over the HBM bandwidth and its
operations over the float32 rate outside the tensor cores (NVIDIA's H100
SXM data sheet; both assume the full 700 W power limit, and the run prints
the card's limit beside every share). Each input byte is counted read once
and each output byte written once, whatever a kernel reads again. The work
comes from the call's inputs and shapes, never from a count that a kernel
returns, so it reads the same whatever implements the kernel.
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet


def bound_s(n_bytes: float, n_flops: float) -> float:
    """Seconds of the least time for this many bytes and operations."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_F32_FLOPS)


def lk_flops(win: int, n_points: int, n_iters: int) -> float:
    """Operations of one LK level: per point, (win+2)^2 bilinear samples
    (7 flops each: 4 products and 3 sums, the 4 weights shared by the
    patch), then per template pixel 2 differences, 2 halvings and the 3
    products and 3 sums of G; per iteration and pixel one sample, the
    residual, and 2 products and 2 sums for b."""
    wp = win + 2
    return (n_points * (7 * wp * wp + 10 * win * win)
            + n_iters * 12 * win * win)


def b1_work(H: int, W: int, itemsize1: int, itemsize2: int, n_slots: int,
            n_refined: int, win: int) -> tuple[float, float]:
    """(bytes, operations) of one B1 call (`lk_cuda.refine_level`), one
    pyramid level of one step.

    Bytes: both level images read once at the size they are handed over
    (level 0 float32, the finer levels bfloat16 at the configuration's LK
    precision), and per slot its five (N, 2) float32 inputs and `pre` read,
    v, solvable and the iteration count written (54 bytes).

    Operations: the rule for the data-dependent part. Every refined point
    (a slot whose `pre` is set: live, its template inside its window) needs
    its template, gradients and structure tensor, and at least one
    Gauss-Newton iteration before any test of convergence can stop it. How
    many more it needs depends on the data and on the solver, so the count
    takes exactly one per refined point: the least that these inputs need.
    The share is then a lower bound of what the kernel achieves, and a
    kernel that stops its points sooner does not change its own yardstick.
    """
    n_bytes = H * W * (itemsize1 + itemsize2) + n_slots * (5 * 8 + 1 + 8 + 1 + 4)
    return float(n_bytes), float(lk_flops(win, n_refined, n_refined))


def b2_work(numel: int, n_ky: int, n_kx: int) -> tuple[float, float]:
    """(bytes, operations) of one B2 call (`blur_cuda.separable_blur`) over
    `numel` float32 pixels: each read once and written once; per pixel one
    product and one sum per tap of each pass."""
    return float(2 * numel * 4), float(numel * 2 * (n_ky + n_kx))


def b3_work(covered_pixels: int, n_windows: int, S: int, maps: int
            ) -> tuple[float, float]:
    """(bytes, operations) of one B3 call (`crop_cuda.crop_windows_pair`
    with maps=2, `crop_windows` with 1): per map the distinct pixels that
    its windows cover read once (windows overlap) and every window sample
    written once, the int32 origins read once; a crop computes nothing."""
    return float(maps * (4 * covered_pixels + 4 * n_windows * S * S)
                 + 8 * n_windows), 0.0


def b3_covered(H: int, W: int, ox, oy, S: int) -> int:
    """The distinct pixels of an (H, W) map that windows of size S at
    integer origins (ox, oy) cover (torch tensors, any device)."""
    import torch

    ar = torch.arange(S, device=ox.device)
    rows = oy.long()[:, None] + ar
    cols = ox.long()[:, None] + ar
    rin = (rows >= 0) & (rows < H)
    cin = (cols >= 0) & (cols < W)
    flat = rows[:, :, None] * W + cols[:, None, :]
    flat = torch.where(rin[:, :, None] & cin[:, None, :], flat, H * W)
    covered = torch.zeros(H * W + 1, dtype=torch.bool, device=ox.device)
    covered[flat.reshape(-1)] = True
    return int(covered[:H * W].sum())


def b4_work(numel: int, nonzero_taps: int, passes: int) -> tuple[float, float]:
    """(bytes, operations) of one B4 call over `numel` float32 pixels
    (`rowconv_cuda.conv_rows_cols`: 2 passes from one read): the input read
    once and each output written once; per pixel and pass one product per
    nonzero tap and the sums between them."""
    return (float((1 + passes) * numel * 4),
            float(passes * numel * (2 * nonzero_taps - 1)))


# What a call's work depends on, from the arguments of the program's entry
# points (`refine_level(img1, img2, q1, q20, flow, pre, org1, org2, S,
# config)`, `separable_blur(img, ky, kx)`, `crop_windows(map, ox, oy, S)`,
# `crop_windows_pair(map_a, map_b, ox, oy, S)`, `conv_rows_cols(img,
# taps)`): each returns a function of the call's (bytes, operations),
# called after the window, that holds no image, only the small tensors
# whose contents the work depends on (B1's refined-point mask, B3's
# window origins).

def b1_call(a: tuple):
    H, W = a[0].shape
    s1, s2, n, pre, win = (a[0].element_size(), a[1].element_size(),
                           int(a[2].shape[0]), a[5], a[9].win)
    return lambda: b1_work(H, W, s1, s2, n, int(pre.sum()), win)


def b2_call(a: tuple):
    numel, ky, kx = a[0].numel(), int(np.size(a[1])), int(np.size(a[2]))
    return lambda: b2_work(numel, ky, kx)


def _b3(maps: int):
    def call(a: tuple):
        (H, W), (ox, oy, S) = a[0].shape, a[maps:maps + 3]
        return lambda: b3_work(b3_covered(H, W, ox, oy, S),
                               int(ox.shape[0]), S, maps)

    return call


b3_call, b3_pair_call = _b3(1), _b3(2)


def b4_call(a: tuple):
    numel = a[0].numel()
    nonzero = int(np.count_nonzero(np.asarray(a[1]).reshape(-1)))
    return lambda: b4_work(numel, nonzero, 2)


def share_pct(work: list, kernel_s: float) -> float | None:
    """100 x (sum of the calls' bounds) / (the kernels' measured time), or
    None where nothing ran: a share is never made up as 0."""
    if not work or kernel_s <= 0:
        return None
    return 100.0 * sum(bound_s(b, f) for b, f in work) / kernel_s


def kernel_seconds(kernel_time: dict, names) -> float:
    """Seconds of device time of the kernels whose function is one of
    `names` (a profiler name such as ``void lk_refine_kernel<21, ...>(...)``
    carries its function's name before the template arguments)."""
    import re

    pat = re.compile(r"(?:^|[\s:])(" + "|".join(map(re.escape, names))
                     + r")(?:<|\()")
    return sum(s for n, s in kernel_time.items() if pat.search(n))
