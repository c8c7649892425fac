"""One LK pyramid level for all points: the plain version of kernel B1,
on any device (`refine_level_reference`, in tensor ops over all points).

Window semantics are those of vo_tpu/ops/lk.py:_refine_level with the
lanes layout: a point's template and search windows are the S x S crops of
the two level images at its integer origins, every pixel outside a window
reads as 0, and samples are bilinear (row blend, then column blend) in f32.
Termination is per point, which is the lanes path with an early exit that
never fires before every point has stopped (``exit_mult = N + 1``).
"""

from __future__ import annotations

import torch

from . import crop_cuda


def _work_dtype(precision: str) -> torch.dtype:
    return {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}.get(
        precision, torch.float32)


def _split(q: torch.Tensor, S: int, half: int):
    """Integer base (minus `half`) and fraction of local coordinates; far
    out-of-window values are clamped (their results are discarded)."""
    b = torch.floor(q)
    f = q - b
    o = torch.clamp(b, -2.0 * S, 2.0 * S).to(torch.int64) - half
    return o, f


def crop_windows(img: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                 S: int, precision: str,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, S, S) crops at integer origins, values in the working type,
    computed in `dtype` (vo_tpu/ops/lk.py:_crop_windows): B3's plain
    version on the converted image."""
    return crop_cuda.crop_windows_reference(
        img.to(_work_dtype(precision)).to(dtype), ox, oy, S)


def _sample(win: torch.Tensor, oy, ox, fy, fx, n: int) -> torch.Tensor:
    """(N, n, n) bilinear samples: out[i, j] blends window rows oy+i,
    oy+i+1 and cols ox+j, ox+j+1, zero outside the window."""
    S = win.shape[-1]
    ar = torch.arange(n + 1, device=win.device)
    r = oy[:, None] + ar  # (N, n+1)
    c = ox[:, None] + ar
    rm = ((r >= 0) & (r < S)).to(win.dtype)
    cm = ((c >= 0) & (c < S)).to(win.dtype)
    rc = r.clamp(0, S - 1)
    cc = c.clamp(0, S - 1)
    g = win[torch.arange(win.shape[0], device=win.device)[:, None, None],
            rc[:, :, None], cc[:, None, :]]
    g = g * rm[:, :, None] * cm[:, None, :]  # (N, n+1, n+1)
    fy = fy[:, None, None]
    fx = fx[:, None, None]
    rows = g[:, :-1, :] * (1.0 - fy) + g[:, 1:, :] * fy  # (N, n, n+1)
    return rows[:, :, :-1] * (1.0 - fx) + rows[:, :, 1:] * fx


def structure_tensor(w1: torch.Tensor, q1: torch.Tensor, win: int):
    """Template T, its central-difference gradients Tx, Ty (N, win, win)
    and the structure tensor (gxx, gxy, gyy) of template windows `w1`
    sampled at local coordinates `q1`."""
    S = w1.shape[-1]
    half = (win + 1) // 2
    oy, fy = _split(q1[:, 1], S, half)
    ox, fx = _split(q1[:, 0], S, half)
    big = _sample(w1, oy, ox, fy, fx, win + 2)  # (N, wp, wp)
    T = big[:, 1:-1, 1:-1]
    Tx = (big[:, 1:-1, 2:] - big[:, 1:-1, :-2]) * 0.5
    Ty = (big[:, 2:, 1:-1] - big[:, :-2, 1:-1]) * 0.5
    G = ((Tx * Tx).sum(dim=(1, 2)), (Tx * Ty).sum(dim=(1, 2)),
         (Ty * Ty).sum(dim=(1, 2)))
    return T, Tx, Ty, G


def refine_level_reference(img1, img2, q1, q20, flow, pre, org1, org2, S,
                           config, dtype=torch.float32):
    """Plain PyTorch version of the B1 kernel; same arguments and results
    as `refine_level`, computed in `dtype` from windows in the working
    type."""
    win = config.win
    half = (win + 1) // 2
    lo, hi = half - 1.0, float(S - half)
    N = q1.shape[0]
    q1, q20, flow = q1.to(dtype), q20.to(dtype), flow.to(dtype)
    w1 = crop_windows(img1, org1[:, 0], org1[:, 1], S, config.precision,
                      dtype)
    w2 = crop_windows(img2, org2[:, 0], org2[:, 1], S, config.precision,
                      dtype)
    T, Tx, Ty, (gxx, gxy, gyy) = structure_tensor(w1, q1, win)
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    min_eig = (trace - torch.sqrt(trace * trace - 4 * det + 1e-12)) / 2.0
    min_eig = min_eig / (win * win)
    solvable = (det > 1e-7) & (min_eig > config.min_eig_threshold)
    inv_det = 1.0 / torch.where(det > 1e-7, det, torch.ones_like(det))

    v = flow.clone()
    running = solvable & pre
    iters = torch.zeros(N, dtype=torch.int32, device=q1.device)
    eps2 = torch.tensor(config.eps**2, dtype=torch.float32).to(dtype)
    for _ in range(config.iters):
        q2 = q20 + v
        out_w = ((q2[:, 0] < lo) | (q2[:, 0] > hi)
                 | (q2[:, 1] < lo) | (q2[:, 1] > hi))
        running = running & ~out_w
        if not bool(running.any()):
            break
        oy, fy = _split(q2[:, 1], S, half)
        ox, fx = _split(q2[:, 0], S, half)
        I = _sample(w2, oy + 1, ox + 1, fy, fx, win)
        dI = I - T
        bx = (dI * Tx).sum(dim=(1, 2))
        by = (dI * Ty).sum(dim=(1, 2))
        step = torch.stack([-(gyy * bx - gxy * by) * inv_det,
                            -(-gxy * bx + gxx * by) * inv_det], dim=1)
        v = torch.where(running[:, None], v + step, v)
        iters = iters + running.to(torch.int32)
        running = running & ~((step * step).sum(dim=1) < eps2)
    return v, solvable, iters


def refine_level(img1, img2, q1, q20, flow, pre, org1, org2, S, config):
    """Refine all points at one level: (v (N, 2), solvable (N,), iterations
    (N,)), as kernel B1 returns them."""
    return refine_level_reference(img1, img2, q1, q20, flow, pre, org1, org2,
                                  S, config)
