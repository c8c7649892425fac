"""(N, S, S) window crops at integer origins: kernel B3 and its plain version.

`crop_windows` replaces vo_tpu/ops/pallas_crop.py:crop_windows_pallas (the
Pallas `_crop_kernel`) and computes what vo_tpu/ops/lk.py:_crop_windows
computes in f32: window k is img[oy[k] + r, ox[k] + c] for 0 <= r, c < S,
with every sample outside the image 0. It takes any S up to 128 and any
origin (the Pallas version needs S % 8 == 0 and 8-aligned rows). On a CUDA
tensor it launches ``csrc/crop_windows.cu``; on a CPU tensor it runs
`crop_windows_reference`. Both copy values, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

MAX_S = 128
launches = 0  # kernel launches, for proving that a run went through B3


def window_indices(H: int, W: int, ox: torch.Tensor, oy: torch.Tensor,
                   S: int):
    """Rows (N, S) and columns (N, S) of each window's samples in an
    (H, W) image, and which of its (N, S, S) samples lie inside it."""
    ar = torch.arange(S, device=ox.device)
    rows = oy.long()[:, None] + ar
    cols = ox.long()[:, None] + ar
    inside = (((rows >= 0) & (rows < H))[:, :, None]
              & ((cols >= 0) & (cols < W))[:, None, :])
    return rows, cols, inside


def crop_windows_reference(img: torch.Tensor, ox: torch.Tensor,
                           oy: torch.Tensor, S: int) -> torch.Tensor:
    """Plain PyTorch version: advanced indexing with clamped indices, then
    zero where a sample lies outside the image."""
    H, W = img.shape
    rows, cols, inside = window_indices(H, W, ox, oy, S)
    win = img[rows.clamp(0, H - 1)[:, :, None], cols.clamp(0, W - 1)[:, None, :]]
    return torch.where(inside, win, torch.zeros((), dtype=img.dtype,
                                                device=img.device))


def crop_windows(img: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                 S: int) -> torch.Tensor:
    """(N, S, S) crops of img (H, W) f32 at integer origins (ox, oy) (N,)."""
    global launches
    if img.dim() != 2:
        raise ValueError("crop_windows: img must be (H, W)")
    if not 0 < S <= MAX_S:
        raise ValueError(f"crop_windows: S={S} outside 1..{MAX_S}")
    N = ox.shape[0]
    if ox.shape != (N,) or oy.shape != (N,):
        raise ValueError("crop_windows: origins must be two (N,) tensors")
    if ox.device != img.device or oy.device != img.device:
        raise ValueError("crop_windows: all tensors must share one device")
    if img.device.type == "cpu":
        return crop_windows_reference(img, ox, oy, S)
    if img.device.type != "cuda":
        raise RuntimeError(f"crop_windows: no kernel for {img.device}")
    if img.dtype != torch.float32:
        raise TypeError(f"crop_windows: needs float32, got {img.dtype}")
    H, W = img.shape
    x = img.contiguous()
    ox32 = ox.to(torch.int32).contiguous()
    oy32 = oy.to(torch.int32).contiguous()
    out = torch.empty((N, S, S), dtype=torch.float32, device=img.device)
    lib = _lib()
    code = lib.crop_windows_f32(x.data_ptr(), H, W, ox32.data_ptr(),
                                oy32.data_ptr(), N, S, out.data_ptr(),
                                _build.stream_ptr(img.device))
    _build.check(lib, code, "crop_windows_f32")
    launches += 1
    return out


def _lib():
    lib = _build.load("crop_windows")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crop_windows_f32.argtypes = [p, i, i, p, p, i, i, p, p]
        lib.crop_windows_f32.restype = ctypes.c_int
        lib._typed = True
    return lib
