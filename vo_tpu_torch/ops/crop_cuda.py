"""(N, S, S) window crops at integer origins: kernel B3 and its plain version.

`crop_windows` replaces vo_tpu/ops/pallas_crop.py:crop_windows_pallas (the
Pallas `_crop_kernel`) and computes what vo_tpu/ops/lk.py:_crop_windows
computes in f32: window k is img[oy[k] + r, ox[k] + c] for 0 <= r, c < S,
with every sample outside the image 0. It takes any S up to 128 and any
origin (the Pallas version needs S % 8 == 0 and 8-aligned rows).
`crop_windows_pair` cuts two maps of one shape at the same origins in one
launch (SIFT's gx and gy) and returns them stacked, (2, N, S, S). On a CUDA
tensor both launch ``csrc/crop_windows.cu`` (nothing for N = 0); on a CPU
tensor they run `crop_windows_reference` and `crop_windows_pair_reference`.
A crop copies values, so kernel and plain version agree bit for bit.
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


def crop_windows_pair_reference(a: torch.Tensor, b: torch.Tensor,
                                ox: torch.Tensor, oy: torch.Tensor,
                                S: int) -> torch.Tensor:
    """Plain PyTorch version of the pair: the two plain crops, stacked."""
    return torch.stack([crop_windows_reference(a, ox, oy, S),
                        crop_windows_reference(b, ox, oy, S)])


def _check(what: str, maps, ox: torch.Tensor, oy: torch.Tensor, S: int):
    if any(m.dim() != 2 for m in maps):
        raise ValueError(f"{what}: maps must be (H, W)")
    if any(m.shape != maps[0].shape for m in maps):
        raise ValueError(f"{what}: maps must share one shape")
    if not 0 < S <= MAX_S:
        raise ValueError(f"{what}: S={S} outside 1..{MAX_S}")
    N = ox.shape[0]
    if ox.shape != (N,) or oy.shape != (N,):
        raise ValueError(f"{what}: origins must be two (N,) tensors")
    dev = maps[0].device
    if any(t.device != dev for t in (*maps, ox, oy)):
        raise ValueError(f"{what}: all tensors must share one device")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for {dev}")
    if any(m.dtype != torch.float32 for m in maps):
        raise TypeError(f"{what}: needs float32, got "
                        f"{[m.dtype for m in maps]}")


def _launch(maps, ox: torch.Tensor, oy: torch.Tensor, S: int) -> torch.Tensor:
    """Launch B3 over one or two maps: (len(maps), N, S, S), each map's
    windows starting 16 bytes aligned (the kernel stores float4s)."""
    global launches
    H, W = maps[0].shape
    N = ox.shape[0]
    M = N * S * S
    Mp = (M + 3) // 4 * 4
    buf = torch.empty(len(maps) * Mp, dtype=torch.float32,
                      device=maps[0].device)
    out = buf.as_strided((len(maps), N, S, S), (Mp, S * S, S, 1))
    if N == 0:
        return out
    xs = [m.contiguous() for m in maps]
    ox32 = ox.to(torch.int32).contiguous()
    oy32 = oy.to(torch.int32).contiguous()
    lib = _lib()
    stream = _build.stream_ptr(maps[0].device)
    if len(maps) == 1:
        code = lib.crop_windows_f32(xs[0].data_ptr(), H, W, ox32.data_ptr(),
                                    oy32.data_ptr(), N, S, buf.data_ptr(),
                                    stream)
        what = "crop_windows_f32"
    else:
        code = lib.crop_windows_pair_f32(
            xs[0].data_ptr(), xs[1].data_ptr(), H, W, ox32.data_ptr(),
            oy32.data_ptr(), N, S, buf.data_ptr(), buf[Mp:].data_ptr(),
            stream)
        what = "crop_windows_pair_f32"
    _build.check(lib, code, what)
    launches += 1
    return out


def crop_windows(img: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                 S: int) -> torch.Tensor:
    """(N, S, S) crops of img (H, W) f32 at integer origins (ox, oy) (N,)."""
    _check("crop_windows", (img,), ox, oy, S)
    if img.device.type == "cpu":
        return crop_windows_reference(img, ox, oy, S)
    return _launch((img,), ox, oy, S)[0]


def crop_windows_pair(a: torch.Tensor, b: torch.Tensor, ox: torch.Tensor,
                      oy: torch.Tensor, S: int) -> torch.Tensor:
    """(2, N, S, S): the crops of a and of b, two (H, W) f32 maps, at the
    same integer origins (ox, oy) (N,), in one launch. Equal to stacking
    `crop_windows(a, ...)` and `crop_windows(b, ...)`."""
    _check("crop_windows_pair", (a, b), ox, oy, S)
    if a.device.type == "cpu":
        return crop_windows_pair_reference(a, b, ox, oy, S)
    return _launch((a, b), ox, oy, S)


def _lib():
    lib = _build.load("crop_windows")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crop_windows_f32.argtypes = [p, i, i, p, p, i, i, p, p]
        lib.crop_windows_f32.restype = ctypes.c_int
        lib.crop_windows_pair_f32.argtypes = [p, p, i, i, p, p, i, i, p, p,
                                              p]
        lib.crop_windows_pair_f32.restype = ctypes.c_int
        lib._typed = True
    return lib
