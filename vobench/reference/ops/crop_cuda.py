"""(N, S, S) window crops at integer origins: the plain version of kernel
B3, on any device. Window k is img[oy[k] + r, ox[k] + c] for
0 <= r, c < S, with every sample outside the image 0."""

from __future__ import annotations

import torch


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
    """Advanced indexing with clamped indices, then zero where a sample
    lies outside the image."""
    H, W = img.shape
    rows, cols, inside = window_indices(H, W, ox, oy, S)
    win = img[rows.clamp(0, H - 1)[:, :, None], cols.clamp(0, W - 1)[:, None, :]]
    return torch.where(inside, win, torch.zeros((), dtype=img.dtype,
                                                device=img.device))


def crop_windows_pair_reference(a: torch.Tensor, b: torch.Tensor,
                                ox: torch.Tensor, oy: torch.Tensor,
                                S: int) -> torch.Tensor:
    """The two plain crops, stacked: (2, N, S, S)."""
    return torch.stack([crop_windows_reference(a, ox, oy, S),
                        crop_windows_reference(b, ox, oy, S)])


crop_windows = crop_windows_reference
crop_windows_pair = crop_windows_pair_reference
