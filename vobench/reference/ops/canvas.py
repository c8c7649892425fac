"""Pyramid canvas packing (port of vo_tpu/ops/canvas.py): every pyramid
level placed on one canvas with a reflect-101 apron, so each dense
frontend stage runs once over all levels; per-level interior masks and
level rectangles keep the per-level border rules."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .conv import reflect_pad


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


@functools.lru_cache(maxsize=None)
def plan_canvas(shapes: tuple, apron: int = 4, round_y: int = 8,
                round_x: int = 128) -> tuple:
    """Static shelf layout for level shapes ((H, W), ...): (Hc, Wc,
    origins) with origins[l] the canvas (y, x) of level l's pixel (0, 0)."""
    blocks = [(H + 2 * apron, W + 2 * apron) for H, W in shapes]
    Wc = _round_up(max(bw for _, bw in blocks), round_x)
    shelves: list = []  # [y0, height, x_cursor]
    placements = []
    y = 0
    for bh, bw in blocks:
        for sh in shelves:
            x = _round_up(sh[2], round_x)
            if x + bw <= Wc and bh <= sh[1]:
                placements.append((sh[0], x))
                sh[2] = x + bw
                break
        else:
            h = _round_up(bh, round_y)
            shelves.append([y, h, bw])
            placements.append((y, 0))
            y += h
    Hc = _round_up(y, round_y)
    origins = tuple((py + apron, px + apron) for py, px in placements)
    return Hc, Wc, origins


def pack_canvas(pyr, apron: int = 4):
    """Pack (..., H, W) pyramid levels into one zero canvas, each level
    with an `apron` of its own reflect-101 border. Returns (canvas,
    origins)."""
    shapes = tuple(tuple(im.shape[-2:]) for im in pyr)
    Hc, Wc, origins = plan_canvas(shapes, apron)
    canvas = pyr[0].new_zeros(tuple(pyr[0].shape[:-2]) + (Hc, Wc))
    for im, (oy, ox), (H, W) in zip(pyr, origins, shapes):
        canvas[..., oy - apron:oy + H + apron, ox - apron:ox + W + apron] = \
            reflect_pad(im, apron)
    return canvas, origins


@functools.lru_cache(maxsize=None)
def _interior_mask(canvas_shape: tuple, shapes: tuple, origins: tuple,
                   border: int, device: torch.device) -> torch.Tensor:
    m = np.zeros(canvas_shape, np.float32)
    for (H, W), (oy, ox) in zip(shapes, origins):
        m[oy + border:oy + H - border, ox + border:ox + W - border] = 1.0
    return torch.from_numpy(m).to(device)


def interior_mask(canvas_shape: tuple, shapes: tuple, origins: tuple,
                  border: int = 3, device=None) -> torch.Tensor:
    """(Hc, Wc) float mask: 1 on each level's interior minus `border`
    pixels (the FAST border rule, Fast.cu:160), 0 on aprons and gutters."""
    return _interior_mask(tuple(canvas_shape), tuple(shapes), tuple(origins),
                          border, torch.device(device or "cpu"))
