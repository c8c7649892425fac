"""ORB detect-and-compute over a canvas-packed pyramid (port of
vo_tpu/frontend/orb.py, canvas path).

Parity notes vs orb.cpp, as in vo_tpu: per-level budget nfeatures *
((1-1/s)/(1-(1/s)^L)) * (1/s)^l, int-truncated; FAST into a 2x budget,
Harris rerank to the budget; BRIEF on the level image; coordinates mapped
to level 0 by s^l; output order level-major, Harris-descending.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.brief import brief_descriptors
from ..ops.canvas import interior_mask, pack_canvas
from ..ops.fast import fast_score
from ..ops.harris import harris_response
from ..ops.nms import blocked_topk_2d, nms_mask, topk_stable
from ..ops.orientation import orientations_at
from ..ops.pyramid import build_pyramid


class OrbConfig(NamedTuple):
    """Static ORB parameters (defaults: orb.hpp:36 / orb.hpp:12)."""

    nfeatures: int = 500
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_threshold: float = 20.0
    fast_n: int = 9
    nms_window: int = 3
    patch_size: int = 31
    harris_block: int = 7
    harris_k: float = 0.04


class OrbFeatures(NamedTuple):
    """Fixed-capacity ORB feature set (K = sum of per-level budgets)."""

    xs: torch.Tensor  # (K,) float32, level-0 coordinates
    ys: torch.Tensor  # (K,)
    scores: torch.Tensor  # (K,) Harris response
    angles: torch.Tensor  # (K,) radians
    bits: torch.Tensor  # (K, 256) uint8 bit planes
    packed: torch.Tensor  # (K, 32) uint8, reference byte layout
    level: torch.Tensor  # (K,) int32
    valid: torch.Tensor  # (K,) bool

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1)


def level_budgets(config: OrbConfig) -> list[int]:
    """Per-level feature budgets, C++ int truncation (orb.cpp:62)."""
    inv = 1.0 / config.scale_factor
    factor = (1.0 - inv) / (1.0 - inv**config.n_levels)
    return [
        max(1, int(config.nfeatures * factor * inv**l))
        for l in range(config.n_levels)
    ]


@functools.lru_cache(maxsize=None)
def _level_rects(shapes: tuple, origins: tuple, budgets: tuple,
                 device: torch.device) -> tuple:
    """Per-keypoint level rectangles (x0, y0, x1, y1) in canvas coords."""
    rect = np.concatenate([
        np.broadcast_to(np.array([ox, oy, ox + Wl, oy + Hl], np.int64), (b, 4))
        for (Hl, Wl), (oy, ox), b in zip(shapes, origins, budgets)
    ])
    return tuple(torch.from_numpy(rect[:, i].copy()).to(device)
                 for i in range(4))


def _detect_canvas(pyr, budgets, config: OrbConfig) -> OrbFeatures:
    shapes = tuple(tuple(im.shape) for im in pyr)
    canvas, origins = pack_canvas(pyr)
    dev = canvas.device

    score = fast_score(canvas, config.fast_threshold, config.fast_n)
    score = score * interior_mask(canvas.shape, shapes, origins, border=3,
                                  device=dev)
    resp = torch.where(nms_mask(score, config.nms_window // 2) & (score > 0),
                       score, torch.zeros_like(score))
    harris = harris_response(canvas, config.harris_block, config.harris_k)

    sel_xs, sel_ys, sel_h, sel_valid = [], [], [], []
    for (Hl, Wl), (oy, ox), budget in zip(shapes, origins, budgets):
        top, ys_l, xs_l, _ = blocked_topk_2d(
            resp[oy:oy + Hl, ox:ox + Wl], 2 * budget)
        cy, cx = ys_l + oy, xs_l + ox
        h = torch.where(top > 0.0, harris[cy, cx], -torch.inf)
        top_h, idx = topk_stable(h, budget)
        valid = top_h > -torch.inf
        sel_xs.append(cx[idx])
        sel_ys.append(cy[idx])
        sel_h.append(torch.where(valid, top_h, torch.zeros_like(top_h)))
        sel_valid.append(valid)
    xs, ys = torch.cat(sel_xs), torch.cat(sel_ys)
    hscore, valid = torch.cat(sel_h), torch.cat(sel_valid)

    rect = _level_rects(shapes, origins, tuple(budgets), dev)
    angles = orientations_at(canvas, ys, xs, config.patch_size, rect=rect)
    bits, packed = brief_descriptors(canvas, ys, xs, angles, rect=rect)

    # back to level coordinates, then to level 0 by s^l
    lvl = torch.cat([torch.full((b,), l, dtype=torch.int32, device=dev)
                     for l, b in enumerate(budgets)])
    oxs = torch.cat([torch.full((b,), o[1], device=dev)
                     for o, b in zip(origins, budgets)])
    oys = torch.cat([torch.full((b,), o[0], device=dev)
                     for o, b in zip(origins, budgets)])
    scale = torch.cat([torch.full((b,), config.scale_factor**l, device=dev)
                       for l, b in enumerate(budgets)])
    zero = torch.zeros_like(hscore)
    v8 = valid[:, None].to(torch.uint8)
    return OrbFeatures(
        xs=torch.where(valid, (xs - oxs).float(), zero) * scale,
        ys=torch.where(valid, (ys - oys).float(), zero) * scale,
        scores=hscore,
        angles=torch.where(valid, angles, zero),
        bits=bits * v8,
        packed=packed * v8,
        level=lvl,
        valid=valid,
    )


def orb_detect_and_compute(img: torch.Tensor, config: OrbConfig = OrbConfig()
                           ) -> OrbFeatures:
    """ORB features for one (H, W) float32 image, all levels packed."""
    budgets = level_budgets(config)
    pyr = build_pyramid(img, config.n_levels, config.scale_factor)
    return _detect_canvas(pyr, budgets, config)
