"""Pyramidal Lucas-Kanade feature tracking (port of vo_tpu/ops/lk.py).

Per level, each point gets a fixed S x S search window around its
propagated position; the level's Gauss-Newton solve runs in kernel B1
(`lk_cuda.refine_level`). Points that end outside their window are lost,
as cv2's status=0.

The port keeps no window stacks: a window is the crop of a level image at
its integer origin, so the cache that carries a frame's search windows to
the next step as its templates is the origins alone, read against the
previous frame's pyramid. Termination is per point (see lk_cuda).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lk_cuda
from .pyramid import build_halving_pyramid


class LKConfig(NamedTuple):
    win: int = 21  # feature_tracking.cpp:174 (21, 21)
    max_level: int = 3  # maxLevel 3 -> 4 levels
    iters: int = 30  # TermCriteria 30, 0.01 (feature_tracking.cpp:178)
    eps: float = 0.01
    min_eig_threshold: float = 1e-4  # cv2 minEigThreshold default
    # working type of the windows: "bf16" (levels 1+ stored in bf16, level
    # 0 rounded on load) or "f32"; sums are f32 either way
    precision: str = "bf16"
    window_margin: int = 6  # search radius beyond the patch, finer levels
    coarse_margin: int = 24  # the coarsest level absorbs the frame motion


class LKCache(NamedTuple):
    """Per-level (N, 2) float window origins [x, y] of the previous
    frame's search windows (the next step's templates)."""

    origins: tuple


def lk_build_pyramid(img: torch.Tensor, config: LKConfig) -> tuple:
    """Halving pyramid with levels 1+ in the LK working type (level 0 stays
    the raw image for the detectors)."""
    dt = torch.bfloat16 if config.precision == "bf16" else None
    return tuple(build_halving_pyramid(img, config.max_level + 1, dtype=dt))


def lk_level_geometry(shapes, config: LKConfig):
    """Static per-level window geometry: list over levels of
    (S, full_margin, skip)."""
    wp = config.win + 2
    n_levels = min(config.max_level + 1, len(shapes))
    out = []
    for L in range(n_levels):
        Hl, Wl = shapes[L]
        if Hl < wp or Wl < wp:
            out.append((1, False, True))
            continue
        margin = (
            config.coarse_margin if L == n_levels - 1 else config.window_margin
        )
        S = min(wp + 2 * margin, Hl, Wl)
        out.append((S, S == wp + 2 * margin, False))
    return out


def _window_origins(c: torch.Tensor, S: int, Hl: int, Wl: int):
    """Integer window origins (torch.round is half-to-even, as jnp.round)."""
    r = torch.round(c).to(torch.int32)
    ox = torch.clamp(r[:, 0] - S // 2, 0, Wl - S)
    oy = torch.clamp(r[:, 1] - S // 2, 0, Hl - S)
    return ox, oy


def lk_make_cache(pyr, pts: torch.Tensor, config: LKConfig = LKConfig()
                  ) -> LKCache:
    """Window origins around pts (at init and after re-detects)."""
    geo = lk_level_geometry([tuple(im.shape) for im in pyr], config)
    origins = []
    for L, (S, _, skip) in enumerate(geo):
        if skip:
            origins.append(torch.zeros_like(pts))
            continue
        Hl, Wl = pyr[L].shape
        ox, oy = _window_origins(pts / (2.0**L), S, Hl, Wl)
        origins.append(torch.stack([ox, oy], 1).float())
    return LKCache(origins=tuple(origins))


def _box_out(q: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return (q[:, 0] < lo) | (q[:, 0] > hi) | (q[:, 1] < lo) | (q[:, 1] > hi)


def _track_over_levels(pyr1, origins1, pyr2, pts, valid, config: LKConfig):
    """Coarse-to-fine loop. `origins1(L, S, Hl, Wl, p)` gives the template
    window origins at level L (windows are read from pyr1). Returns
    (new_pts, status, cache2) with cache2 = this frame's search windows."""
    geo = lk_level_geometry([tuple(im.shape) for im in pyr2], config)
    n_levels = len(geo)
    H0, W0 = pyr2[0].shape
    half = (config.win + 1) // 2

    flow = torch.zeros_like(pts)
    ok = valid
    origins2 = [None] * n_levels
    for L in reversed(range(n_levels)):
        S, full_margin, skip = geo[L]
        Hl, Wl = pyr2[L].shape
        if skip:
            origins2[L] = torch.zeros_like(pts)
            continue
        p = pts / (2.0**L)
        ox2, oy2 = _window_origins(p + flow, S, Hl, Wl)
        origin2 = torch.stack([ox2, oy2], 1).float()
        origins2[L] = origin2
        origin1 = origins1(L, S, Hl, Wl, p)

        lo, hi = half - 1.0, float(S - half)
        q1 = p - origin1
        tmpl_out = _box_out(q1, lo, hi)
        v, solvable, _ = lk_cuda.refine_level(
            pyr1[L], pyr2[L], q1, p - origin2, flow, ok & ~tmpl_out,
            origin1, origin2, S, config,
        )
        c = p + v
        inside = (c[:, 0] >= 0) & (c[:, 0] <= Wl - 1) \
            & (c[:, 1] >= 0) & (c[:, 1] <= Hl - 1)
        # templates outside their window were not refined here: they pass
        # through to finer levels, their solvability does not count
        ok = ok & torch.where(tmpl_out, True, solvable) & inside
        if full_margin:
            # ending outside the search window exceeded the level's radius
            ok = ok & (tmpl_out | ~_box_out(c - origin2, lo, hi))
        flow = v * 2.0 if L > 0 else v

    new_pts = pts + flow
    inside0 = (new_pts[:, 0] >= 0) & (new_pts[:, 0] <= W0 - 1) \
        & (new_pts[:, 1] >= 0) & (new_pts[:, 1] <= H0 - 1)
    status = ok & inside0
    out = torch.where(status[:, None], new_pts, pts)
    return out, status, LKCache(origins=tuple(origins2))


def lk_pyramid_track(pyr1, pyr2, pts, valid, config: LKConfig = LKConfig()):
    """Track pts (N, 2) [x, y] from pyramid pyr1 to pyr2; template windows
    around pts in pyr1. Returns (new_pts (N, 2), status (N,) bool)."""

    def origins1(L, S, Hl, Wl, p):
        ox1, oy1 = _window_origins(p, S, Hl, Wl)
        return torch.stack([ox1, oy1], 1).float()

    out, status, _ = _track_over_levels(pyr1, origins1, pyr2, pts, valid,
                                        config)
    return out, status


def lk_pyramid_track_cached(cache: LKCache, pyr1, pyr2, pts, valid,
                            config: LKConfig = LKConfig()):
    """Like lk_pyramid_track, with the template windows at the previous
    step's search origins (`cache`) in pyr1, the previous frame's pyramid.
    Returns (new_pts, status, cache2)."""
    return _track_over_levels(
        pyr1, lambda L, S, Hl, Wl, p: cache.origins[L], pyr2, pts, valid,
        config,
    )
