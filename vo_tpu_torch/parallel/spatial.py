"""Spatial parallelism: image rows sharded over ranks, stencils with a
halo exchange (port of vo_tpu/parallel/spatial.py).

The analogue of the reference's shared-memory apron loads (Fast.cu:53-155
loads a RADIUS=3 apron into each block's shared memory): here the "block"
is a rank's row shard, and its apron comes from the neighbouring shards in
point-to-point exchanges. The dense stencil runs on the extended shard and
the apron rows are cropped off; the global top and bottom shards take a
reflect-101 apron of their own rows instead (the reference's
BORDER_REFLECT_101, GaussianBlur.cu:75), so the result equals the dense
stencil's bit for bit, and the blur runs on kernel B2 on each shard.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_size


def _exchange_halo(x: torch.Tensor, halo: int, mesh: DeviceMesh,
                   axis: str) -> torch.Tensor:
    """Prepend/append `halo` rows from the neighbouring shards
    (reflect-101 at the global top/bottom). x: (rows_local, W) ->
    (rows + 2 halo, W)."""
    if x.shape[0] < halo + 1:
        raise ValueError(f"halo exchange: a shard of {x.shape[0]} rows needs "
                         f"at least halo + 1 = {halo + 1}")
    n, i = axis_size(mesh, axis), mesh.get_local_rank(axis)
    top = x[1:halo + 1].flip(0)
    bot = x[-halo - 1:-1].flip(0)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    # my top apron is the bottom of the shard above, my bottom apron the
    # top of the shard below; the global top and bottom shards have no
    # neighbour there (vo_tpu's ring wrap is discarded, so none is sent)
    ops = []
    if i > 0:
        top = torch.empty_like(x[:halo])
        ops += [dist.P2POp(dist.isend, x[:halo].contiguous(), ranks[i - 1],
                           group),
                dist.P2POp(dist.irecv, top, ranks[i - 1], group)]
    if i < n - 1:
        bot = torch.empty_like(x[:halo])
        ops += [dist.P2POp(dist.isend, x[-halo:].contiguous(), ranks[i + 1],
                           group),
                dist.P2POp(dist.irecv, bot, ranks[i + 1], group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([top, x, bot], 0)


def sharded_stencil(
    mesh: DeviceMesh,
    kernel_same: Callable[[torch.Tensor], torch.Tensor],
    halo: int,
    axis: str = "row",
    border: int = 0,
):
    """Lift a same-padded (H, W) -> (H, W) stencil to a row-sharded one:
    returns fn(x_local) -> out_local for this rank's block of rows (equal
    blocks in rank order along `axis`).

    `kernel_same` must use at most `halo` rows of context per output row
    (5x5 blur: 2, FAST-9: 3). `border` > 0 zeroes that many rows at the
    *global* top/bottom, for kernels that mask their border (FAST's
    3-pixel exclusion): the seam shards must not bring back values the
    dense kernel masks."""

    def body(x):
        out = kernel_same(_exchange_halo(x, halo, mesh, axis))[halo:-halo]
        if border > 0:
            rows = x.shape[0]
            total = axis_size(mesh, axis) * rows
            r = torch.arange(rows, device=x.device) \
                + mesh.get_local_rank(axis) * rows
            keep = ((r >= border) & (r < total - border))[:, None]
            out = torch.where(keep, out, torch.zeros_like(out))
        return out

    return body


def sharded_gaussian_blur(mesh: DeviceMesh, axis: str = "row"):
    """Row-sharded 5x5 binomial blur (the GaussianBlur1D.cu pipeline), on
    kernel B2 for CUDA shards."""
    from ..ops.conv import binomial_blur5

    return sharded_stencil(mesh, binomial_blur5, halo=2, axis=axis)


def sharded_fast_score(
    mesh: DeviceMesh,
    threshold: float = 20.0,
    n: int = 9,
    axis: str = "row",
):
    """Row-sharded FAST-9 score map (circle radius 3 -> halo 3)."""
    from ..ops.fast import fast_score

    return sharded_stencil(
        mesh,
        functools.partial(fast_score, threshold=threshold, n=n),
        halo=3,
        axis=axis,
        border=3,  # FAST masks the 3-pixel image border (Fast.cu:160)
    )
