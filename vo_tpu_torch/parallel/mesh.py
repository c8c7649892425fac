"""Process groups and device meshes (port of vo_tpu/parallel/mesh.py).

PyTorch runs SPMD: one process per device, each holding its own shard,
with explicit collectives between them. One logical mesh with named axes,
as in vo_tpu:

- "frame": data parallelism over independent frames (batched detect and
  match);
- "kp":    keypoint-set sharding for matching, LK tracking and the
           landmark axis of distributed BA;
- "row":   image rows for stencils (halo exchange between neighbouring
           shards).

Every rank calls `init_process_group` (the backend follows the device:
``nccl`` for ``cuda``, ``gloo`` only when the caller asks for ``cpu``;
every group gets a timeout, so a dead peer fails the run instead of
hanging it), then `make_mesh` or `make_mesh_2d`. `launch.spawn` does both
for a function run in N processes.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import resolve_device
from ..ba.schur import _lsum

GROUP_TIMEOUT_S = 60.0

# PyTorch 2.13 deprecates all_gather_into_tensor (a FutureWarning on every
# call) for all_gather_single, which 2.11 does not have yet: the same
# collective under the name this PyTorch prefers
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_process_group(rank: int, world: int, init_method: str, device=None,
                       timeout_s: float = GROUP_TIMEOUT_S) -> torch.device:
    """Join the default process group as `rank` of `world` (rendezvous at
    `init_method`, e.g. ``file:///tmp/x/store``) on `device` (``cuda``
    unless told otherwise: ``nccl``; ``cpu``: ``gloo``). Returns this
    rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        _backend(dev), init_method=init_method, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _check_group(device: torch.device, n: int | None) -> int:
    """The default group's size, checked against `n` ranks on `device`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.mesh.init_process_group on every rank "
                           "first")
    backend = dist.get_backend()
    if backend != _backend(device):
        raise RuntimeError(f"make_mesh: a {device.type} mesh needs the "
                           f"{_backend(device)} backend, the group has "
                           f"{backend}")
    world = dist.get_world_size()
    if n not in (None, world):
        raise ValueError(f"make_mesh: a mesh of {n} ranks in a group of "
                         f"{world}")
    return world


def make_mesh(n_devices: int | None = None, axis: str = "kp",
              device=None) -> DeviceMesh:
    """1-D mesh over every rank of the default group (`n_devices`, where
    given, must be its size), on `device` (``cuda`` unless told
    otherwise; raises without a card)."""
    dev = resolve_device(device)
    n = _check_group(dev, n_devices)
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(axis,))


def make_mesh_2d(shape: tuple[int, int],
                 axes: tuple[str, str] = ("frame", "kp"),
                 device=None) -> DeviceMesh:
    """2-D mesh, e.g. frames x keypoint shards (rank = i * shape[1] + j)."""
    dev = resolve_device(device)
    _check_group(dev, shape[0] * shape[1])
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def rank_device() -> torch.device:
    """This rank's device in the default group: its card under nccl, else
    the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def all_gather_leading(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` concatenated along dim 0 in rank order (bool
    travels as uint8)."""
    n = dist.get_world_size(group)
    src = x.contiguous()
    if x.dtype == torch.bool:
        src = src.to(torch.uint8)
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _all_gather(out, src, group=group)
    return out.bool() if x.dtype == torch.bool else out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: `x` summed over the group (BA's landmark sum)."""
    return _lsum(x, group)


def shard_leading(mesh: DeviceMesh, axis: str, x: torch.Tensor
                  ) -> torch.Tensor:
    """This rank's block of the leading dim of a global tensor, cut into
    equal blocks in rank order along `axis`."""
    n, i = axis_size(mesh, axis), mesh.get_local_rank(axis)
    if x.shape[0] % n:
        raise ValueError(f"shard_leading: {x.shape[0]} rows over {n} ranks; "
                         f"pad to a multiple first (pad_to_multiple)")
    k = x.shape[0] // n
    return x[i * k:(i + 1) * k]


def replicated(mesh: DeviceMesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """The global tensor back from every rank's block along `axis`."""
    return all_gather_leading(x, mesh.get_group(axis))


def max_rank_deviation(x: torch.Tensor, group) -> float:
    """The largest |x - rank 0's x| over every rank of the group (0.0 when
    every rank holds the same values)."""
    ref = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(ref, src=dist.get_global_rank(group, 0), group=group)
    dev = (x.double() - ref.double()).abs().max()
    dist.all_reduce(dev, op=dist.ReduceOp.MAX, group=group)
    return float(dev)
