"""Carry a tracking state across from vo_tpu (the system has no weights:
this state is what crosses over)."""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.lk import LKCache
from .vo import TrackingState


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def state_from_numpy(d, device=None, seed: int = 0) -> TrackingState:
    """The port's TrackingState from a vo_tpu TrackingState whose leaves
    were passed through np.asarray (``jax.tree.map(np.asarray, state)``).

    vo_tpu's cached LK windows are crops of its stored pyramid at the
    cached origins (padded TPU lane stacks); the port reads windows from
    the pyramid at those origins, so only the origins carry over. The JAX
    PRNG key does not: the new state draws from a torch generator seeded
    with `seed` (tests inject RANSAC slots instead)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return TrackingState(
        pyramid=tuple(_tensor(p, dev) for p in d.pyramid),
        lk_cache=LKCache(origins=tuple(
            _tensor(o, dev).float() for o in d.lk_cache.origins)),
        pts=_tensor(d.pts, dev).float(),
        pts_valid=_tensor(d.pts_valid, dev).bool(),
        prev3d=_tensor(d.prev3d, dev).float(),
        prev3d_valid=_tensor(d.prev3d_valid, dev).bool(),
        pose=_tensor(d.pose, dev).float(),
        gen=gen,
        health=_tensor(d.health, dev).to(torch.int32),
        dipped=_tensor(d.dipped, dev).to(torch.int32),
    )
