"""Carry a pipeline state across from vo_tpu (the system has no weights:
its state is what crosses over), and back to numpy.

Each `*_from_numpy` takes a vo_tpu state whose leaves were passed through
np.asarray (``jax.tree.map(np.asarray, state)``). The JAX PRNG key does not
carry over: the new state draws from a torch generator seeded with `seed`
(tests inject RANSAC slots instead).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ba.window import WindowState
from ..ops.lk import LKCache
from .vo import MatchingState, TrackingState
from .vo_3frame import ThreeFrameState
from .vo_ba import TrackingBAState


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _tracking_fields(d, dev) -> dict:
    """The tracking part shared by TrackingState and TrackingBAState.

    vo_tpu's cached LK windows are crops of its stored pyramid at the
    cached origins (padded TPU lane stacks); the port reads windows from
    the pyramid at those origins, so only the origins carry over."""
    return dict(
        pyramid=tuple(_tensor(p, dev) for p in d.pyramid),
        lk_cache=LKCache(origins=tuple(
            _tensor(o, dev).float() for o in d.lk_cache.origins)),
        pts=_tensor(d.pts, dev).float(),
        pts_valid=_tensor(d.pts_valid, dev).bool(),
        prev3d=_tensor(d.prev3d, dev).float(),
        prev3d_valid=_tensor(d.prev3d_valid, dev).bool(),
        pose=_tensor(d.pose, dev).float(),
        dipped=_tensor(d.dipped, dev).to(torch.int32),
    )


def state_from_numpy(d, device=None, seed: int = 0) -> TrackingState:
    """The port's TrackingState from a vo_tpu TrackingState."""
    dev = resolve_device(device)
    return TrackingState(**_tracking_fields(d, dev),
                         gen=_generator(dev, seed),
                         health=_tensor(d.health, dev).to(torch.int32))


def _descriptors(a, dev) -> torch.Tensor:
    """ORB bit planes stay uint8, SIFT descriptors f32."""
    t = _tensor(a, dev)
    return t if t.dtype == torch.uint8 else t.float()


def matching_state_from_numpy(d, device=None, seed: int = 0
                              ) -> MatchingState:
    """The port's MatchingState from a vo_tpu MatchingState."""
    dev = resolve_device(device)
    return MatchingState(
        pts=_tensor(d.pts, dev).float(),
        desc=_descriptors(d.desc, dev),
        valid=_tensor(d.valid, dev).bool(),
        prev3d=_tensor(d.prev3d, dev).float(),
        prev3d_valid=_tensor(d.prev3d_valid, dev).bool(),
        pose=_tensor(d.pose, dev).float(),
        gen=_generator(dev, seed),
    )


def three_frame_state_from_numpy(d, device=None, seed: int = 0
                                 ) -> ThreeFrameState:
    """The port's ThreeFrameState from a vo_tpu ThreeFrameState."""
    dev = resolve_device(device)
    return ThreeFrameState(
        pts_a=_tensor(d.pts_a, dev).float(),
        pts_b=_tensor(d.pts_b, dev).float(),
        desc_b=_descriptors(d.desc_b, dev),
        valid_b=_tensor(d.valid_b, dev).bool(),
        m_ab_idx=_tensor(d.m_ab_idx, dev).long(),
        m_ab_valid=_tensor(d.m_ab_valid, dev).bool(),
        R_ab=_tensor(d.R_ab, dev).float(),
        t_ab=_tensor(d.t_ab, dev).float(),
        pose=_tensor(d.pose, dev).float(),
        gen=_generator(dev, seed),
        n_frames=_tensor(d.n_frames, dev).to(torch.int32),
    )


def tracking_ba_state_from_numpy(d, device=None, seed: int = 0
                                 ) -> TrackingBAState:
    """The port's TrackingBAState from a vo_tpu TrackingBAState, window
    and landmark map included."""
    dev = resolve_device(device)
    w = d.window
    return TrackingBAState(
        **_tracking_fields(d, dev),
        window=WindowState(
            poses=_tensor(w.poses, dev).float(),
            obs=_tensor(w.obs, dev).float(),
            valid=_tensor(w.valid, dev).bool(),
            count=_tensor(w.count, dev).to(torch.int32),
        ),
        map_X=_tensor(d.map_X, dev).float(),
        map_ok=_tensor(d.map_ok, dev).bool(),
        frame_idx=_tensor(d.frame_idx, dev).to(torch.int32),
        gen=_generator(dev, seed),
    )


def state_to_numpy(state):
    """The same state type with every tensor leaf as a numpy array (nested
    states and tuples included) and the generator as None."""
    if isinstance(state, torch.Tensor):
        return state.detach().float().cpu().numpy() \
            if state.dtype == torch.bfloat16 else state.detach().cpu().numpy()
    if isinstance(state, torch.Generator):
        return None
    if isinstance(state, tuple):
        items = [state_to_numpy(x) for x in state]
        return type(state)(*items) if hasattr(state, "_fields") \
            else tuple(items)
    return state
