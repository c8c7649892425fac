"""Checkpoint / resume of a pipeline's state (port of
vo_tpu/runtime/checkpoint.py).

The reference has no checkpointing: paths are dumped only at the end
(savePaths, feature_tracking.cpp:330-357) and a crash loses the run
(SURVEY.md §5). Here the whole VO state is an explicit NamedTuple of
tensors plus the RANSAC generator, so a checkpoint is one .npz of its
fields by name (``"window.poses"``, ``"pyramid.2"``), the generator's state
and the frame cursor, on local disk. Works for TrackingState /
MatchingState / TrackingBAState / ThreeFrameState alike.
`load_vo_tpu_checkpoint` reads a checkpoint that vo_tpu wrote.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from ..models.convert import (
    matching_state_from_numpy,
    state_from_numpy,
    three_frame_state_from_numpy,
    tracking_ba_state_from_numpy,
)
from ..models.vo import MatchingVO, TrackingVO
from ..models.vo_3frame import ThreeFrameVO
from ..models.vo_ba import TrackingBAVO

# Version tag of the serialized re-detect gate snapshot, the layout of
# vo_tpu's (inbox entries are (2,) [dip latch, count] vectors), so that a
# snapshot from either package restores into the other's gate. A stale
# snapshot fails with a version message instead of deep in the resume.
GATE_SCHEMA = 3

# The port's own state layout: fields stored by name; LKCache holds the
# per-level window origins only (the port keeps no TPU window stacks); the
# RANSAC generator's state stands where vo_tpu keeps a PRNG key. vo_tpu's
# layouts are integers, so neither package mistakes the other's file.
STATE_SCHEMA = "vo_tpu_torch/1"

# vo_tpu's leaf order (jax.tree.flatten of its states, vo_tpu state
# schema 3); "*" marks a per-LK-level tuple.
_VO_TPU_SCHEMA = 3
_VO_TPU_FIELDS = {
    "TrackingState": (
        "pyramid*", "lk_cache.wins*", "lk_cache.origins*", "pts",
        "pts_valid", "prev3d", "prev3d_valid", "pose", "key", "health",
        "dipped"),
    "MatchingState": (
        "pts", "desc", "valid", "prev3d", "prev3d_valid", "pose", "key"),
    "ThreeFrameState": (
        "pts_a", "pts_b", "desc_b", "valid_b", "m_ab_idx", "m_ab_valid",
        "R_ab", "t_ab", "pose", "key", "n_frames"),
    "TrackingBAState": (
        "pyramid*", "lk_cache.wins*", "lk_cache.origins*", "pts",
        "pts_valid", "prev3d", "prev3d_valid", "pose", "window.poses",
        "window.obs", "window.valid", "window.count", "map_X", "map_ok",
        "frame_idx", "key", "dipped"),
}
_FROM_NUMPY = {
    "TrackingState": state_from_numpy,
    "MatchingState": matching_state_from_numpy,
    "ThreeFrameState": three_frame_state_from_numpy,
    "TrackingBAState": tracking_ba_state_from_numpy,
}


def _leaves(state, prefix: str = "") -> dict:
    """Each tensor or generator of a state under its dotted field name."""
    if isinstance(state, (torch.Tensor, torch.Generator)):
        return {prefix: state}
    if not isinstance(state, tuple):
        raise TypeError(f"{prefix or 'state'}: cannot checkpoint a "
                        f"{type(state).__name__}")
    names = getattr(state, "_fields", None) or range(len(state))
    out = {}
    for name, value in zip(names, state):
        out.update(_leaves(value, f"{prefix}.{name}" if prefix else str(name)))
    return out


def _rebuild(like, values: dict, prefix: str = ""):
    """`like`'s structure with each leaf taken from `values` by name."""
    if isinstance(like, (torch.Tensor, torch.Generator)):
        return values[prefix]
    names = getattr(like, "_fields", None) or range(len(like))
    items = [_rebuild(v, values, f"{prefix}.{n}" if prefix else str(n))
             for n, v in zip(names, like)]
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()  # no device sync: host-side offset
    t = leaf.detach().cpu()
    # npz has no bfloat16: widen losslessly, load_state casts back
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save_state(
    state,
    filename: str,
    frame_idx: int | None = None,
    extra_meta: dict | None = None,
) -> None:
    """Serialize a pipeline state to one .npz file, field by field.

    `extra_meta` (JSON-serializable) rides in the same atomic write as the
    frame cursor — anything that must stay consistent with the state
    (host-side counters, gate snapshots) belongs here, not in side files."""
    leaves = _leaves(state)
    meta = {
        "state_type": type(state).__name__,
        "fields": list(leaves),
        "frame_idx": frame_idx,
        "state_schema": STATE_SCHEMA,
        **(extra_meta or {}),
    }
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    tmp = filename + ".tmp.npz"  # savez keeps the name (.npz suffix)
    np.savez(tmp, __meta__=json.dumps(meta),
             **{k: _to_numpy(v) for k, v in leaves.items()})
    os.replace(tmp, filename)


def load_meta(filename: str) -> dict:
    """Read just the JSON metadata of a checkpoint (cursor, host counters)."""
    with np.load(filename, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


def load_state(state_like, filename: str):
    """Restore a checkpoint into the structure of `state_like` (a state of
    the same pipeline and configuration: fields and shapes must match),
    on its devices and in its dtypes. Returns (state, frame_idx)."""
    with np.load(filename, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        got_schema = meta.get("state_schema")
        if got_schema != STATE_SCHEMA:
            raise ValueError(
                f"checkpoint state_schema {got_schema!r}, expected "
                f"{STATE_SCHEMA!r}"
                + (" (written by vo_tpu: read it with "
                   "load_vo_tpu_checkpoint)" if "treedef" in meta else "")
            )
        like = _leaves(state_like)
        fields = meta["fields"]
        if set(fields) != set(like):
            raise ValueError(
                f"checkpoint has {len(fields)} leaves, expected {len(like)} "
                f"— config/pipeline mismatch (checkpoint "
                f"{meta['state_type']}, missing "
                f"{sorted(set(like) - set(fields))}, extra "
                f"{sorted(set(fields) - set(like))})"
            )
        values = {}
        for name, ref in like.items():
            a = z[name]
            if isinstance(ref, torch.Generator):
                gen = torch.Generator(device=ref.device)
                try:
                    gen.set_state(torch.from_numpy(a))
                except RuntimeError as e:
                    raise ValueError(
                        f"leaf {name}: generator state of {a.size} bytes "
                        f"does not fit a {ref.device.type} generator"
                    ) from e
                values[name] = gen
                continue
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {name} shape {a.shape} != expected "
                                 f"{tuple(ref.shape)}")
            values[name] = torch.from_numpy(a).to(ref.device, ref.dtype)
    return _rebuild(state_like, values), meta["frame_idx"]


def _state_type(pipeline) -> str:
    for cls, name in ((TrackingBAVO, "TrackingBAState"),
                      (TrackingVO, "TrackingState"),
                      (ThreeFrameVO, "ThreeFrameState"),
                      (MatchingVO, "MatchingState")):
        if isinstance(pipeline, cls):
            return name
    raise TypeError(f"no checkpointed state for {type(pipeline).__name__}")


def _namespace(flat: dict):
    """Nested attribute access over dotted names ("window.poses")."""
    root: dict = {}
    for name, v in flat.items():
        *parents, leaf = name.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v

    def wrap(node):
        return SimpleNamespace(**{k: wrap(v) if isinstance(v, dict) else v
                                  for k, v in node.items()})

    return wrap(root)


def load_vo_tpu_checkpoint(filename: str, pipeline, seed: int = 0):
    """The port's state for `pipeline` from a checkpoint that vo_tpu's
    `save_state` wrote (any of its four states). Returns (state,
    frame_idx). vo_tpu's PRNG key does not carry over: the state draws
    from a generator seeded with `seed`, as the converters do; its LK
    window stacks are dropped (the port keeps the origins only)."""
    kind = _state_type(pipeline)
    with np.load(filename, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if "treedef" not in meta:
            raise ValueError(f"{filename} was not written by vo_tpu")
        if meta.get("state_schema") != _VO_TPU_SCHEMA:
            raise ValueError(
                f"vo_tpu checkpoint state_schema {meta.get('state_schema')}, "
                f"expected {_VO_TPU_SCHEMA}")
        if kind not in meta["treedef"]:
            raise ValueError(f"checkpoint does not hold a {kind} "
                             f"(treedef {meta['treedef'][:80]}...)")
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    spec = _VO_TPU_FIELDS[kind]
    n_lev = pipeline.cfg.lk.max_level + 1
    expected = sum(n_lev if f.endswith("*") else 1 for f in spec)
    if len(leaves) != expected:
        raise ValueError(f"checkpoint has {len(leaves)} leaves, expected "
                         f"{expected} for a {kind} over {n_lev} LK levels")
    flat, it = {}, iter(leaves)
    for f in spec:
        if f.endswith("*"):
            flat[f[:-1]] = tuple(next(it) for _ in range(n_lev))
        else:
            flat[f] = next(it)
    state = _FROM_NUMPY[kind](_namespace(flat), device=pipeline.device,
                              seed=seed)
    if hasattr(state, "pyramid") and pipeline.cfg.lk.precision == "bf16":
        # vo_tpu widened its bf16 levels (1+) to f32 in the file: exact
        state = state._replace(pyramid=tuple(
            p if i == 0 else p.to(torch.bfloat16)
            for i, p in enumerate(state.pyramid)))
    return state, meta["frame_idx"]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class CheckpointingRunner:
    """run_vo / run_vo_ba-style host loop with periodic checkpoints and
    resume.

    Usage:
        runner = CheckpointingRunner(pipeline, "ckpt.npz", every=50)
        est, gt, scales, stats = runner.run(seq)   # resumes if ckpt exists

    Checkpointed: the device state, the frame cursor, the host-side
    pipeline counters (BA frame index / window fill / re-detect gate) and
    the per-frame logs so far (est path + scale pairs), so a resumed run
    reproduces an uninterrupted one: BA cadence, re-detects, and the
    window-pose est-path rewrites are all preserved. The host counters ride
    inside the state npz (one atomic write with the cursor); the paths side
    file is written first, so after a crash between the two writes it is at
    most one period longer than the cursor and is truncated to it on
    resume. A checkpoint that vo_tpu wrote resumes too
    (`load_vo_tpu_checkpoint`).

    Each step's pose is read back as the step ends (a device sync per
    step), as in vo_tpu's runner."""

    def __init__(self, pipeline, ckpt_file: str, every: int = 100):
        self.pipeline = pipeline
        self.ckpt_file = ckpt_file
        self.every = max(1, every)

    # -- host-side pipeline counters (TrackingBAVO / TrackingVO) ---------
    def _capture_host(self) -> dict:
        p, h = self.pipeline, {}
        for name in ("_frame_idx", "_win_fill"):
            if hasattr(p, name):
                h[name] = int(getattr(p, name))
        gate = getattr(p, "_gate", None)
        if gate is not None:
            # snapshot WITHOUT changing the live gate: pending entries are
            # waited for and read into the snapshot but stay in its inbox,
            # which consumes them on its own clock
            pending = []
            for idx, host, event in gate._inbox:
                if event is not None:
                    event.synchronize()
                pending.append([idx, host.reshape(-1).tolist()])
            h["gate"] = {
                "schema": GATE_SCHEMA,
                "step": gate._step,
                "last_trigger": gate._last_trigger,
                # a dip that arrived but has not fired yet: without it a
                # resume would drop a pending re-detect
                "pending_low": bool(gate._pending_low),
                "pending": pending,
            }
        return h

    def _restore_host(self, h: dict) -> None:
        p = self.pipeline
        for name in ("_frame_idx", "_win_fill"):
            if name in h and hasattr(p, name):
                setattr(p, name, int(h[name]))
        gate = getattr(p, "_gate", None)
        if gate is not None and "gate" in h:
            g = h["gate"]
            got = int(g.get("schema", 1))
            if got != GATE_SCHEMA:
                raise ValueError(
                    f"checkpoint gate schema {got} != expected "
                    f"{GATE_SCHEMA} — the re-detect gate's state layout "
                    "changed since this checkpoint was written; re-run "
                    "from scratch (old checkpoints are not migratable)"
                )
            inbox = []
            for idx, v in g.get("pending", []):
                if len(v) != 2:
                    raise ValueError(f"gate entry of step {idx} is {v}, not "
                                     f"a [dip latch, count] pair")
                # no event: the gate reads an entry without one at once
                inbox.append((int(idx), torch.tensor(v, dtype=torch.int32),
                              None))
            gate._inbox = inbox
            gate._step = int(g["step"])
            gate._last_trigger = int(g["last_trigger"])
            gate._pending_low = bool(g["pending_low"])

    def _resume(self, state):
        meta = load_meta(self.ckpt_file)
        if "treedef" in meta:
            return load_vo_tpu_checkpoint(self.ckpt_file, self.pipeline)
        return load_state(state, self.ckpt_file)

    def run(self, seq, verbose: bool = False):
        gt_poses = seq.poses
        start = 1
        state = self.pipeline.init(seq.frame(0))
        est_path = [_host(state.pose)[[0, 2], 3]]
        scales, stats = [(1.0, 1.0)], [{}]
        Wn = getattr(getattr(self.pipeline, "wcfg", None), "window_size", 0)

        side = self.ckpt_file + ".paths.npz"
        if os.path.exists(self.ckpt_file) and os.path.exists(side):
            state, cursor = self._resume(state)
            start = int(cursor)
            meta = load_meta(self.ckpt_file)
            # host counters live in the state npz (same atomic write as
            # the cursor), so they can never desync from the device state
            if "host" in meta:
                self._restore_host(meta["host"])
            with np.load(side, allow_pickle=False) as z:
                # truncate to the cursor: the side file may be one
                # checkpoint period newer than the state file
                est_path = [row for row in z["est"][:start]]
                scales = [tuple(row) for row in z["scales"][:start]]
            stats = [{}] + [{"resumed": True}] * (start - 1)
            if verbose:
                print(f"resumed at frame {start}")

        def _save(i, st):
            tmp = side + ".tmp.npz"
            np.savez(tmp, est=np.asarray(est_path), scales=np.asarray(scales))
            os.replace(tmp, side)
            save_state(
                st, self.ckpt_file, frame_idx=i + 1,
                extra_meta={"host": self._capture_host()},
            )

        gt_path = [gt_poses[0][[0, 2], 3]]
        for i in range(1, len(seq)):
            if i < start:
                gt_path.append(gt_poses[i][[0, 2], 3])
                continue
            state, out = self.pipeline.step(state, seq.frame(i))
            frame = getattr(out, "frame", out)
            est_path.append(_host(frame.pose)[[0, 2], 3])
            # BA window rewrite (with_bundle_adjustment.cpp:237-247), as
            # run_vo_ba does — a checkpointed BA run keeps its refinements.
            if Wn and bool(out.ba_ran):
                wp = _host(out.window_poses)
                for j in range(Wn):
                    est_path[i - Wn + 1 + j] = wp[j][[0, 2], 3]
            gt_path.append(gt_poses[i][[0, 2], 3])
            gt_s = float(
                np.linalg.norm(gt_poses[i][:3, 3] - gt_poses[i - 1][:3, 3])
            )
            est_s = float(frame.scale)
            scales.append((max(gt_s, 1e-9), max(est_s, 1e-9)))
            stats.append({"n_assoc": int(frame.n_assoc)})
            if i % self.every == 0:
                _save(i, state)
        return (
            np.asarray(est_path),
            np.asarray(gt_path),
            np.asarray(scales),
            stats,
        )
