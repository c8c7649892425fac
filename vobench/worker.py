"""One stream of a cell: a recorded drive replayed through the program as
fast as it goes (a closed loop), on its own process.

`python3 vobench/worker.py` reads its stream's description as one JSON
line on standard input and talks to `run.py` over its pipes
(`vobench/link.py`): "ready" once its frames are on the device and every
path its window takes is warm, then, after "go", the window's records,
then the check of its sampled steps against the plain reference. The
program is driven only through the entry points that users call:
`get_preset(name).build(K)`, `init(frame, seed)` and `step(state, frame)`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script: the checkout is the root
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vobench import check, frames, trace  # noqa: E402
from vobench.link import Link  # noqa: E402
from vobench.reference.step import override  # noqa: E402
from vobench.spec import load_metric  # noqa: E402

def build_pipeline(config: dict, device):
    """The program's pipeline as users build it: the preset, set to every
    number of the configuration file."""
    from vo_tpu_torch.runtime.presets import get_preset

    preset = get_preset(config["preset"])
    preset = dataclasses.replace(preset,
                                 config=override(preset.config, config["vo"]))
    return preset.build(frames.intrinsics(config["camera"]), device=device)


def light(state, with_gen: bool = True) -> dict:
    """References to the small tensors of a pipeline state that the check
    needs (no copy, nothing waits), and its RANSAC generator's state."""
    d = {"pts": state.pts, "pose": state.pose, "prev3d": state.prev3d,
         "prev3d_valid": state.prev3d_valid,
         "valid": state.pts_valid if hasattr(state, "pts_valid")
         else state.valid}
    if hasattr(state, "lk_cache"):
        d["origins"] = tuple(state.lk_cache.origins)
    if hasattr(state, "desc"):
        d["desc"] = state.desc
    if with_gen:
        d["gen"] = state.gen.get_state()
    return d


class EntryCalls:
    """While installed, records each call of the program's entry points
    that the cell's per-layer metrics name (`ENTRIES` of
    `vobench/metrics/<name>.py`: entry point -> the function that turns a
    call's arguments into a function of its work), with the host time of
    the call. The work is worked out after the window."""

    def __init__(self, metrics: dict):
        self.metrics = metrics  # name -> module
        self.calls: list = []  # (t_ns, metric, work function)
        self._saved: list = []

    def install(self):
        for name, mod in self.metrics.items():
            for entry, count in getattr(mod, "ENTRIES", {}).items():
                mod_name, fn_name = entry.rsplit(".", 1)
                target = importlib.import_module(mod_name)
                orig = getattr(target, fn_name)
                self._saved.append((target, fn_name, orig))
                setattr(target, fn_name, self._wrap(orig, name, count))

    def uninstall(self):
        for target, fn_name, orig in reversed(self._saved):
            setattr(target, fn_name, orig)
        self._saved.clear()

    def _wrap(self, orig, name, count):
        calls = self.calls

        def wrapper(*a, **kw):
            calls.append((time.time_ns(), name, count(a)))
            return orig(*a, **kw)

        return wrapper

    def work(self, t0: int, t1: int) -> dict:
        """metric -> [(bytes, operations)] of the calls made in [t0, t1)."""
        out: dict = {name: [] for name in self.metrics}
        for t, name, work in self.calls:
            if t0 <= t < t1:
                out[name].append(work())
        return out


@dataclasses.dataclass
class Rec:
    """One step of the window: its host start and return, the event that
    marks its end on the device, the state it started from and its output."""

    k: int
    t_start: int
    t_return: int
    end: object
    pre: dict
    out: object
    post: dict | None = None


class Stream:
    """One stream: its drive, its frames on `device`, the program's
    pipeline, the window's loop and the check."""

    def __init__(self, spec: dict, device: torch.device, pipeline=None):
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.device = device
        self.seed = int(spec["seed"])
        self.index = int(spec["stream"])
        self.n = int(self.config["bank_frames"])
        self.offset = frames.stream_offset(self.index, int(spec["n_streams"]),
                                           self.n)
        self.K = frames.intrinsics(self.config["camera"])
        self.shape = tuple(self.config["frame_shape"])
        self.pipeline = pipeline
        self.calls = None
        if spec.get("trace"):
            root = Path(__file__).resolve().parents[1]
            self.calls = EntryCalls({m: load_metric(root, m)
                                     for m in spec.get("metrics", ())})
        self.recs: list[Rec] = []

    # ------------------------------------------------------------- set-up
    def ransac_seed(self) -> int:
        return frames.stream_seed(self.seed, 1000 + self.index)

    def frame(self, k: int) -> torch.Tensor:
        return self.bank[frames.bank_index(self.offset + k, self.n)]

    def setup(self) -> dict:
        t = time.perf_counter()
        drive = frames.Drive(self.traffic, self.n,
                             frames.stream_seed(self.seed, self.index))
        self.bank = frames.render_bank(drive, self.K, self.shape, self.device)
        t_render = time.perf_counter() - t
        if self.pipeline is None:
            self.pipeline = build_pipeline(self.config, self.device)
        warm_redetects = self._warm_up()
        self.state0 = self.pipeline.init(self.frame(0), seed=self.ransac_seed())
        _sync(self.device)
        if self.calls is not None:
            self.calls.install()
            trace.start(self.device)
        return {"render_s": t_render, "setup_s": time.perf_counter() - t,
                "warm_redetects": warm_redetects,
                "device": _device_name(self.device)}

    def _warm_up(self):
        """Every path of the window, through the entry points: track and
        pose steps and, for a gated pipeline, a re-detect (a blank frame
        drops every track, the gate answers, the next step re-detects)."""
        p = self.pipeline
        state = p.init(self.frame(0), seed=self.ransac_seed())
        # a tracking pipeline's state carries its LK windows
        self.tracking = "lk_cache" in state._fields
        outs = []
        for k in (1, 2):
            state, out = p.step(state, self.frame(k))
            outs.append(out)
        if self.tracking:
            blank = torch.full(self.shape, frames.BACKGROUND,
                               dtype=torch.float32, device=self.device)
            state, _ = p.step(state, blank)
            _sync(self.device)
            for k in (3, 4, 5):
                state, out = p.step(state, self.frame(k))
                outs.append(out)
        _sync(self.device)
        return sum(bool(o.fallback) for o in outs)

    # ------------------------------------------------------------- window
    def window(self, t0: int, t_end: int) -> dict:
        """Steps from t0 until t_end (time.time_ns()); the frames, their
        latencies and, in a traced run, the trace's reduction."""
        while time.time_ns() < t0:
            time.sleep(min(0.001, max(0.0, (t0 - time.time_ns()) / 1e9)))
        cuda = self.device.type == "cuda"
        h0 = time.time_ns()
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            e0.synchronize()
            h0 = time.time_ns()
        state, p, k = self.state0, self.pipeline, 0
        recs = self.recs
        while True:
            t = time.time_ns()
            if t >= t_end:
                break
            k += 1
            pre = light(state)
            if recs:
                recs[-1].post = pre
            state, out = p.step(state, self.frame(k))
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            else:  # a CPU step has finished when it returns
                end = time.time_ns()
            recs.append(Rec(k, t, time.time_ns(), end, pre, out))
        _sync(self.device)
        if recs:
            recs[-1].post = light(state, with_gen=False)
        reduced = None
        if self.calls is not None:
            reduced = trace.stop(t0, t_end)
            self.calls.uninstall()
            reduced["work"] = self.calls.work(t0, t_end)
        done = [(h0 + round(e0.elapsed_time(r.end) * 1e6)) if cuda
                else r.end for r in recs]
        fallback = [bool(r.out.fallback) for r in recs]
        peak = (torch.cuda.max_memory_reserved(self.device) if cuda else 0)
        self.state0 = None
        del state
        return {
            "steps": len(recs),
            "completed": sum(1 for d in done if d <= t_end),
            "fallback_completed": sum(1 for d, f in zip(done, fallback)
                                      if d <= t_end and f),
            "latency_ms": [(d - r.t_start) / 1e6 for d, r in zip(done, recs)],
            "spans": [[r.t_start - t0, r.t_return - t0, self._kind(r)]
                      for r in recs],
            "gated": self.tracking,
            "memory_peak_bytes": int(peak),
            "trace": reduced,
        }

    # ------------------------------------------------------------- check
    def check(self, control: bool = False) -> dict:
        """The start and the sampled chains against the plain reference;
        with `control`, also the reference in lower precision put in the
        program's place (`vobench/check.py`)."""
        if not self.recs:
            return {"program": []}
        chains = [[self._step(r, i == 0) for i, r in enumerate(ch)]
                  for ch in self.chains()]
        return check.run_check(self.config, self.device, self.frame,
                               self.recs[0].pre, chains, control)

    def _kind(self, rec: Rec) -> str:
        if bool(rec.out.fallback):
            return "refresh"
        return "track" if self.tracking else "match"

    def _step(self, rec: Rec, first: bool) -> dict:
        """The program's step as `vobench/check.py` reads it."""
        d = {"kind": self._kind(rec), "k": rec.k, "pts": rec.post["pts"],
             "valid": rec.post["valid"], "desc": rec.post.get("desc"),
             "before": rec.pre["pose"], "pose": rec.out.pose,
             "cloud_before": (rec.pre["prev3d"], rec.pre["prev3d_valid"]),
             "cloud": (rec.post["prev3d"], rec.post["prev3d_valid"]),
             "assoc": rec.out.n_assoc}
        if first:
            d["pre"] = rec.pre
            if "desc" in rec.pre:
                d["prev_feats"] = (rec.pre["pts"], rec.pre["desc"],
                                   rec.pre["valid"])
        return d

    def chains(self) -> list[list[Rec]]:
        """The checked chains, drawn from the seed: `chains` runs of
        `chain_steps` consecutive steps that do not overlap, up to half of
        them starting at a step that re-detected, the rest anywhere."""
        rng = np.random.default_rng([self.seed % 2**63, self.index, 7])
        recs = self.recs
        n = int(self.traffic["chains"])
        L = min(int(self.traffic["chain_steps"]), len(recs))
        starts = range(len(recs) - L + 1)
        heavy = [i for i in starts if bool(recs[i].out.fallback)]
        other = [i for i in starts if not bool(recs[i].out.fallback)]
        picked: list[int] = []
        for pool, want in ((heavy, n // 2), (other, n)):
            for i in rng.permutation(pool):
                if len(picked) >= want:
                    break
                if all(abs(int(i) - j) >= L for j in picked):
                    picked.append(int(i))
        return [recs[i:i + L] for i in sorted(picked)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that a run may not load (JAX and
    the JAX package), compared whole."""
    banned = {"jax", "jaxlib", "flax", "vo_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)


def main() -> int:
    link = Link.worker()
    spec = json.loads(sys.stdin.readline())
    torch.set_num_threads(1)
    device = torch.device(spec.get("device", "cuda"))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    stream = Stream(spec, device)
    link.send({"ready": stream.setup()})
    msg = link.recv()
    result = stream.window(int(msg["t0"]), int(msg["t_end"]))
    blobs = trace.pop_blobs(result)
    link.send({"window": result}, blobs)
    link.recv()  # "check": the window has closed on every stream
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checked = stream.check(bool(spec.get("control")))
    link.send({"check": checked, "check_s": time.perf_counter() - t,
               "forbidden": forbidden_modules()})
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
