"""The benchmark of vo_tpu_torch: one cell of BENCHMARK.json on one H100.

    python3 vobench/run.py --workload NAME --seed N --seconds S --trace 0|1
        [--control 1]

From the root of a checkout. The cell names a configuration and a traffic
mix; the run builds the program's kernels (once per checkout, into its
`vo_tpu_torch/_build/`), starts one worker per stream of the mix, each
rendering its drive on the card and warming every path its window takes
(`setup_s` ends when all are warm), then measures for `--seconds`: every
stream steps its drive as fast as the program goes. After the window each
worker checks a sample of its steps against the plain reference
(`vobench/reference/`), and the run prints, as its last line on standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones, read by
`vobench/metrics/<name>.py` from the profiler's CUDA activity) and
`device`, and last `check`, each compared number beside its limit.
`--control 1` also runs the control (the reference in lower precision in
the program's place) on the same chains, judges its numbers by the same
limits and prints them and its verdict, `control_correct`, which has to
come out false; the benchmark's own runs leave it off.

Without a CUDA card, or with fewer cards than the cell asks for, it prints
no result and exits with 2.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()  # before any import: the set-up's start

import argparse  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from vobench import compare, spec, trace  # noqa: E402
from vobench.link import Link  # noqa: E402

CACHE = ROOT / ".vobench_cache"  # fixed: every run of a checkout finds it
GO_MARGIN_S = 1.0  # between the last "ready" and the window's start
DEADLINE_S = 330.0  # a run that has not ended by then (after any build) fails


@dataclasses.dataclass
class RunData:
    """What the per-layer readers read (`vobench/metrics/<name>.py`)."""

    traced: bool
    frames: int  # completed in the window, all streams
    fallback_frames: int | None  # of them re-detected; None without a gate
    window_s: float
    busy_s: float = 0.0
    launches: int = 0
    kernel_time: dict = dataclasses.field(default_factory=dict)
    # the work of the calls of the entry points that the metric being read
    # names (its `ENTRIES`): [(bytes, operations)]
    work: list = dataclasses.field(default_factory=list)


def _log(msg: str) -> None:
    print(f"[vobench] {msg}", file=sys.stderr, flush=True)


def worker_env() -> dict:
    """The workers' environment: one CPU thread each, the program's caches
    inside the checkout, no JAX pulled in by a library."""
    env = dict(os.environ)
    env.update({
        "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
        "OPENBLAS_NUM_THREADS": "1", "USE_FLAX": "0", "USE_JAX": "0",
        "TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
        "TRITON_CACHE_DIR": str(CACHE / "triton"),
        "PYTHONDONTWRITEBYTECODE": "1",
    })
    return env


def card_info() -> dict:
    """The card's name and power limit from nvidia-smi (read only)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {"nvidia_smi": "not read"}
    return {"nvidia_smi": out[0] if out else "not read"}


def build_kernels() -> tuple[float, dict]:
    """Build every hand-written kernel of the program that is missing or
    stale, through the program's own build (into vo_tpu_torch/_build/)."""
    from vo_tpu_torch import _build

    names = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    t = time.perf_counter()
    logs = _build.build(names)
    return time.perf_counter() - t, logs


class Workers:
    """The cell's streams, one process each, and their pipes."""

    def __init__(self, cell: spec.Cell, args, device: str = "cuda"):
        n = int(cell.traffic["streams"])
        self.procs, self.links = [], []
        for s in range(n):
            p = subprocess.Popen(
                [sys.executable, str(ROOT / "vobench" / "worker.py")],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                env=worker_env(), cwd=str(ROOT))
            self.procs.append(p)
            self.links.append(Link(p.stdout, p.stdin))
            line = {"stream": s, "n_streams": n, "seed": args.seed,
                    "config": cell.config, "traffic": cell.traffic,
                    "trace": bool(args.trace), "control": bool(args.control),
                    "metrics": [m["name"] for m in cell.per_layer],
                    "device": device}
            p.stdin.write(json.dumps(line).encode() + b"\n")
            p.stdin.flush()

    def gather(self, key: str) -> list:
        out = []
        for link in self.links:
            msg = link.recv()
            if key not in msg:
                raise RuntimeError(f"a worker sent {sorted(msg)}, not {key!r}")
            out.append(msg)
        return out

    def tell(self, msg: dict) -> None:
        for link in self.links:
            link.send(msg)

    def close(self, timeout: float = 60.0) -> list[int]:
        codes = []
        for p in self.procs:
            for f in (p.stdin, p.stdout):
                try:
                    f.close()
                except OSError:
                    pass
            try:
                codes.append(p.wait(timeout=timeout))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        return codes

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()


def _gap_label(spans_by_worker: list, mid_ns: int) -> str:
    """What the streams' hosts were doing at a moment: the kind of step
    each was dispatching, or "between steps"."""
    kinds = collections.Counter()
    for spans in spans_by_worker:
        kind = "between steps"
        for s, e, k in spans:
            if s <= mid_ns < e:
                kind = f"in {k} step"
                break
        kinds[kind] += 1
    return "hosts " + ", ".join(f"{n} {k}" for k, n in sorted(kinds.items()))


def aggregate_trace(windows: list, data: RunData) -> tuple[dict, dict, dict]:
    """The per-layer run data, the breakdown and each metric's work from
    the workers' traces."""
    traces = [w["window"]["trace"] for w in windows]
    window_ns = traces[0]["window_ns"]
    sets = [w.get("arrays", {}).get("intervals", np.zeros((0, 2), np.int64))
            for w in windows]
    busy, gaps = trace.busy_and_gaps(sets, window_ns)
    by_name: dict = collections.defaultdict(float)
    work: dict = collections.defaultdict(list)
    for t in traces:
        for name, (sec, _n) in t["by_name"].items():
            by_name[name] += sec
        for metric, calls in t["work"].items():
            work[metric].extend(map(tuple, calls))
    data.busy_s = busy
    data.launches = sum(t["launches"] for t in traces)
    data.kernel_time = dict(by_name)
    spans = [w["window"]["spans"] for w in windows]
    longest = gaps[np.argsort(gaps[:, 1] - gaps[:, 0])[::-1][:10]]
    breakdown = {
        "device_ops": [[n[:160], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[_gap_label(spans, int((a + b) // 2)), (b - a) / 1e9]
                      for a, b in longest],
    }
    for i, t in enumerate(traces):
        _log(f"stream {i} trace: {t['launches']} launches, clock check "
             f"{t['clock_check']}")
    return {"busy_s": busy, "window_s": window_ns / 1e9}, breakdown, work


def measure(cell: spec.Cell, args, device: str = "cuda",
            deadline_s: float = DEADLINE_S) -> dict:
    """Run the cell's streams through set-up, window and check; the
    parts of the result line, before it is printed. Workers still running
    `deadline_s` after the start are killed, and the run fails."""
    workers = Workers(cell, args, device)
    timer = threading.Timer(deadline_s, workers.kill)
    timer.daemon = True
    timer.start()
    try:
        ready = workers.gather("ready")
        setup_s = time.time() - T_PROCESS
        for i, r in enumerate(ready):
            _log(f"stream {i} ready: {r['ready']}")
        t0 = time.time_ns() + int(GO_MARGIN_S * 1e9)
        t_end = t0 + int(args.seconds * 1e9)
        workers.tell({"t0": t0, "t_end": t_end})
        windows = workers.gather("window")
        workers.tell({"check": True})
        checks = workers.gather("check")
    finally:
        timer.cancel()
        codes = workers.close()
    if any(codes):
        raise RuntimeError(f"worker exit codes {codes}")
    return {"ready": ready, "setup_s": setup_s, "windows": windows,
            "checks": checks}


def result_line(cell: spec.Cell, args, got: dict, root: Path = ROOT) -> dict:
    windows = [w["window"] for w in got["windows"]]
    completed = sum(w["completed"] for w in windows)
    attempted = sum(w["steps"] for w in windows)
    lat = [x for w in windows for x in w["latency_ms"]]
    items = [i for c in got["checks"] for i in c["check"]["program"]]
    numbers = compare.summarize(items)
    correct, rows = compare.judge(numbers, cell.config["limits"])
    forbidden = sorted({m for c in got["checks"] for m in c["forbidden"]})
    if forbidden:
        raise RuntimeError(f"a worker loaded {forbidden}")
    device = {"platform": "gpu" if args.device == "cuda" else args.device,
              "kind": got["ready"][0]["ready"]["device"], "count": 1,
              "memory_peak_bytes": sum(w["memory_peak_bytes"]
                                       for w in windows)}
    line = {"correct": correct, "attempted": attempted,
            "failed": attempted - sum(len(w["latency_ms"]) for w in windows)}
    if args.trace:
        gated = all(w["gated"] for w in windows)
        data = RunData(
            traced=True, frames=completed,
            fallback_frames=sum(w["fallback_completed"] for w in windows)
            if gated else None,
            window_s=args.seconds)
        dev, breakdown, work = aggregate_trace(got["windows"], data) \
            if windows[0]["trace"] is not None else ({}, None, {})
        data.window_s = dev.get("window_s", args.seconds)
        metrics = {}
        for m in cell.per_layer:
            v = spec.load_metric(root, m["name"]).read(
                dataclasses.replace(data, work=work.get(m["name"], [])))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(dev)
        line.update({"metrics": metrics, "device": device})
        if breakdown is not None:
            line["breakdown"] = breakdown
    else:
        values = {
            "fps": completed / args.seconds,
            "frame_latency_p95_ms": float(np.percentile(lat, 95))
            if lat else float("nan"),
            "setup_s": got["setup_s"],
        }
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        line.update({"metrics": {k: {"value": values[k], "unit": units[k]}
                                 for k in units},
                     "device": device})
    if args.control:  # the control in the program's place, judged alike
        ctrl = compare.summarize(
            [i for c in got["checks"] for i in c["check"]["control"]])
        line["control"] = ctrl
        line["control_correct"], _ = compare.judge(ctrl,
                                                    cell.config["limits"])
    line["readings"] = numbers  # every number, compared or not
    line["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args(argv)
    args.device = "cuda"
    cell = spec.load_cell(ROOT, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _log(f"needs {cell.chips} CUDA card(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             ": no result")
        return 2
    os.environ.update({k: v for k, v in worker_env().items()
                       if k.endswith("_DIR")})
    build_s, logs = build_kernels()
    _log(f"kernels built in {build_s:.1f} s ({sorted(logs) or 'all cached'})")
    _log(f"card: {card_info()}")
    got = measure(cell, args, deadline_s=DEADLINE_S + build_s)
    line = result_line(cell, args, got)
    line["build_s"] = build_s
    line["check"] = line.pop("check")  # the compared numbers come last
    banned = {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax",
                                                        "vo_tpu"}
    if banned:
        _log(f"loaded {sorted(banned)}: no result")
        return 3
    if args.control:  # the readings that the limits are set from
        for i, c in enumerate(got["checks"]):
            for side in ("program", "control"):
                _log(f"stream {i} {side} items: " + "; ".join(
                    f"{it['kind']} k={it['k']} off={it['off']}/"
                    f"{it['compared']} err={it['err'] / max(1, it['both']):.3g}"
                    + (f" assoc={it['assoc']}/{it['ref_assoc']} "
                       f"rot={it['rot']:.3g} trans={it['trans']:.3g}"
                       if "rot" in it else "")
                    for it in c["check"][side]))
    _log("check took " + ", ".join(f"{c['check_s']:.1f}" for c in
                                   got["checks"]) + " s a stream")
    for k, v in line.get("control", {}).items():
        _log(f"control {k} {v}")
    if args.control:
        _log(f"control_correct {line['control_correct']} (the control has "
             "to come out not correct)")
    for k, v in line["readings"].items():
        _log(f"reading {k} {v}")
    for k, v in line["check"].items():
        _log(f"check {k} {v}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
