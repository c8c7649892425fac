"""Helpers of the benchmark's CPU tests: a cell's files cut to a size the
CPU runs in seconds, and a run driven in one process (the harness's look
for a card skipped)."""

from __future__ import annotations

import argparse
import copy
import json
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from vobench import run, spec
from vobench.worker import Stream, build_pipeline

REPO = Path(__file__).resolve().parents[2]
SHAPE = (120, 160)


def tiny_config(config: dict) -> dict:
    """The configuration at 120x160 with fewer features and a 24-frame
    bank; the camera keeps KITTI's field of view."""
    c = copy.deepcopy(config)
    H, W = SHAPE
    s = W / config["frame_shape"][1]
    cam = config["camera"]
    c["frame_shape"] = [H, W]
    c["camera"] = {"fx": cam["fx"] * s, "fy": cam["fy"] * s,
                   "cx": cam["cx"] * s, "cy": cam["cy"] * H / config["frame_shape"][0]}
    c["vo"]["orb"].update(nfeatures=300, n_levels=4)
    c["vo"]["sift"].update(nfeatures=300)
    c["bank_frames"] = 24
    return c


def tiny_traffic(traffic: dict, streams: int = 2) -> dict:
    t = copy.deepcopy(traffic)
    t["streams"] = streams
    t["chains"], t["chain_steps"] = 1, 3
    # the dim stretches at the same place in a 10x shorter bank
    t["dropouts"] = [[a // 10, b // 10 + 1] for a, b in t["dropouts"]]
    return t


def tiny_cell(name: str, root: Path = REPO) -> spec.Cell:
    cell = spec.load_cell(root, name)
    cell.config = tiny_config(cell.config)
    cell.traffic = tiny_traffic(cell.traffic)
    return cell


def copy_checkout(dst: Path) -> Path:
    """A checkout of BENCHMARK.json and vobench/ only, at dst."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "vobench", dst / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


class _Timed:
    """A pipeline whose steps' durations are kept."""

    def __init__(self, pipeline):
        self._p, self.step_s = pipeline, []

    def __getattr__(self, name):
        return getattr(self._p, name)

    def step(self, state, img):
        t = time.perf_counter()
        out = self._p.step(state, img)
        self.step_s.append(time.perf_counter() - t)
        return out


def run_in_process(cell: spec.Cell, seed: int, seconds: float = 2.0,
                   wrap=None, control: bool = False) -> dict:
    """A whole run of `cell` on the CPU, its streams in this process: the
    result line. `wrap(pipeline)` may put a broken pipeline in the
    program's place. Each stream's window lasts `seconds`, or longer where
    the warm-up's steps (their median) show that this CPU needs it for one
    more step than a checked chain has."""
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=0,
                              control=int(control), device="cpu")
    n = int(cell.traffic["streams"])
    streams, ready = [], []
    for s in range(n):
        sp = {"stream": s, "n_streams": n, "seed": seed,
              "config": cell.config, "traffic": cell.traffic}
        pipeline = build_pipeline(cell.config, torch.device("cpu"))
        if wrap is not None:
            pipeline = wrap(pipeline)
        pipeline = _Timed(pipeline)
        st = Stream(sp, torch.device("cpu"), pipeline)
        ready.append({"ready": st.setup()})
        streams.append(st)
        need = 2.0 * (int(cell.traffic["chain_steps"]) + 1) * float(
            np.median(pipeline.step_s))
        args.seconds = max(args.seconds, need)
    windows = []
    for st in streams:
        t0 = run.time.time_ns()
        windows.append({"window": st.window(t0, t0 + int(args.seconds * 1e9))})
    checks = [{"check": st.check(control), "forbidden": []} for st in streams]
    got = {"ready": ready, "setup_s": 1.0, "windows": windows,
           "checks": checks}
    return run.result_line(cell, args, got)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())
