"""What a run measures, found by name from `BENCHMARK.json`.

A cell names a configuration (the `file` that `BENCHMARK.json` gives it)
and a traffic mix (`traffic/<name>.json`); a per-layer metric is the
reader `metrics/<name>.py`. Nothing here knows a name: a new cell, mix,
configuration or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file, with its BENCHMARK.json entry
    traffic: dict  # the traffic file
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its files from the
    checkout at `root`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    centry = configs[w["config"]]
    config = json.loads((root / centry["file"]).read_text())
    config = {**config, "name": centry["name"]}
    traffic = json.loads(
        (root / HERE.name / "traffic" / f"{w['traffic']}.json").read_text())
    traffic = {**traffic, "name": w["traffic"]}
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, reported)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def load_metric(root: Path, name: str):
    """The module `metrics/<name>.py` of the checkout at `root`; its
    `read(run)` gives the number, or None where the run holds nothing to
    read."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"vobench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
