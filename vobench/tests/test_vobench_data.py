"""The harness is driven by data: a new configuration, traffic mix,
per-layer metric and cell are new files and entries, found by name with
no edit to any file that is there; and the harness refuses to measure
without a card."""

import hashlib
import json
import subprocess
import sys

import numpy as np
import torch
import vobench_tiny as tiny

from vo_tpu_torch.ops import blur_cuda
from vobench import run, spec
from vobench.metrics import work
from vobench.worker import EntryCalls


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "vobench").rglob("*") if p.is_file()}


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    root = tiny.copy_checkout(tmp_path / "checkout")
    before = _digests(root)
    cfg = json.loads((root / "vobench/configs/tracking_orb.json").read_text())
    cfg["vo"]["orb"]["fast_threshold"] = 25.0
    (root / "vobench/configs/tracking_orb_ft25.json").write_text(
        json.dumps(cfg))
    mix = json.loads((root / "vobench/traffic/drive.x6.json").read_text())
    mix.update(streams=4, speed=1.5)
    (root / "vobench/traffic/fast.x4.json").write_text(json.dumps(mix))
    (root / "vobench/metrics/frames_per_stream.py").write_text(
        "def read(run):\n    return run.frames / 4 if run.frames else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tracking_orb_ft25", "source": "https://example.org/x",
        "file": "vobench/configs/tracking_orb_ft25.json",
        "reduced": ["frames", "bank_frames"], "why": "a test"})
    bench["workloads"].append({
        "name": "tracking_orb_ft25.fast.x4", "config": "tracking_orb_ft25",
        "traffic": "fast.x4", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "frames_per_stream", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "host loop", "moves": "fps",
        "workloads": ["tracking_orb_ft25.fast.x4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell(root, "tracking_orb_ft25.fast.x4")
    assert cell.config["vo"]["orb"]["fast_threshold"] == 25.0
    assert cell.traffic["streams"] == 4 and cell.traffic["speed"] == 1.5
    assert [m["name"] for m in cell.end_to_end] == [
        "fps", "frame_latency_p95_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["frames_per_stream"]
    reader = spec.load_metric(root, "frames_per_stream")
    data = run.RunData(traced=True, frames=8, fallback_frames=0, window_s=1.0)
    assert reader.read(data) == 2.0
    # an old cell does not pick up the new metric
    old = spec.load_cell(root, "matching_sift.drive.x6")
    assert "frames_per_stream" not in [m["name"] for m in old.per_layer]
    # and the new cell runs through the harness as it stands
    small = tiny.tiny_cell("tracking_orb_ft25.fast.x4", root)
    small.config["limits"] = {k: 1e9 for k in run.compare.NUMBERS}
    line = tiny.run_in_process(small, seed=5, seconds=1.0)
    assert line["correct"] and line["attempted"] > 0
    # no file that was there changed
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_readers_leave_out_what_they_cannot_read():
    data = run.RunData(traced=False, frames=0, fallback_frames=None,
                       window_s=0.0)
    for m in json.loads((tiny.REPO / "BENCHMARK.json").read_text())[
            "per_layer"]:
        assert spec.load_metric(tiny.REPO, m["name"]).read(data) is None


def _refusal(cwd):
    return subprocess.run(
        [sys.executable, "vobench/run.py", "--workload",
         "tracking_orb.drive.x6", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_result_without_a_card():
    out = _refusal(tiny.REPO)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    root = tiny.copy_checkout(tmp_path / "bare")
    out = _refusal(root)
    assert out.returncode != 0 and out.stdout == ""


def test_a_metric_file_names_the_entry_points_it_counts(tmp_path):
    # a new metric declares the program's entry points whose calls it
    # counts; the worker wraps what the cell's metrics name, and nothing
    # of the worker names a kernel
    root = tiny.copy_checkout(tmp_path / "checkout")
    (root / "vobench/metrics/blur_calls.py").write_text(
        "from vobench.metrics import work\n"
        "ENTRIES = {'vo_tpu_torch.ops.blur_cuda.separable_blur': "
        "work.b2_call}\n"
        "def read(run):\n    return len(run.work) or None\n")
    calls = EntryCalls({"blur_calls": spec.load_metric(root, "blur_calls")})
    orig = blur_cuda.separable_blur
    calls.install()
    t0 = run.time.time_ns()
    blur_cuda.separable_blur(torch.ones(2, 16, 24), np.ones(3) / 3,
                             np.ones(5) / 5)
    calls.uninstall()
    assert blur_cuda.separable_blur is orig
    got = calls.work(t0, run.time.time_ns() + 1)
    assert got == {"blur_calls": [work.b2_work(2 * 16 * 24, 3, 5)]}
