"""Rules the port keeps: it imports neither jax nor vo_tpu, and its entry
points run on cuda unless told otherwise, raising when there is no card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import vo_tpu_torch
from vo_tpu_torch.models.vo import MatchingVO, TrackingVO
from vo_tpu_torch.models.vo_3frame import ThreeFrameVO
from vo_tpu_torch.models.vo_ba import TrackingBAVO
from vo_tpu_torch.runtime.presets import PRESETS, get_preset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises
pkg = importlib.import_module(sys.argv[1])
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "vo_tpu" or m.startswith("vo_tpu."))
print(len(names), bad)
"""


def _import_all(package: str) -> tuple[int, str]:
    """(modules under `package`, vo_tpu modules loaded) from importing
    every module of `package` and chip_smoke where jax cannot load."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE, package], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    return int(n), bad


def test_port_imports_no_jax_and_no_vo_tpu():
    n, bad = _import_all("vo_tpu_torch")
    assert n >= 65  # every module of the package (models/vo_scan.py too)
    assert bad == "[]"


def test_parallel_imports_no_jax_and_no_vo_tpu():
    n, bad = _import_all("vo_tpu_torch.parallel")
    assert n == 11  # vo_tpu/parallel's nine modules, dryrun and launch
    assert bad == "[]"


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    K = np.array([[288.0, 0, 160], [0, 288.0, 120], [0, 0, 1]])
    with pytest.raises(RuntimeError, match="CUDA"):
        vo_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TrackingVO(K)
    for name in PRESETS:
        with pytest.raises(RuntimeError, match="CUDA"):
            get_preset(name).build(K)
    for cls in (TrackingVO, MatchingVO, ThreeFrameVO, TrackingBAVO):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(K)
        assert cls(K, device="cpu").device.type == "cpu"
    from vo_tpu_torch.parallel import make_mesh, make_mesh_2d
    from vo_tpu_torch.parallel.scaling import main as scaling_main

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh_2d((1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        scaling_main([])


def _never_called(rank, world):
    raise AssertionError("a rank started without a card")


@pytest.mark.parametrize("entry", ["spawn", "dryrun_multichip",
                                   "measure_detect_scaling",
                                   "measure_step_scaling"])
def test_parallel_launchers_default_to_the_card(monkeypatch, entry):
    """parallel/'s process launchers run NCCL ranks on the cards unless
    told device="cpu", and raise before starting a rank without a card."""
    from vo_tpu_torch.parallel import dryrun, launch, scaling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"spawn": lambda: launch.spawn(_never_called, 1),
            "dryrun_multichip": lambda: dryrun.dryrun_multichip(1),
            "measure_detect_scaling":
                lambda: scaling.measure_detect_scaling([1]),
            "measure_step_scaling":
                lambda: scaling.measure_step_scaling([1])}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_cli_default_device_raises_without_a_card(monkeypatch, tmp_path):
    from vo_tpu_torch.runtime import cli, compare

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--synthetic", "4", "--out", str(tmp_path)])
    assert not (tmp_path / "tracking_orb").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        compare.run_compare(None, None, False)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


_EVAL_PROBE = r"""
import runpy, sys
sys.modules["jax"] = None  # any import of jax now raises
ev = runpy.run_path("scripts/eval_torch_synthetic.py", run_name="probe")
seq = ev["make_sequence"]("hard", 12, 0)
ev["main"](["--report-only", "--out", sys.argv[1], "--doc", sys.argv[2]])
import vo_tpu_torch.runtime.presets, vo_tpu_torch.utils.io
bad = sorted(m for m in sys.modules
             if m == "vo_tpu" or m.startswith("vo_tpu."))
print(bad)
"""


def test_eval_script_imports_no_jax_and_no_vo_tpu(tmp_path):
    """scripts/eval_torch_synthetic.py, its document writer included, runs
    where jax cannot load and loads no vo_tpu module; no import line of it
    names either."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _EVAL_PROBE, "results_tpu",
         str(tmp_path / "doc.md")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
    assert "## Held against vo_tpu" in (tmp_path / "doc.md").read_text()
    with open(os.path.join(REPO, "scripts", "eval_torch_synthetic.py")) as f:
        imports = [ln.split() for ln in f if ln.lstrip().startswith(
            ("import ", "from "))]
    assert imports and all(
        w[1].split(".")[0] not in ("jax", "vo_tpu") for w in imports)


def test_eval_script_default_device_raises_without_a_card(monkeypatch,
                                                          tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "eval_torch_synthetic",
        os.path.join(REPO, "scripts", "eval_torch_synthetic.py"))
    ev = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ev)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ev.main(["--frames", "4", "--seeds", "0", "--presets",
                 "tracking_orb", "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
