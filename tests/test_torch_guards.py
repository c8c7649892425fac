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
    assert n >= 64  # every module of the package was imported
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
