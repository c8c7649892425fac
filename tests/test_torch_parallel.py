"""The parallel port (vo_tpu_torch/parallel/) on the CPU with gloo.

Every sharded path runs in spawned ranks (`parallel.dryrun.rank_cases`):
at world 2 and 4 on 1-D meshes and on a 2x2 ("frame", "kp") mesh, one
job per mesh for the whole module, each case held to the port's dense
counterpart: bit for bit, except the BA solves (landmark sums associated
in another order, vo_tpu's bounds of tests/test_parallel.py). Against
vo_tpu itself: `binomial_blur5`, and sharded LK against vo_tpu's dense
lanes tracker with per-point termination (exit_mult = N + 1). The ranks
run the package's own code and cannot import jax (`parallel/launch.py`).
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_parity import low_cpu_priority  # noqa: F401 (fixture)
from vo_tpu.ops import lk as jlk
from vo_tpu.ops.conv import binomial_blur5 as jax_blur
from vo_tpu_torch.ops.conv import binomial_blur5
from vo_tpu_torch.ops.fast import fast_score
from vo_tpu_torch.parallel import (
    StepWatchdog,
    make_mesh,
    pad_to_multiple,
    sharded_fast_score,
    sharded_gaussian_blur,
)
from vo_tpu_torch.parallel import scaling
from vo_tpu_torch.parallel.dryrun import (
    check_case,
    dryrun_multichip,
    lk_config,
    lk_inputs,
)
from vo_tpu_torch.parallel.mesh import init_process_group

pytestmark = pytest.mark.usefixtures("low_cpu_priority")

CASES = ["lk", "match_hamming", "match_l2", "blur", "fast", "fast_thin",
         "batched_orb", "batched_pair_match", "bundle_adjust", "window_ba",
         "window_ba_map", "tracking_step", "parity", "redetect"]
MESHES = ["world2", "world4", "mesh2x2"]


@pytest.fixture(scope="module")
def world2():
    return dryrun_multichip(2, device="cpu", check=False,
                            timeout_s=240)


@pytest.fixture(scope="module")
def world4():
    return dryrun_multichip(4, device="cpu", timeout_s=240)


@pytest.fixture(scope="module")
def mesh2x2():
    return dryrun_multichip(4, mesh_shape=(2, 2), device="cpu",
                            check=False, timeout_s=240)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_equals_dense(mesh, case, request):
    check_case(case, request.getfixturevalue(mesh)[case])


def test_dryrun_multichip_4(world4):
    """dryrun_multichip(4, device="cpu") checked every case itself (the
    fixture)."""
    assert sorted(world4) == sorted(CASES)


@pytest.mark.parametrize("mesh", MESHES)
def test_cases_are_not_vacuous(mesh, request):
    res = request.getfixturevalue(mesh)
    lk = res["lk"]["dense"]["status"]
    assert 0 < lk.sum() < len(lk)
    assert res["match_hamming"]["dense"]["valid"].sum() > 0
    assert res["match_l2"]["dense"]["valid"].sum() > 0
    fast = res["fast_thin"]["dense"]["out"]
    assert (fast[3:-3] > 0).any()
    assert not fast[:3].any() and not fast[-3:].any()  # the global border
    assert res["batched_pair_match"]["dense"]["valid"].sum() > 0
    for name in ("window_ba", "window_ba_map"):
        d = res[name]["dense"]
        assert d["ba_ran"] and d["ba_landmarks"] > 10 and d["ba_holdout_n"] > 0
    step = res["tracking_step"]["sharded"]
    assert (step["n_assoc"] > 300).all() and not step["fallback"].any()
    assert (step["n_inliers"] > 100).all()
    assert step["rank_dev"] == 0.0  # one pose on every rank
    assert res["parity"]["sharded"]["exact"]
    # the blank frame's dip re-detects on step 3 on every rank, through the
    # sync gate whatever the config asked for
    redetect = res["redetect"]["sharded"]
    assert redetect["fallback"].tolist() == [False, False, True]
    assert redetect["gate_sync"]


def test_four_ranks_pad_the_step(world4):
    """Capacity 498 pads to 500 over four ranks; the pad stays invalid."""
    d = world4["tracking_step"]["dense"]
    assert d["pts"].shape == (500, 2) and not d["pts_valid"][498:].any()


def test_pad_to_multiple():
    a = torch.ones(13, 4)
    p, n = pad_to_multiple(a, 8)
    assert p.shape == (16, 4) and n == 3 and not p[13:].any()
    p2, n2 = pad_to_multiple(p, 8)
    assert p2.shape == (16, 4) and n2 == 0


def test_one_rank_in_process(tmp_path):
    """A 1-rank gloo group in this process: make_mesh's checks, and the
    stencils with both aprons reflected (no exchange) equal the dense."""
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")
    init_process_group(0, 1, f"file://{tmp_path}/store", "cpu")
    try:
        assert dist.get_backend() == "gloo"
        mesh = make_mesh(axis="row", device="cpu")
        with pytest.raises(ValueError):
            make_mesh(2, device="cpu")
        img = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 255, (23, 31)).astype(np.float32))
        assert torch.equal(sharded_gaussian_blur(mesh)(img),
                           binomial_blur5(img))
        assert torch.equal(sharded_fast_score(mesh)(img), fast_score(img))
        with pytest.raises(ValueError, match="halo"):
            sharded_fast_score(mesh)(img[:3])
    finally:
        dist.destroy_process_group()


def test_watchdog_fires_on_timeout_and_not_on_fast_steps():
    events = []
    wd = StepWatchdog(timeout_s=0.05,
                      on_timeout=lambda tag, dt: events.append(tag))
    with wd.watch("fast"):
        pass
    time.sleep(0.1)
    assert events == []
    with wd.watch("slow"):
        time.sleep(0.15)
    assert events == ["slow"] and wd.fired == ["slow"]


def test_scaling_cli_two_ranks(capsys):
    out = scaling.main(["--cpu", "2", "--shape", "120", "160",
                        "--nfeatures", "64", "--iters", "1", "--step"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["backend"] == "gloo" and out["device"] == "cpu"
    for key in ("detect", "fused_step"):
        assert [r["devices"] for r in out[key]] == [1, 2]
    assert all(r["fps"] > 0 for r in out["detect"] + out["fused_step"])


def test_binomial_blur5_matches_vo_tpu():
    rng = np.random.default_rng(0)
    for shape in ((64, 48), (37, 53)):
        img = rng.uniform(0, 255, shape).astype(np.float32)
        np.testing.assert_allclose(
            binomial_blur5(torch.from_numpy(img)).numpy(),
            np.asarray(jax_blur(jnp.asarray(img))), atol=2e-3)


def test_sharded_lk_matches_vo_tpu_dense_lanes(world2):
    """The 2-rank sharded tracker against vo_tpu's dense lanes tracker on
    the same scene: status equal, endpoints within the bounds
    tests/test_torch_lk.py holds the dense port to."""
    img1, img2, pts, valid = lk_inputs(16)
    c = lk_config()
    cfg = jlk.LKConfig(win=c.win, max_level=c.max_level, iters=c.iters,
                       window_margin=c.window_margin,
                       coarse_margin=c.coarse_margin, layout="lanes",
                       exit_mult=len(pts) + 1)
    pyr1 = jlk.lk_build_pyramid(jnp.asarray(img1), cfg)
    pyr2 = jlk.lk_build_pyramid(jnp.asarray(img2), cfg)
    out, st, _ = jlk.lk_pyramid_track_cached(
        jlk.lk_make_cache(pyr1, jnp.asarray(pts), cfg), pyr2,
        jnp.asarray(pts), jnp.asarray(valid), cfg)
    sj = np.asarray(st)
    sharded = world2["lk"]["sharded"]
    np.testing.assert_array_equal(sharded["status"], sj)
    d = np.abs(sharded["pts"][sj] - np.asarray(out)[sj]).max(axis=1)
    assert sj.sum() > 0
    assert np.percentile(d, 99) < 1e-3 and d.max() < 2e-2, d.max()
