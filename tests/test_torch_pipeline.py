"""The port's TrackingVO against vo_tpu's, frame by frame, on the CPU.

vo_tpu runs with LKConfig(layout="lanes", exit_mult=N + 1): per-point LK
termination, the port's definition (see vo_tpu_torch/ops/lk_cuda.py), and
no Pallas interpret mode. (exit_mult * N must stay below 2**31: vo_tpu
counts in int32, and an overflow ends its LK loops before any step.) Both
run the sync re-detect gate, and the port gets each step's RANSAC draws
from vo_tpu's key chain.

What is held exactly (or to float rounding) is everything the data path
decides: tracked points and their status, association counts, re-detect
steps and their matches. The pose is held tightly on a well-conditioned
frame pair (test_step_from_converted_state). At 240x320 most frame pairs
are not: vo_tpu's own step moves by up to ~5 (pose entries, unit steps)
when its tracked points move by 1e-4 px, because many essential matrices
explain every correspondence within the 1 px threshold and the winner
depends on the f32 root sets of the 5-point solver. There
test_step_pose_per_frame runs the port's step from vo_tpu's state and holds
its pose to that sensitivity, measured on vo_tpu itself for every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.data.synthetic import SyntheticSequence
from vo_tpu.frontend import orb as jorb
from vo_tpu.frontend.orb import OrbConfig as JOrb
from vo_tpu.models import vo as jvo
from vo_tpu.ops.lk import LKConfig as JLK
from vo_tpu_torch.frontend.orb import OrbConfig as TOrb
from vo_tpu_torch.models import vo as tvo
from vo_tpu_torch.models.convert import state_from_numpy
from vo_tpu_torch.ops.lk_cuda import crop_windows
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")

ORB = dict(nfeatures=500, n_levels=4)
N_ITERS = 256
N_CAP = sum(jorb.level_budgets(JOrb(**ORB)))  # tracked-point capacity


def _configs():
    jcfg = jvo.VOConfig(
        orb=JOrb(**ORB), lk=JLK(layout="lanes", exit_mult=N_CAP + 1),
        fallback_gate="sync", ransac_iters=N_ITERS,
    )
    tcfg = tvo.VOConfig(orb=TOrb(**ORB), fallback_gate="sync",
                        ransac_iters=N_ITERS)
    return jcfg, tcfg


def _slot(sub_key, n_assoc):
    """The draws vo_tpu's ransac_essential makes from `sub_key`."""
    n_valid = max(int(n_assoc), 5)
    return torch.from_numpy(np.asarray(
        jax.random.randint(sub_key, (N_ITERS, 5), 0, n_valid)))


@pytest.fixture(scope="module")
def ref_vo():
    """One vo_tpu pipeline for the module: its jitted programs compile
    once and serve every sequence (all share shape and intrinsics)."""
    seq = SyntheticSequence.generate(n_frames=2, shape=(240, 320))
    return jvo.TrackingVO(seq.K, _configs()[0])


def _run_reference(vo, seq):
    """vo_tpu over the sequence: per step, the state before it (numpy
    leaves), its RANSAC key, its output, the state after it, and the
    state before it as vo_tpu holds it."""
    state = vo.init(seq.frame(0))
    steps = []
    for i in range(1, len(seq)):
        _, sub = jax.random.split(state.key)
        held = state
        before = jax.tree.map(np.asarray, state)
        state, out = vo.step(state, seq.frame(i))
        steps.append((before, sub, jax.tree.map(np.asarray, out),
                      jax.tree.map(np.asarray, state), held))
    return steps


@pytest.fixture(scope="module", params=["tracking", "forced_redetect"])
def runs(request, ref_vo):
    # speed 8 keeps the per-frame motion well above LK noise; frame 5 of
    # the second sequence renders no landmarks, which drops the survivor
    # count to 0 and forces re-detects on the following steps
    drop = ((5, 6),) if request.param == "forced_redetect" else ()
    seq = SyntheticSequence.generate(
        n_frames=9, shape=(240, 320), n_points=1500, seed=0, speed=8.0,
        yaw_amplitude=0.05, dropouts=drop, dropout_keep=0.0,
    )
    ref = _run_reference(ref_vo, seq)
    _, tcfg = _configs()
    vo = tvo.TrackingVO(seq.K, tcfg, device="cpu")
    state = vo.init(seq.frame(0))
    port = []
    for i, (_, sub, out, _, _) in enumerate(ref, start=1):
        state, o = vo.step(state, seq.frame(i), slot=_slot(sub, out.n_assoc))
        port.append((o, state))
    return request.param, ref, port, seq


def test_frame_by_frame(runs):
    kind, ref, port, _ = runs
    fallbacks = []
    for (_, _, jo, js, _), (to, ts) in zip(ref, port):
        assert bool(to.fallback) == bool(jo.fallback)
        fallbacks.append(bool(jo.fallback))
        # the associations (LK status, or re-detect matches) are the same
        assert abs(int(to.n_assoc) - int(jo.n_assoc)) <= 1
        vj, vt = js.pts_valid, ts.pts_valid.numpy()
        assert (vj == vt).mean() >= 0.995
        both = vj & vt
        if both.any():
            # tracked points: the LK sums differ only in f32 rounding order
            d = np.abs(js.pts[both] - ts.pts.numpy()[both]).max(axis=1)
            assert np.percentile(d, 99) < 1e-3 and d.max() < 0.05, d.max()
        # pose support: both poses hold (or both fail) and are consistent
        # with nearly all associations
        assert (int(to.health) > 0) == (int(jo.health) > 0)
        assert int(to.n_inliers) >= 0.9 * int(jo.n_inliers) - 2
        np.testing.assert_array_equal(to.gate.numpy(), jo.gate)
        assert np.isfinite(to.pose.numpy()).all()
    assert any(fallbacks) == (kind == "forced_redetect")


def _jittered_step(vo, state, img, rng, fallback):
    """vo_tpu's step from `state` with its points (or, at a re-detect,
    the previous frame's keypoints) moved by N(0, 1e-4 px)."""
    img = jnp.asarray(img, jnp.float32)

    def jitter(p):
        return p + jnp.asarray(rng.normal(0.0, 1e-4, p.shape), p.dtype)

    if fallback:
        p1, d1, v1 = vo._detect_jit(state.pyramid[0])
        _, out = vo._refresh_jit(state, img, (jitter(p1), d1, v1),
                                 vo._detect_jit(img), vo.K)
    else:
        _, out = vo._track_jit(state._replace(pts=jitter(state.pts)), img,
                               vo.K)
    return np.asarray(out.pose)


def test_step_pose_per_frame(runs, ref_vo):
    """Each step of the port, run from vo_tpu's state before it with the
    same RANSAC draws, lands within vo_tpu's own response to a 1e-4 px
    jitter of its points: per step within 3x the larger gap of two
    jittered runs (plus 1e-3), and over the sequence within the sum of
    those gaps. (One jittered run is too small a sample: its gap falls
    below a third of the port's on some steps.)"""
    kind, ref, _, seq = runs
    _, tcfg = _configs()
    vo = tvo.TrackingVO(seq.K, tcfg, device="cpu")
    vo.init(seq.frame(0))
    rng = np.random.default_rng(0)
    port_gaps, ref_gaps = [], []
    for i, (before, sub, jo, _, held) in enumerate(ref, start=1):
        ts, to = vo.step(state_from_numpy(before, "cpu"), seq.frame(i),
                         slot=_slot(sub, jo.n_assoc))
        assert bool(to.fallback) == bool(jo.fallback)
        assert int(to.n_assoc) == int(jo.n_assoc)
        gap = np.abs(to.pose.numpy() - jo.pose).max()
        spread = max(np.abs(_jittered_step(ref_vo, held, seq.frame(i), rng,
                                           bool(jo.fallback)) - jo.pose).max()
                     for _ in range(2))
        assert gap <= 3.0 * spread + 1e-3, (i, gap, spread)
        port_gaps.append(gap)
        ref_gaps.append(spread)
    print(f"{kind}: port gap / jittered gap per step "
          f"{np.round(np.divide(port_gaps, np.maximum(ref_gaps, 1e-9)), 2)}"
          f", jittered gaps {np.round(ref_gaps, 4)}, sum ratio "
          f"{sum(port_gaps) / sum(ref_gaps):.2f}")
    assert sum(port_gaps) <= sum(ref_gaps), (port_gaps, ref_gaps)


def test_step_from_converted_state(ref_vo):
    seq = SyntheticSequence.generate(n_frames=3, shape=(240, 320),
                                     n_points=1500, seed=0, speed=8.0,
                                     yaw_amplitude=0.05)
    before, sub, jo, js, _ = _run_reference(ref_vo, seq)[0]
    state = state_from_numpy(before, "cpu")
    # vo_tpu's cached windows (lane stacks padded with one zero row/col
    # before and 9 after) are the crops of its pyramid at its origins
    for L, (w, o) in enumerate(zip(before.lk_cache.wins,
                                   before.lk_cache.origins)):
        S = w.shape[0] - 10
        if S < 2:
            continue
        crop = crop_windows(state.pyramid[L], state.lk_cache.origins[L][:, 0],
                            state.lk_cache.origins[L][:, 1], S, "bf16")
        ref = np.asarray(w, np.float32)[1:S + 1, 1:S + 1].transpose(2, 0, 1)
        np.testing.assert_array_equal(crop.numpy(), ref)

    _, tcfg = _configs()
    vo = tvo.TrackingVO(seq.K, tcfg, device="cpu")
    ts, to = vo.step(state, seq.frame(1), slot=_slot(sub, jo.n_assoc))
    assert int(to.n_assoc) == int(jo.n_assoc)
    assert abs(int(to.n_inliers) - int(jo.n_inliers)) <= 2
    # a well-conditioned pair: the same draws give the same pose
    np.testing.assert_allclose(to.pose.numpy(), jo.pose, atol=1e-4)
    np.testing.assert_allclose(float(to.scale), float(jo.scale), rtol=1e-4)
    for L in range(len(js.lk_cache.origins)):
        np.testing.assert_array_equal(ts.lk_cache.origins[L].numpy(),
                                      js.lk_cache.origins[L])


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_gate_triggers_match(mode):
    """The re-detect gate fires on the same steps as vo_tpu's for the same
    stream of [dip latch, health] pairs (host tensors: every pair has
    arrived by the next update, in either mode)."""
    rng = np.random.default_rng(5)
    jgate = jvo._AsyncScalarGate(150, mode, max_lag=4)
    tgate = tvo._AsyncScalarGate(mode, max_lag=4)
    fired = []
    for _ in range(60):
        fire = jgate.update()
        assert tgate.update() == fire
        fired.append(fire)
        pair = np.array([rng.random() < 0.2, rng.integers(0, 400)], np.int32)
        jgate.push(jax.numpy.asarray(pair))
        tgate.push(torch.from_numpy(pair))
    assert 0 < sum(fired) < len(fired)
