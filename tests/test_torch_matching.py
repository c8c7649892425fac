"""The port's matching pipelines (MatchingVO, ThreeFrameVO) against
vo_tpu's, on the CPU.

The per-step parity tests feed both packages the same features, made with
numpy from a seed: a synthetic scene of 3-D points seen from a camera that
moves forward and turns, each point with its own descriptor (ORB bit
planes or SIFT-like unit vectors) perturbed per view, the detections in a
random slot order with distractors and empty slots. Each step runs from
vo_tpu's state before it (carried across by the converters) with vo_tpu's
RANSAC draws. Matches, their validity and the association counts must be
exact. The pose and the scale are held to vo_tpu's own response to a
1e-4 px jitter of the points of the frames the step reads: within 3x the
largest gap of three jittered runs, plus 1e-4.

Only vo_tpu's small cores run (`_matching_core` for ORB and for SIFT,
`_tf_core`), without an outer jit: their jitted parts (RANSAC, pose,
scale) compile once for the module, at one shape, and serve all three.
vo_tpu's detect never runs. The presets' end-to-end runs are in
tests/test_torch_presets.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.geometry import scale as jscale
from vo_tpu.geometry import triangulate as jtri
from vo_tpu.models import vo as jvo
from vo_tpu.models import vo_3frame as jtf
from vo_tpu_torch.geometry import scale as tscale
from vo_tpu_torch.geometry import triangulate as ttri
from vo_tpu_torch.geometry.se3 import exp_so3
from vo_tpu_torch.models import vo as tvo
from vo_tpu_torch.models import vo_3frame as ttf
from vo_tpu_torch.models.convert import (
    matching_state_from_numpy,
    state_to_numpy,
    three_frame_state_from_numpy,
)
from torch_parity import K_SCENE as K_NP
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)
from torch_parity import scene_features

pytestmark = pytest.mark.usefixtures("low_cpu_priority")

N_ITERS = 64


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ scale


SCALE_CASES = {
    # (prev capacity, cur capacity, prev valid, cur valid)
    "unequal capacities": (40, 25, 30, 20),
    "unequal, cur larger": (20, 33, 15, 30),
    "no valid point": (12, 12, 0, 0),
    "one valid point": (12, 12, 1, 9),
    "two valid points": (12, 12, 2, 2),
    "unequal, sparse": (30, 18, 4, 3),
}


@pytest.mark.parametrize("case", sorted(SCALE_CASES))
def test_relative_scale_unmatched(case):
    """Exact agreement with vo_tpu's (same f32 ops, same upper median)."""
    n_prev, n_cur, v_prev, v_cur = SCALE_CASES[case]
    rng = np.random.default_rng(len(case))
    prev = rng.normal(0, 5, (n_prev, 3)).astype(np.float32)
    cur = rng.normal(0, 5, (n_cur, 3)).astype(np.float32)
    pv = np.zeros(n_prev, bool)
    pv[rng.permutation(n_prev)[:v_prev]] = True
    cv = np.zeros(n_cur, bool)
    cv[rng.permutation(n_cur)[:v_cur]] = True
    ref = float(jscale.relative_scale_unmatched(prev, pv, cur, cv))
    got = float(tscale.relative_scale_unmatched(_t(prev), _t(pv), _t(cur),
                                                _t(cv)))
    assert got == ref
    if v_prev < 2 or v_cur < 2:
        assert got == 1.0  # no consecutive pair: the empty median


def test_relative_scale_unmatched_ties():
    """Equal ratios across the upper median pick the same value, and a
    cloud that is an exact multiple of the other gives that multiple."""
    base = np.repeat(np.arange(6, dtype=np.float32)[:, None], 3, 1)
    cur = np.concatenate([base, base[::-1]])  # distances repeat: ties
    prev = 2.0 * cur
    v = np.ones(len(cur), bool)
    v[3] = False
    ref = float(jscale.relative_scale_unmatched(prev, v, cur, v))
    got = float(tscale.relative_scale_unmatched(_t(prev), _t(v), _t(cur),
                                                _t(v)))
    assert got == ref
    assert abs(got - 2.0) < 1e-5


def test_relative_scale_unmatched_capacity_one():
    """A cloud of capacity 1 has no consecutive pair: the empty median,
    1.0 (vo_tpu's raises IndexError while tracing here; the port does
    not copy that)."""
    one = torch.zeros((1, 3))
    many = torch.randn(12, 3, generator=torch.Generator().manual_seed(0))
    v = torch.ones(12, dtype=torch.bool)
    assert float(tscale.relative_scale_unmatched(
        one, torch.ones(1, dtype=torch.bool), many, v)) == 1.0


# ---------------------------------------------------------- triangulation


def _two_views(rng, n=200):
    X = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3, 3, n),
                  rng.uniform(4, 30, n)], 1)
    R = exp_so3(torch.tensor([0.01, -0.03, 0.02], dtype=torch.float64)
                ).numpy()
    t = np.array([0.3, -0.05, -1.0])
    x2 = X @ R.T + t
    p1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    p2 = (x2[:, :2] / x2[:, 2:]).astype(np.float32)
    p1 += rng.normal(0, 1e-3, p1.shape).astype(np.float32)
    return R.astype(np.float32), t.astype(np.float32), p1, p2, X


def _ray_condition(R, p1, p2):
    """Per point aa bb / (aa bb - ab^2) of the closed-form depth solve
    (f64): the factor by which near-parallel rays amplify rounding."""
    x1 = np.concatenate([p1, np.ones((len(p1), 1))], 1).astype(np.float64)
    x2 = np.concatenate([p2, np.ones((len(p2), 1))], 1).astype(np.float64)
    a = x1 @ R.astype(np.float64).T
    aa, bb, ab = (a * a).sum(1), (x2 * x2).sum(1), (a * x2).sum(1)
    return aa * bb / (aa * bb - ab * ab)


def test_triangulate_fast_and_normalized():
    """Closed-form points and the DLT (eigh) against vo_tpu's. The depth
    of near-parallel rays is ill-conditioned in f32 (condition 30 to 1.5e5
    here), so each point is held to 8 eps32 times its ray condition,
    relative to its depth (measured: 2.1 at most, and each package strays
    from an f64 run by as much). The DLT's eigenvector sign cancels in
    X[:3] / w, so points are compared, not vectors."""
    R, t, p1, p2, X = _two_views(np.random.default_rng(1))
    tol = 8 * np.finfo(np.float32).eps * _ray_condition(R, p1, p2)
    fast_j = np.asarray(jtri.triangulate_fast(R, t, p1, p2))
    fast_t = ttri.triangulate_fast(_t(R), _t(t), _t(p1), _t(p2)).numpy()
    rel = np.abs(fast_t - fast_j).max(1) / np.abs(fast_j[:, 2])
    assert (rel <= tol).all(), (rel / tol).max()
    dlt_j = np.asarray(jtri.triangulate_normalized(R, t, p1, p2))
    dlt_t = ttri.triangulate_normalized(_t(R), _t(t), _t(p1), _t(p2)).numpy()
    rel = np.abs(dlt_t - dlt_j).max(1) / np.abs(dlt_j[:, 2])
    print(f"DLT: max relative gap / ray tolerance {(rel / tol).max():.3f}")
    assert (rel <= tol).all(), (rel / tol).max()
    # both near the truth (1e-3 of noise on ~1 m baselines)
    assert np.median(np.abs(dlt_t - X).max(1) / X[:, 2]) < 0.05
    assert np.median(np.abs(fast_t - X).max(1) / X[:, 2]) < 0.05


def test_triangulate_dlt_pixels():
    """The DLT on pixel observations under K [I|0] and K [R|t], held as
    test_triangulate_fast_and_normalized holds it."""
    R, t, p1, p2, X = _two_views(np.random.default_rng(2))
    tol = 8 * np.finfo(np.float32).eps * _ray_condition(R, p1, p2)
    K = K_NP.astype(np.float32)
    P1 = K @ np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(
        np.float32)
    P2 = K @ np.concatenate([R, t[:, None]], 1)
    u1 = p1 @ K[:2, :2].T + K[:2, 2]
    u2 = p2 @ K[:2, :2].T + K[:2, 2]
    ref = np.asarray(jtri.triangulate_dlt(P1, P2, u1, u2))
    got = ttri.triangulate_dlt(_t(P1), _t(P2), _t(u1), _t(u2)).numpy()
    rel = np.abs(got - ref).max(1) / np.abs(ref[:, 2])
    print(f"DLT on pixels: max relative gap / ray tolerance "
          f"{(rel / tol).max():.3f}")
    assert (rel <= tol).all(), (rel / tol).max()


# ------------------------------------------------------- features from numpy


def _configs(detector: str, scale_mode: str):
    jcfg = jvo.VOConfig(detector=detector, scale_mode=scale_mode,
                        ransac_iters=N_ITERS)
    tcfg = tvo.VOConfig(detector=detector, scale_mode=scale_mode,
                        ransac_iters=N_ITERS)
    return jcfg, tcfg


def _slot(sub_key, n_assoc):
    """The draws vo_tpu's ransac_essential makes from `sub_key`."""
    return torch.from_numpy(np.asarray(jax.random.randint(
        sub_key, (N_ITERS, 5), 0, max(int(n_assoc), 5))))


def _jfeats(f):
    return tuple(jnp.asarray(a) for a in f)


def _tfeats(f):
    return tuple(_t(a) for a in f)


def _jitter(rng, pts):
    """Points moved by N(0, 1e-4 px), as f32."""
    return np.asarray(pts) + rng.normal(0, 1e-4, pts.shape).astype(np.float32)


def _check_step(ref_pose, ref_scale, to, jitter_runs):
    """The port's pose and scale against vo_tpu's, within 3x vo_tpu's
    own response to the jitter (plus 1e-4). The scale moves most: it is
    the upper median of ~300 distance ratios of clouds whose far points
    have sub-pixel parallax (vo_tpu's own moves by up to 5 % here)."""
    gap = np.abs(to.pose.numpy() - ref_pose).max()
    spread = max(np.abs(p - ref_pose).max() for p, _ in jitter_runs)
    assert gap <= 3.0 * spread + 1e-4, (gap, spread)
    ds = abs(float(to.scale) - ref_scale)
    s_spread = max(abs(s - ref_scale) for _, s in jitter_runs)
    assert ds <= 3.0 * s_spread + 1e-4, (ds, s_spread)
    return gap, spread


@pytest.mark.parametrize("detector", ["orb", "sift"])
def test_matching_core_steps(detector):
    """Three steps of _matching_core from vo_tpu's state each time."""
    jcfg, tcfg = _configs(detector, "unmatched")
    core = functools.partial(jvo._matching_core, cfg=jcfg)
    frames, _ = scene_features(detector)
    K = jnp.asarray(K_NP, jnp.float32)
    Kt = _t(K_NP).float()
    jstate = jvo._matching_init(_jfeats(frames[0]), jax.random.PRNGKey(3),
                                jcfg)
    rng = np.random.default_rng(7)
    scales = []
    for f in frames[1:]:
        before = jax.tree.map(np.asarray, jstate)
        _, sub = jax.random.split(jstate.key)
        jnext, jo = core(jstate, _jfeats(f), K)
        # the matches themselves: same validity, same indices where valid
        jm = jvo.match_features(jstate.desc, jnp.asarray(f[1]), jstate.valid,
                                jnp.asarray(f[2]), jcfg)
        tm = tvo.match_features(_t(before.desc), _t(f[1]), _t(before.valid),
                                _t(f[2]), tcfg)
        jv = np.asarray(jm.valid)
        np.testing.assert_array_equal(tm.valid.numpy(), jv)
        np.testing.assert_array_equal(tm.idx.numpy()[jv],
                                      np.asarray(jm.idx)[jv])
        assert jv.sum() > 200

        ts, to = tvo._matching_core(
            matching_state_from_numpy(before, "cpu"), _tfeats(f), Kt, tcfg,
            slot=_slot(sub, jo.n_assoc))
        assert int(to.n_assoc) == int(jo.n_assoc)
        assert int(to.health) == int(jo.health)
        np.testing.assert_array_equal(to.gate.numpy(), np.asarray(jo.gate))
        jitter = []
        for _ in range(3):
            moved = jstate._replace(pts=_jitter(rng, jstate.pts))
            _, o = core(moved, _jfeats((_jitter(rng, f[0]),) + f[1:]), K)
            jitter.append((np.asarray(o.pose), float(o.scale)))
        _check_step(np.asarray(jo.pose), float(jo.scale), to, jitter)
        # the cached cloud: same validity on nearly every slot
        agree = (ts.prev3d_valid.numpy() == np.asarray(jnext.prev3d_valid))
        assert agree.mean() >= 0.99
        scales.append(float(jo.scale))
        jstate = jnext
    assert scales[0] == 1.0 and all(0.1 < s < 5.0 for s in scales[1:])


def test_three_frame_core_steps():
    """Three steps of _tf_core from vo_tpu's state each time: the carried
    (t-1, t) matches exact, the pose and the 3-frame scale to vo_tpu's
    sensitivity; the first step's scale is 1 (fewer than 3 frames)."""
    jcfg, tcfg = _configs("orb", "matched")
    tf_core = functools.partial(jtf._tf_core, cfg=jcfg)
    frames, _ = scene_features("orb", seed=1)
    K = jnp.asarray(K_NP, jnp.float32)
    Kt = _t(K_NP).float()
    jstate = jtf._tf_init(_jfeats(frames[0]), jax.random.PRNGKey(5), jcfg)
    tinit = ttf._tf_init(_tfeats(frames[0]), torch.Generator(), tcfg)
    ref0 = jax.tree.map(np.asarray, jstate)
    np.testing.assert_array_equal(tinit.m_ab_idx.numpy(), ref0.m_ab_idx)
    np.testing.assert_array_equal(tinit.t_ab.numpy(), ref0.t_ab)
    rng = np.random.default_rng(9)
    for step, f in enumerate(frames[1:], start=1):
        before = jax.tree.map(np.asarray, jstate)
        _, sub = jax.random.split(jstate.key)
        jnext, jo = tf_core(jstate, _jfeats(f), K)
        ts, to = ttf._tf_core(three_frame_state_from_numpy(before, "cpu"),
                              _tfeats(f), Kt, tcfg,
                              slot=_slot(sub, jo.n_assoc))
        assert int(to.n_assoc) == int(jo.n_assoc) > 100
        assert int(to.n_inliers) >= 0.95 * int(jo.n_inliers)
        jv = np.asarray(jnext.m_ab_valid)
        np.testing.assert_array_equal(ts.m_ab_valid.numpy(), jv)
        np.testing.assert_array_equal(ts.m_ab_idx.numpy()[jv],
                                      np.asarray(jnext.m_ab_idx)[jv])
        assert int(ts.n_frames) == int(jnext.n_frames) == step + 1
        jitter = []
        for _ in range(3):
            moved = jstate._replace(pts_a=_jitter(rng, jstate.pts_a),
                                    pts_b=_jitter(rng, jstate.pts_b))
            _, o = tf_core(moved, _jfeats((_jitter(rng, f[0]),) + f[1:]), K)
            jitter.append((np.asarray(o.pose), float(o.scale)))
        _check_step(np.asarray(jo.pose), float(jo.scale), to, jitter)
        if step == 1:
            assert float(to.scale) == float(jo.scale) == 1.0
        jstate = jnext


def test_state_converters_round_trip():
    """vo_tpu's matching and 3-frame states survive the trip into the
    port and back to numpy unchanged (the key aside)."""
    frames, _ = scene_features("sift", n_frames=1)
    jcfg, _ = _configs("sift", "unmatched")
    js = jax.tree.map(np.asarray, jvo._matching_init(
        _jfeats(frames[0]), jax.random.PRNGKey(0), jcfg))
    back = state_to_numpy(matching_state_from_numpy(js, "cpu"))
    for name in tvo.MatchingState._fields:
        if name != "gen":
            np.testing.assert_array_equal(getattr(back, name),
                                          getattr(js, name), err_msg=name)
    jt = jax.tree.map(np.asarray, jtf._tf_init(
        _jfeats(frames[0]), jax.random.PRNGKey(0), jcfg))
    back = state_to_numpy(three_frame_state_from_numpy(jt, "cpu"))
    for name in ttf.ThreeFrameState._fields:
        if name != "gen":
            np.testing.assert_array_equal(getattr(back, name),
                                          getattr(jt, name), err_msg=name)
