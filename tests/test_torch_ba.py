"""The port's bundle adjustment (ba/schur.py, ba/window.py, geometry/pnp.py,
the state of models/vo_ba.py) against vo_tpu's, on the CPU. The BA
pipeline's end-to-end run is in tests/test_torch_presets.py.

Inputs are tests/test_ba.py's `make_ba_problem` window (5 cameras moving
along +z, 64 points 15-60 m ahead), made with numpy from a seed. vo_tpu's
BA runs without an outer jit: its LM scan compiles once per form (with
and without the landmark prior) at one shape and serves every test of
the module; its detect and LK never run.

Tolerances. On this well-conditioned window every LM accept decision must
be the same, and the cost, the poses and the points agree to f32 rounding
carried through 20 LM steps: cost rtol 1e-4 (candidate costs 1e-3),
poses atol 1e-4, points 1e-3 of their depth (the depth of a far point is
the least determined coordinate: measured 3e-4).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba import make_ba_problem
from vo_tpu.ba import schur as jschur
from vo_tpu.ba import window as jwin
from vo_tpu.geometry import pnp as jpnp
from vo_tpu.geometry.se3 import exp_so3 as jexp
from vo_tpu.geometry.se3 import inv_se3 as jinv
from vo_tpu.geometry.se3 import make_se3 as jmake
from vo_tpu.models import vo_ba as jvo_ba
from vo_tpu.ops.lk import LKCache as JLKCache
from vo_tpu_torch.ba import schur as tschur
from vo_tpu_torch.ba import window as twin
from vo_tpu_torch.data.synthetic import SyntheticSequence
from vo_tpu_torch.geometry import pnp as tpnp
from vo_tpu_torch.geometry.se3 import exp_so3 as texp
from vo_tpu_torch.models.convert import state_to_numpy, tracking_ba_state_from_numpy
from vo_tpu_torch.runtime.presets import PRESETS
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")

L = 64
W_FULL = 5  # make_ba_problem's window


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(x) -> list:
    """The arrays of a (nested) state, in field order."""
    if isinstance(x, tuple):
        return [leaf for item in x for leaf in _leaves(item)]
    return [np.asarray(x, np.float32) if x.dtype.name == "bfloat16"
            else np.asarray(x)]


@pytest.fixture(scope="module")
def problem():
    p0, X0, obs, K, _, _ = make_ba_problem(L=L)
    return tuple(np.asarray(a) for a in (p0, X0, obs, K))


def test_res_and_jac(problem):
    """Residuals and Jacobians against vo_tpu's and against torch.func
    autodiff of the single residual (pose 0 has a zero angle: the
    small-angle branch of the Rodrigues map)."""
    p0, X0, obs, K = problem
    ref = jschur._res_and_jac(*(jnp.asarray(a) for a in problem))
    got = tschur._res_and_jac(*(_t(a) for a in problem))
    for name, r, g in zip(("r", "Jc", "Jp"), ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)
    jac = torch.func.jacfwd(tschur._residual, argnums=(0, 1))
    per_obs = torch.func.vmap(torch.func.vmap(jac, (None, 0, 0, None)),
                              (0, None, 0, None))
    Jc_auto, Jp_auto = per_obs(_t(p0), _t(X0), _t(obs), _t(K))
    for g, a in ((got[1], Jc_auto), (got[2], Jp_auto)):
        a = a.numpy()
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max())


def test_closed_form_jacobians():
    """exp_so3's Jacobian and the scale-gauge prior's gradient, both in
    closed form, against vo_tpu's jax.jacfwd and torch.func autodiff
    (zero, tiny and large angles), to 1e-6 of their largest entry."""
    import jax

    from vo_tpu_torch.geometry.se3 import exp_so3_jacobian

    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.3, (6, 3)).astype(np.float32)
    w[0], w[1], w[2] = 0.0, 1e-8, [2.5, -1.0, 0.3]
    got = exp_so3_jacobian(_t(w)).numpy()
    ref = np.asarray(jax.vmap(jax.jacfwd(jexp))(jnp.asarray(w)))
    auto = torch.func.vmap(torch.func.jacfwd(texp))(_t(w)).numpy()
    for r in (ref, auto):
        np.testing.assert_allclose(got, r, atol=1e-6 * np.abs(r).max())
    poses = _t(rng.normal(0, 0.3, (5, 6)).astype(np.float32))
    for mode in ("traj_len", "baseline0"):
        _, grad = tschur._gauge_obs(poses, mode)
        auto = torch.func.jacrev(lambda p: tschur._gauge_obs(p, mode)[0])(
            poses)
        np.testing.assert_allclose(grad.numpy(), auto.numpy(),
                                   atol=1e-6 * auto.abs().max().item())


def test_bundle_adjust(problem):
    """The whole LM solve: identical accept trace (step 2 is refused in
    both), and cost, poses and points to the module's tolerances."""
    p0, X0, obs, K = problem
    W = obs.shape[0]
    masks = (np.ones((W, L), bool), np.ones(L, bool))
    jr, jtr = jschur.bundle_adjust(
        *(jnp.asarray(a) for a in (p0, X0, obs)), *map(jnp.asarray, masks),
        jnp.asarray(K), return_trace=True)
    tr, ttr = tschur.bundle_adjust(
        *(_t(a) for a in (p0, X0, obs)), *map(_t, masks), _t(K),
        return_trace=True)
    np.testing.assert_array_equal(ttr[0].numpy(), np.asarray(jtr[0]))
    assert 0 < ttr[0].numpy().sum() < len(ttr[0])  # rejections too
    np.testing.assert_allclose(ttr[1].numpy(), np.asarray(jtr[1]), rtol=1e-6)
    # candidate costs: the refused step's (a long step at small lambda)
    # differs by 2.1e-4, the others by < 2e-6
    np.testing.assert_allclose(ttr[2].numpy(), np.asarray(jtr[2]), rtol=1e-3)
    for a in ("cost0", "cost"):
        np.testing.assert_allclose(float(getattr(tr, a)),
                                   float(getattr(jr, a)), rtol=1e-4)
    assert float(tr.cost) < 0.1 * float(tr.cost0)
    np.testing.assert_allclose(tr.poses.numpy(), np.asarray(jr.poses),
                               atol=1e-4)
    jp = np.asarray(jr.points)
    assert (np.abs(tr.points.numpy() - jp).max(1) <= 1e-3 * jp[:, 2]).all()
    assert int(tr.n_obs) == int(jr.n_obs) == W * L


def test_reprojection_rmse(problem):
    p0, X0, obs, K = problem
    W = obs.shape[0]
    om = np.ones((W, L), bool)
    om[1, ::3] = False
    pm = np.ones(L, bool)
    pm[::7] = False
    ref = float(jschur.reprojection_rmse(*(jnp.asarray(a) for a in (
        p0, X0, obs, om, pm, K))))
    got = float(tschur.reprojection_rmse(*(_t(a) for a in (
        p0, X0, obs, om, pm, K))))
    assert abs(got - ref) <= 1e-5 * ref


# ------------------------------------------------------------------ window


def _window_arrays(count=None):
    """tests/test_parallel.py's window: exact observations of the true
    scene, cam->world poses of frames 2-4 pushed off by (0.2, -0.1, 0.3)."""
    _, _, obs, K, p_gt, _ = make_ba_problem(L=L, noise_px=0.0, pose_noise=0.0,
                                            point_noise=0.0)
    W = obs.shape[0]
    T_wc = jmake(jexp(jnp.asarray(p_gt[:, :3], jnp.float32)),
                 jnp.asarray(p_gt[:, 3:], jnp.float32))
    T_cw = np.asarray(jinv(T_wc)).copy()
    T_cw[2:, :3, 3] += np.array([0.2, -0.1, 0.3])
    n = W if count is None else count
    return T_cw.astype(np.float32), np.asarray(obs), np.asarray(K), W, n


def _windows(count=None):
    """The same window in both packages, filled by window_push."""
    T_cw, obs, K, W, n = _window_arrays(count)
    js, ts = jwin.window_init(W, L), twin.window_init(W, L)
    v = np.ones(L, bool)
    for i in range(W - n, W):
        js = jwin.window_push(js, jnp.asarray(T_cw[i]), jnp.asarray(obs[i]),
                              jnp.asarray(v))
        ts = twin.window_push(ts, _t(T_cw[i]), _t(obs[i]), _t(v))
    return js, ts, K, W


def _same_window(ts, js):
    for name in twin.WindowState._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)


def test_window_push_and_remap():
    """Pushes past the window's size (the oldest frame drops out) and a
    remap with repeated, unmapped and dropped slots: exact."""
    js, ts, _, W = _windows(count=3)
    assert int(ts.count) == int(js.count) == 3
    _same_window(ts, js)
    rng = np.random.default_rng(4)
    for _ in range(W):  # fill and shift
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.normal(size=3)
        pts = rng.uniform(0, 300, (L, 2)).astype(np.float32)
        v = rng.random(L) > 0.2
        js = jwin.window_push(js, jnp.asarray(pose), jnp.asarray(pts),
                              jnp.asarray(v))
        ts = twin.window_push(ts, _t(pose), _t(pts), _t(v))
    _same_window(ts, js)
    old_idx = rng.integers(0, L, L)
    old_idx[:4] = 7  # several new slots inherit one old slot
    ok = rng.random(L) > 0.3
    _same_window(twin.window_remap(ts, _t(old_idx), _t(ok)),
                 jwin.window_remap(js, jnp.asarray(old_idx), jnp.asarray(ok)))
    _same_window(twin.window_reset(ts), jwin.window_reset(js))


def _check_window_ba(jout, tout):
    """run_window_ba's outputs: poses to 1e-4 (cam->world), the accept
    flags and integer counts exact, costs rtol 1e-4 (1e-3 for the
    held-out cost), the map's validity exact and positions to 1e-3 of
    depth."""
    (jp, jok, jinfo), (tp, tok, tinfo) = jout[:3], tout[:3]
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert set(tinfo) == set(jinfo)
    for k in ("ba_ran", "ba_landmarks", "ba_accepted", "ba_holdout_n",
              "ba_reused"):
        if k in jinfo:
            assert int(tinfo[k]) == int(jinfo[k]), k
    for k in ("ba_cost0", "ba_cost"):
        np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]),
                                   rtol=1e-4, err_msg=k)
    # the held-out landmarks' cost re-triangulates them under each set of
    # poses (a Jacobi nullspace of near-parallel rays): rtol 1e-3
    # (measured 4.6e-4); the accept decision it feeds is exact above
    for k in ("ba_holdout_cost0", "ba_holdout_cost"):
        np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]),
                                   rtol=1e-3, err_msg=k)
    if len(jout) == 4:
        (jX, jm), (tX, tm) = jout[3], tout[3]
        jm, jX = np.asarray(jm), np.asarray(jX)
        np.testing.assert_array_equal(tm.numpy(), jm)
        gap = np.abs(tX.numpy() - jX).max(1)[jm]
        assert (gap <= 1e-3 * np.abs(jX[jm, 2])).all()


@pytest.mark.parametrize("use_map", [False, True])
def test_run_window_ba(use_map):
    """A full window: BA runs and accepts its poses. With a map: first
    from an empty map, then again from the map that solve left, which
    anchors most landmarks (reused > 0)."""
    js, ts, K, W = _windows()
    cfg = jwin.WindowConfig(window_size=W, min_landmarks=10)
    tcfg = twin.WindowConfig(window_size=W, min_landmarks=10)
    if not use_map:
        jout = jwin.run_window_ba(js, jnp.asarray(K), cfg)
        tout = twin.run_window_ba(ts, _t(K), tcfg)
        _check_window_ba(jout, tout)
        assert bool(tout[2]["ba_ran"]) and int(tout[2]["ba_accepted"]) > 0
        return
    lmap = (np.zeros((L, 3), np.float32), np.zeros(L, bool))
    for _ in range(2):
        jout = jwin.run_window_ba(js, jnp.asarray(K), cfg,
                                  lmap=tuple(map(jnp.asarray, lmap)))
        tout = twin.run_window_ba(ts, _t(K), tcfg, lmap=tuple(map(_t, lmap)))
        _check_window_ba(jout, tout)
        assert bool(tout[2]["ba_ran"]) and int(tout[2]["ba_accepted"]) > 0
        lmap = tuple(np.asarray(a) for a in jout[3])
    assert int(tout[2]["ba_reused"]) > 0


@pytest.mark.parametrize("why", ["window not full", "too few landmarks"])
def test_run_window_ba_gated_off(why):
    """A window that must not be solved: nothing runs, the poses and the
    map stay as they are, in both packages."""
    js, ts, K, W = _windows(count=W_FULL - 1 if why == "window not full"
                            else None)
    min_lm = 10 if why == "window not full" else 10 * L
    cfg = jwin.WindowConfig(window_size=W, min_landmarks=min_lm)
    tcfg = twin.WindowConfig(window_size=W, min_landmarks=min_lm)
    rng = np.random.default_rng(1)
    lmap = (rng.normal(size=(L, 3)).astype(np.float32), rng.random(L) > 0.5)
    jout = jwin.run_window_ba(js, jnp.asarray(K), cfg,
                              lmap=tuple(map(jnp.asarray, lmap)))
    tout = twin.run_window_ba(ts, _t(K), tcfg, lmap=tuple(map(_t, lmap)))
    _check_window_ba(jout, tout)
    assert not bool(tout[2]["ba_ran"]) and not tout[1].any()
    np.testing.assert_array_equal(tout[0].numpy(), ts.poses.numpy())
    np.testing.assert_array_equal(tout[3][0].numpy(), lmap[0])
    np.testing.assert_array_equal(tout[3][1].numpy(), lmap[1])



# --------------------------------------------------------------------- pnp


def _pnp_scene(seed, n=200):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-10, 10, n), rng.uniform(-5, 5, n),
                  rng.uniform(8, 40, n)], 1).astype(np.float32)
    K = np.array([[700.0, 0, 320.0], [0, 700.0, 240.0], [0, 0, 1.0]],
                 np.float32)

    def se3(aa, t):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = texp(torch.tensor(aa, dtype=torch.float32)).numpy()
        T[:3, 3] = t
        return T

    T_true = se3([0.02, -0.03, 0.01], [0.3, -0.1, 0.5])
    p = X @ T_true[:3, :3].T + T_true[:3, 3]
    obs = (p[:, :2] / p[:, 2:] * 700.0 + [320.0, 240.0]
           + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    obs[:10] += 40.0  # outliers: the Huber weights
    return X, obs, K, T_true, se3([0.05, 0.0, -0.02], [0.0, 0.2, 0.0])


@pytest.mark.parametrize("n_valid", [200, 150, 5])
def test_pnp_refine(n_valid):
    """Against vo_tpu's pnp_refine, from a start off by 3 deg and 0.6 m;
    5 valid landmarks are too few to trust (ok False in both)."""
    X, obs, K, T_true, T_init = _pnp_scene(3)
    valid = np.zeros(len(X), bool)
    valid[:n_valid] = True
    ref = jpnp.pnp_refine(*(jnp.asarray(a) for a in (X, obs, valid, K,
                                                     T_init)))
    got = tpnp.pnp_refine(*(_t(a) for a in (X, obs, valid, K, T_init)))
    np.testing.assert_allclose(got.pose6.numpy(), np.asarray(ref.pose6),
                               atol=1e-4)
    assert int(got.n_inliers) == int(ref.n_inliers)
    assert bool(got.ok) == bool(ref.ok) == (n_valid >= 30)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-3)
    if n_valid >= 30:
        R = texp(got.pose6[:3]).numpy()
        assert np.abs(got.pose6[3:].numpy() - T_true[:3, 3]).max() < 0.02
        assert np.abs(R - T_true[:3, :3]).max() < 1e-3


# ------------------------------------------------------------------ state


def test_tracking_ba_state_round_trip():
    """A BA pipeline state, written as vo_tpu's TrackingBAState of numpy
    leaves (bf16 pyramid levels included), survives the trip into the
    port and back unchanged (the key and the stored window stacks
    aside)."""
    seq = SyntheticSequence.generate(n_frames=2, shape=(240, 320))
    vo = PRESETS["tracking_orb_ba"].build(seq.K, device="cpu")
    st = state_to_numpy(vo.init(seq.frame(0)))
    import ml_dtypes

    pyr = tuple(p.astype(ml_dtypes.bfloat16) if i else p
                for i, p in enumerate(st.pyramid))
    jw = jwin.WindowState(*st.window)
    ref = jvo_ba.TrackingBAState(
        pyramid=pyr, lk_cache=JLKCache(wins=(), origins=st.lk_cache.origins),
        pts=st.pts, pts_valid=st.pts_valid, prev3d=st.prev3d,
        prev3d_valid=st.prev3d_valid, pose=st.pose, window=jw,
        map_X=st.map_X, map_ok=st.map_ok, frame_idx=st.frame_idx,
        key=np.zeros(2, np.uint32), dipped=st.dipped)
    back = state_to_numpy(tracking_ba_state_from_numpy(ref, "cpu"))
    back = back._replace(gen=(), lk_cache=back.lk_cache.origins)
    ref = ref._replace(key=(), lk_cache=ref.lk_cache.origins)
    got, want = _leaves(back), _leaves(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
