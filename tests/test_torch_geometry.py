"""Parity of the port's geometry (vo_tpu_torch.geometry) with vo_tpu's.

Inputs come from a numpy seed and pass between the two as numpy arrays;
RANSAC gets the reference's own minimal-sample draws (jax.random cannot be
reproduced in torch), so both score the same hypotheses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.geometry import epipolar as jep
from vo_tpu.geometry import fivepoint as jfp
from vo_tpu.geometry import linalg3 as jla
from vo_tpu.geometry import scale as jsc
from vo_tpu.geometry.triangulate import triangulate_depths as j_depths
from vo_tpu_torch.geometry import epipolar as tep
from vo_tpu_torch.geometry import fivepoint as tfp
from vo_tpu_torch.geometry import linalg3 as tla
from vo_tpu_torch.geometry import scale as tsc
from vo_tpu_torch.geometry.se3 import exp_so3, inv_se3, log_so3, make_se3
from vo_tpu_torch.geometry.triangulate import triangulate_depths as t_depths
from torch_parity import low_cpu_priority  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("low_cpu_priority")


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(seed, n=400, outliers=0.2, noise=0.5 / 700.0):
    """Normalized correspondences of a random cloud seen from two poses
    (x2 = R x1 + t), with pixel-scale noise, outliers and invalid slots."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-8, 8, n), rng.uniform(-3, 3, n),
                  rng.uniform(6, 40, n)], 1)
    w = rng.normal(size=3) * 0.05
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    t = np.array([0.1, -0.05, -1.0])
    t = t / np.linalg.norm(t)
    X2 = X @ R.T + t
    p1 = X[:, :2] / X[:, 2:] + rng.normal(0, noise, (n, 2))
    p2 = X2[:, :2] / X2[:, 2:] + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    p2[bad] += rng.normal(0, 0.05, (bad.sum(), 2))
    valid = rng.random(n) > 0.1
    return (p1.astype(np.float32), p2.astype(np.float32), valid, R, t)


def _ref_slots(key, valid, n_iters):
    n_valid = max(int(valid.sum()), 5)
    return np.asarray(jax.random.randint(key, (n_iters, 5), 0, n_valid))


# Float32 sums are taken in other orders by XLA and torch; the tolerances
# below bound that rounding (relative ~1e-6 per op, amplified by the
# eigen/root solvers), not algorithmic differences.
def test_linalg3_matches():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(64, 3, 3)).astype(np.float32)
    S = M @ M.transpose(0, 2, 1)
    wj, _ = jla.eigh3x3(jnp.asarray(S))
    wt, Vt = tla.eigh3x3(_t(S))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-4, atol=1e-4)
    # eigenvectors: S V = V diag(w), orthonormal
    SV = _t(S) @ Vt
    np.testing.assert_allclose(SV.numpy(), (Vt * wt[:, None, :]).numpy(),
                               atol=2e-3)
    U, s, Vh = tla.svd3x3(_t(M))
    Uj, sj, Vhj = jla.svd3x3(jnp.asarray(M))
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((U * s[:, None, :] @ Vh).numpy(), M, atol=1e-4)
    np.testing.assert_allclose(tla.inv3x3(_t(M)).numpy(),
                               np.asarray(jla.inv3x3(jnp.asarray(M))),
                               rtol=1e-4, atol=1e-4)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tla.solve3x3(_t(M), _t(b)).numpy(),
        np.asarray(jla.solve3x3(jnp.asarray(M), jnp.asarray(b))),
        rtol=1e-3, atol=1e-3,
    )
    A = rng.normal(size=(16, 10, 10)).astype(np.float32)
    Bm = rng.normal(size=(16, 10, 4)).astype(np.float32)
    Xt, okt = tla.gauss_jordan_solve(_t(A), _t(Bm))
    Xj, okj = jla.gauss_jordan_solve(jnp.asarray(A), jnp.asarray(Bm))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-3, atol=1e-3)
    A9 = rng.normal(size=(32, 5, 9)).astype(np.float32)
    nt = tla.null_basis_jacobi(_t(A9), 4)
    nj = jla.null_basis_jacobi(jnp.asarray(A9), 4)
    # same subspace: projector onto the 4-dim basis agrees
    Pt = nt.transpose(1, 2) @ nt
    Pj = np.asarray(nj).transpose(0, 2, 1) @ np.asarray(nj)
    np.testing.assert_allclose(Pt.numpy(), Pj, atol=1e-4)


def test_fivepoint_matches():
    p1, p2, _, R, t = _scene(1, n=200, outliers=0.0, noise=0.0)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E_true = tx @ R
    E_true /= np.linalg.norm(E_true)
    rng = np.random.default_rng(3)
    idx = np.stack([rng.choice(200, 5, replace=False) for _ in range(48)])
    Ej, okj = jfp.five_point_essential(jnp.asarray(p1[idx]),
                                       jnp.asarray(p2[idx]))
    Et, okt = tfp.five_point_essential(_t(p1[idx]), _t(p2[idx]))

    def err_to_truth(E, ok):
        d = np.minimum(np.abs(E - E_true).max(axis=(-1, -2)),
                       np.abs(E + E_true).max(axis=(-1, -2)))
        return np.where(ok, d, np.inf).min(axis=1)

    # The 4-dim nullspace is exact, so the basis orientation inside it
    # follows float rounding: the two solvers parametrize the problem
    # differently, and the f32 root polishing of either lands near the
    # generating E for only part of the samples (LO-RANSAC's refits
    # recover the rest). What must agree is that accuracy: per sample,
    # the candidate nearest the generating E is as often as close in the
    # port as in vo_tpu.
    dj = err_to_truth(np.asarray(Ej), np.asarray(okj))
    dt = err_to_truth(Et.numpy(), okt.numpy())
    for tol in (0.01, 0.05, 0.2):
        assert (dt < tol).mean() >= (dj < tol).mean() - 0.1, tol
    # every port candidate satisfies its own 5 epipolar constraints
    Et, okt = Et.numpy(), okt.numpy()
    res = np.einsum("sni,skij,snj->skn",
                    np.concatenate([p2[idx], np.ones((48, 5, 1))], -1),
                    Et,
                    np.concatenate([p1[idx], np.ones((48, 5, 1))], -1))
    assert np.median(np.abs(res)[okt]) < 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_and_recover_pose_match(seed):
    p1, p2, valid, R, t = _scene(seed)
    thr = 1.0 / 700.0
    key = jax.random.PRNGKey(seed)
    rj = jep.ransac_essential(key, jnp.asarray(p1), jnp.asarray(p2),
                              jnp.asarray(valid), threshold=thr, n_iters=128)
    slot = _ref_slots(key, valid, 128)
    rt = tep.ransac_essential(_t(p1), _t(p2), _t(valid), threshold=thr,
                              n_iters=128, slot=_t(slot))
    # The same draws score different f32 candidate sets (see
    # test_fivepoint_matches), so the consensus may differ on points near
    # the 1 px threshold: the inlier sets agree on nearly every point and
    # the poses agree to well inside the noise.
    inl_j, inl_t = np.asarray(rj.inliers), rt.inliers.numpy()
    assert (inl_j == inl_t).mean() > 0.9
    assert abs(int(rj.n_inliers) - int(rt.n_inliers)) <= 0.05 * inl_j.sum()
    pj = jep.recover_pose(rj.E, jnp.asarray(p1), jnp.asarray(p2), rj.inliers)
    pt = tep.recover_pose(rt.E, _t(p1), _t(p2), rt.inliers)
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=3e-3)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=2e-2)
    # and both recover the generating motion
    np.testing.assert_allclose(pt.R.numpy(), R, atol=5e-3)
    assert np.dot(pt.t.numpy(), t) > 0.99


def test_recover_pose_same_E():
    p1, p2, valid, _, _ = _scene(4, outliers=0.0)
    E = jep.fit_essential_ls(jnp.asarray(p1), jnp.asarray(p2),
                             jnp.asarray(valid, jnp.float32))
    Et = tep.fit_essential_ls(_t(p1), _t(p2), _t(valid).float())
    d = min(np.abs(np.asarray(E) - Et.numpy()).max(),
            np.abs(np.asarray(E) + Et.numpy()).max())
    assert d < 1e-3
    pj = jep.recover_pose(E, jnp.asarray(p1), jnp.asarray(p2),
                          jnp.asarray(valid))
    pt = tep.recover_pose(_t(np.asarray(E)), _t(p1), _t(p2), _t(valid))
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=1e-5)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=1e-5)
    np.testing.assert_array_equal(pt.mask.numpy(), np.asarray(pj.mask))
    s_j = jep.sampson_sq(E, jnp.asarray(p1), jnp.asarray(p2))
    s_t = tep.sampson_sq(_t(np.asarray(E)), _t(p1), _t(p2))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4,
                               atol=1e-12)


def test_depths_and_scale_match():
    p1, p2, valid, R, t = _scene(5, outliers=0.0)
    R32, t32 = R.astype(np.float32), t.astype(np.float32)
    z1j, z2j = j_depths(jnp.asarray(R32), jnp.asarray(t32), jnp.asarray(p1),
                        jnp.asarray(p2))
    z1t, z2t = t_depths(_t(R32), _t(t32), _t(p1), _t(p2))
    # points near the epipole have near-parallel rays (2x2 determinant
    # ~1e-7) whose f32 depths are rounding noise in both; compare the
    # well-conditioned ones, picked by the float64 determinant
    x1 = np.c_[p1, np.ones(len(p1))].astype(np.float64) @ R32.T
    x2 = np.c_[p2, np.ones(len(p2))].astype(np.float64)
    det = (x1 * x1).sum(1) * (x2 * x2).sum(1) - (x1 * x2).sum(1) ** 2
    good = det > 1e-4
    assert good.sum() > 100
    # (f32 rounding relative to a determinant >= 1e-4: up to ~2e-3)
    np.testing.assert_allclose(z1t.numpy()[good], np.asarray(z1j)[good],
                               rtol=5e-3)
    np.testing.assert_allclose(z2t.numpy()[good], np.asarray(z2j)[good],
                               rtol=5e-3)

    rng = np.random.default_rng(6)
    n = 300
    prev = rng.normal(size=(n, 3)).astype(np.float32) * 5
    cur = (prev * 0.8 + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    v = rng.random(n) > 0.3
    sj = float(jsc.relative_scale_matched(jnp.asarray(prev), jnp.asarray(cur),
                                          jnp.asarray(v)))
    st = float(tsc.relative_scale_matched(_t(prev), _t(cur), _t(v)))
    assert abs(sj - st) < 1e-5 * abs(sj)
    x = rng.normal(size=n).astype(np.float32)
    assert float(tsc.masked_median(_t(x), _t(v))) == float(
        jsc.masked_median(jnp.asarray(x), jnp.asarray(v)))
    pc, vc = tsc.compact_valid(_t(prev), _t(v))
    pj, vj = jsc.compact_valid(jnp.asarray(prev), jnp.asarray(v))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(tsc._scatter_perm(n, torch.device("cpu")),
                                  np.asarray(jsc._scatter_perm(n)))


def test_se3_roundtrip():
    rng = np.random.default_rng(8)
    w = _t(rng.normal(size=(10, 3)).astype(np.float32) * 0.4)
    R = exp_so3(w)
    np.testing.assert_allclose(log_so3(R).numpy(), w.numpy(), atol=1e-5)
    T = make_se3(R, _t(rng.normal(size=(10, 3)).astype(np.float32)))
    eye = (T @ inv_se3(T)).numpy()
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape),
                               atol=1e-5)
