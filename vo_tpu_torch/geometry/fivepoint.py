"""Nister 5-point minimal essential-matrix solver, batched (port of
vo_tpu/geometry/fivepoint.py).

1. 4-dim nullspace (X, Y, Z, W) of the 5x9 epipolar system by one-sided
   Jacobi; E(x, y, z) = x X + y Y + z Z + W.
2. The 10 cubic constraints, expanded over the 20 monomials of degree <= 3
   numerically: evaluated at 20 fixed sample points, times a precomputed
   (f64) inverse monomial matrix.
3. Batched Gauss-Jordan of the 10x20 system.
4. Nister's <e>, <f>, <g> rows give a 3x3 polynomial matrix B(z) whose
   degree-10 determinant must vanish.
5. Its roots by Durand-Kerner in complex64 with a fixed trip count; real
   roots kept.
6. Back-substitution gives up to 10 candidates per sample, with a mask.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .linalg3 import det3x3, gauss_jordan_solve, null_basis_jacobi

# Nister's monomial order: leading block (eliminated) x^3, y^3, x^2 y,
# x y^2, x^2 z, x^2, y^2 z, y^2, x y z, x y; trailing block (kept)
# x z^2, x z, x, y z^2, y z, y, z^3, z^2, z, 1
MONOMIALS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1), (2, 0, 0),
    (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1), (0, 1, 0),
    (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]


def _sample_points() -> np.ndarray:
    """20 fixed generic (x, y, z) evaluation points (well-conditioned)."""
    rng = np.random.default_rng(12345)
    p = rng.normal(size=(20, 3))
    p = p / np.linalg.norm(p, axis=1, keepdims=True)
    r = 0.7 + 0.6 * rng.random((20, 1))
    return p * r


_PTS = _sample_points()
_MONO_MAT = np.stack(
    [np.prod(_PTS ** np.array(m, dtype=np.float64), axis=1) for m in MONOMIALS],
    axis=1,
)  # (20 points, 20 monomials)
_MONO_INV = np.linalg.inv(_MONO_MAT)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device, dtype: torch.dtype):
    return (torch.tensor(_PTS, dtype=dtype, device=device),
            torch.tensor(_MONO_INV, dtype=dtype, device=device))


@functools.lru_cache(maxsize=None)
def _dk_start(deg: int, device: torch.device) -> torch.Tensor:
    """Durand-Kerner start: a circle of radius 1.2, angle offset 0.39."""
    ang = 2.0 * np.pi * np.arange(deg) / deg + 0.39
    return torch.complex(
        torch.tensor(1.2 * np.cos(ang), dtype=torch.float32),
        torch.tensor(1.2 * np.sin(ang), dtype=torch.float32),
    ).to(device)


def _constraints(E: torch.Tensor) -> torch.Tensor:
    """[det(E)] ++ flatten(2 E E^T E - tr(E E^T) E) for (..., 3, 3)."""
    EEt = E @ E.transpose(-1, -2)
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    C = 2.0 * (EEt @ E) - tr[..., None, None] * E
    return torch.cat([det3x3(E)[..., None], C.reshape(C.shape[:-2] + (9,))], -1)


def _constraint_coeffs(basis: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3, 3) basis (X, Y, Z, W) -> (..., 10, 20) coefficients."""
    X, Y, Z, W = (basis[..., i, :, :] for i in range(4))
    pts, minv = _consts(basis.device, basis.dtype)
    E = (
        pts[:, 0, None, None] * X[..., None, :, :]
        + pts[:, 1, None, None] * Y[..., None, :, :]
        + pts[:, 2, None, None] * Z[..., None, :, :]
        + W[..., None, :, :]
    )
    vals = _constraints(E)  # (..., 20 points, 10 constraints)
    return torch.einsum("mp,...pc->...cm", minv, vals)


def _polymul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 1-D polynomial product over the last axis."""
    la, lb = a.shape[-1], b.shape[-1]
    out = a.new_zeros(a.shape[:-1] + (la + lb - 1,))
    for i in range(la):
        out[..., i:i + lb] += a[..., i:i + 1] * b
    return out


def _pad_to(p: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(p, (0, n - p.shape[-1]))


def durand_kerner(coeffs: torch.Tensor, iters: int = 80):
    """All complex roots of batched real polynomials (ascending coeffs,
    degree = coeffs.shape[-1] - 1): fixed-iteration Durand-Kerner in
    complex64 after a Cauchy-bound rescale. Returns (re, im, ok)."""
    deg = coeffs.shape[-1] - 1
    lead = coeffs[..., -1:]
    ok = lead[..., 0].abs() > 1e-12
    monic = coeffs / torch.where(lead.abs() > 1e-12, lead,
                                 torch.ones_like(lead))
    mags = torch.stack(
        [monic[..., k].abs() ** (1.0 / (deg - k)) for k in range(deg)], -1
    )
    s = torch.clamp(mags.max(dim=-1).values, min=1e-6)
    powers = s[..., None] ** torch.arange(deg + 1, device=coeffs.device)
    b = (monic * powers / (s[..., None] ** deg)).to(torch.complex64)

    x = _dk_start(deg, coeffs.device).expand(b.shape[:-1] + (deg,)).clone()
    eye = torch.eye(deg, dtype=torch.complex64, device=coeffs.device)
    for _ in range(iters):
        p = torch.ones_like(x)
        for k in range(deg - 1, -1, -1):
            p = p * x + b[..., k:k + 1]
        d = x[..., :, None] - x[..., None, :] + eye  # diagonal -> 1
        q = torch.ones_like(x)
        for j in range(deg):
            q = q * d[..., j]
        q2 = torch.clamp(q.real * q.real + q.imag * q.imag, min=1e-20)
        x = x - p * q.conj() / q2
    return x.real * s[..., None], x.imag * s[..., None], ok


def five_point_essential(pts1: torch.Tensor, pts2: torch.Tensor):
    """Minimal 5-point solve, batched over leading dims: (..., 5, 2)
    normalized correspondences -> (E (..., 10, 3, 3), valid (..., 10))."""
    from .epipolar import _epipolar_rows

    A = _epipolar_rows(pts1, pts2)  # (..., 5, 9)
    basis9 = null_basis_jacobi(A, 4)  # (..., 4, 9)
    basis = basis9.reshape(basis9.shape[:-2] + (4, 3, 3))
    coeffs = _constraint_coeffs(basis)  # (..., 10, 20)
    B, gj_ok = gauss_jordan_solve(coeffs[..., :, :10], coeffs[..., :, 10:])
    gj_ok = gj_ok & torch.isfinite(B).all(dim=-1).all(dim=-1)

    def efg_row(rz, r1):
        """Ascending z-power coefficients of (z*r1 - rz) per trailing
        monomial group: x terms, y terms, constant terms."""
        def col(j0, degs):
            out = rz.new_zeros(rz.shape[:-1] + (max(degs) + 2,))
            for k, d in enumerate(degs):
                out[..., d] -= rz[..., j0 + k]
                out[..., d + 1] += r1[..., j0 + k]
            return out

        return col(0, [2, 1, 0]), col(3, [2, 1, 0]), col(6, [3, 2, 1, 0])

    e = efg_row(B[..., 4, :], B[..., 5, :])
    f = efg_row(B[..., 6, :], B[..., 7, :])
    g = efg_row(B[..., 8, :], B[..., 9, :])

    def det3(r0, r1, r2):
        t = [
            _polymul(r0[0], _polymul(r1[1], r2[2])),
            _polymul(r0[0], _polymul(r1[2], r2[1])),
            _polymul(r0[1], _polymul(r1[0], r2[2])),
            _polymul(r0[1], _polymul(r1[2], r2[0])),
            _polymul(r0[2], _polymul(r1[0], r2[1])),
            _polymul(r0[2], _polymul(r1[1], r2[0])),
        ]
        t = [_pad_to(x, 11) for x in t]
        return t[0] - t[1] - t[2] + t[3] + t[4] - t[5]

    poly = det3(e, f, g)  # (..., 11)
    z, z_im, dk_ok = durand_kerner(poly)
    real = z_im.abs() < 1e-3 * (1.0 + z.abs())

    def poly_at(p, zv):
        n = p.shape[-1]
        zp = zv[..., None] ** torch.arange(n, device=zv.device)
        return (zp * p[..., None, :]).sum(-1)

    ex, ey, e1 = (poly_at(p, z) for p in e)
    fx, fy, f1 = (poly_at(p, z) for p in f)
    det2 = ex * fy - ey * fx
    safe = det2.abs() > 1e-12
    inv = 1.0 / torch.where(safe, det2, torch.ones_like(det2))
    x = (-e1 * fy + ey * f1) * inv
    y = (-ex * f1 + e1 * fx) * inv

    X, Y, Z, W = (basis[..., i, :, :] for i in range(4))
    E = (
        x[..., None, None] * X[..., None, :, :]
        + y[..., None, None] * Y[..., None, :, :]
        + z[..., None, None] * Z[..., None, :, :]
        + W[..., None, :, :]
    )
    norm = torch.linalg.matrix_norm(E, keepdim=True)
    E = E / torch.clamp(norm, min=1e-12)
    valid = real & safe & gj_ok[..., None] & dk_ok[..., None]
    valid = valid & torch.isfinite(E).all(dim=-1).all(dim=-1)
    return E, valid
