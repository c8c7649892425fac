"""Closed-form batched 3x3 linear algebra and small Jacobi solvers (port
of vo_tpu/geometry/linalg3.py): thousands of tiny systems as batched
elementwise arithmetic, the same algorithms as the reference.
"""

from __future__ import annotations

import functools

import torch


def det3x3(M: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) determinant by cofactor expansion."""
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def inv3x3(M: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """(..., 3, 3) inverse via the adjugate; `eps` guards the determinant."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    if eps:
        det = torch.where(det.abs() > eps, det,
                          torch.where(det >= 0, eps, -eps).to(det.dtype))
    adj = torch.stack(
        [torch.stack([A, D, G], -1), torch.stack([B, E, H], -1),
         torch.stack([C, F, I], -1)],
        -2,
    )
    return adj * (1.0 / det)[..., None, None]


def solve3x3(M: torch.Tensor, b: torch.Tensor, eps: float = 0.0
             ) -> torch.Tensor:
    """Solve (..., 3, 3) @ x = (..., 3) in closed form."""
    return torch.einsum("...ij,...j->...i", inv3x3(M, eps), b)


def eigh3x3(S: torch.Tensor):
    """Closed-form symmetric (..., 3, 3) eigendecomposition (trigonometric
    eigenvalues, cross-product eigenvectors with largest-pivot selection,
    re-orthogonalized). Returns (w ascending, V with eigenvector columns)."""
    dt, dev = S.dtype, S.device
    q = S.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    I = torch.eye(3, dtype=dt, device=dev)
    Sq = S - q[..., None, None] * I
    p2 = (Sq * Sq).sum(dim=(-2, -1))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    B = Sq / p[..., None, None]
    phi = torch.arccos(torch.clamp(det3x3(B) / 2.0, -1.0, 1.0)) / 3.0
    w2 = q + 2.0 * p * torch.cos(phi)
    w0 = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    w1 = 3.0 * q - w0 - w2

    def unit(k):
        e = torch.zeros(S.shape[:-2] + (3,), dtype=dt, device=dev)
        e[..., k] = 1.0
        return e

    def eigvec(w):
        M = S - w[..., None, None] * I
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        cs = torch.stack([_cross(r0, r1), _cross(r1, r2), _cross(r2, r0)], -2)
        best = torch.argmax((cs * cs).sum(-1), dim=-1)
        v = torch.gather(cs, -2, best[..., None, None].expand(
            best.shape + (1, 3)))[..., 0, :]
        n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return torch.where(n > 1e-20, v / torch.clamp(n, min=1e-30), unit(0))

    v0 = eigvec(w0)
    v2 = eigvec(w2)
    v2 = v2 - (v2 * v0).sum(-1, keepdim=True) * v0
    n2 = torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    alt = _cross(v0, unit(1))
    alt2 = _cross(v0, unit(2))
    alt = torch.where(
        torch.linalg.vector_norm(alt, dim=-1, keepdim=True) > 0.1, alt, alt2
    )
    alt_n = torch.clamp(torch.linalg.vector_norm(alt, dim=-1, keepdim=True),
                        min=1e-30)
    v2 = torch.where(n2 > 1e-20, v2 / torch.clamp(n2, min=1e-30), alt / alt_n)
    v1 = _cross(v2, v0)
    return torch.stack([w0, w1, w2], -1), torch.stack([v0, v1, v2], -1)


def svd3x3(M: torch.Tensor):
    """Closed-form (..., 3, 3) SVD via eigh3x3(M^T M). Returns (U, s, Vt)
    with s descending; rank-2 inputs are handled exactly."""
    MtM = torch.einsum("...ji,...jk->...ik", M, M)
    w, V = eigh3x3(MtM)
    s = torch.sqrt(torch.clamp(torch.flip(w, [-1]), min=0.0))
    V = torch.flip(V, [-1])
    u0 = torch.einsum("...ij,...j->...i", M, V[..., 0])
    u1 = torch.einsum("...ij,...j->...i", M, V[..., 1])
    u0 = u0 / torch.clamp(torch.linalg.vector_norm(u0, dim=-1, keepdim=True),
                          min=1e-30)
    u1 = u1 - (u1 * u0).sum(-1, keepdim=True) * u0
    u1 = u1 / torch.clamp(torch.linalg.vector_norm(u1, dim=-1, keepdim=True),
                          min=1e-30)
    u2 = _cross(u0, u1)
    mv2 = torch.einsum("...ij,...j->...i", M, V[..., 2])
    flip = torch.where((mv2 * u2).sum(-1) < 0.0, -1.0, 1.0).to(M.dtype)
    U = torch.stack([u0, u1, u2 * flip[..., None]], -1)
    return U, s, V.transpose(-1, -2)


@functools.lru_cache(maxsize=None)
def _round_pairs(k: int) -> tuple:
    """Round-robin (circle method) pair schedule: every unordered pair of
    the k columns meets once per sweep, disjoint pairs per round."""
    ke = k + (k % 2)
    circle = list(range(ke))
    rounds = []
    for _ in range(ke - 1):
        pair = [
            (min(circle[i], circle[ke - 1 - i]),
             max(circle[i], circle[ke - 1 - i]))
            for i in range(ke // 2)
        ]
        prs = [(p, q) for p, q in pair if q < k]
        rounds.append(([p for p, _ in prs], [q for _, q in prs]))
        circle = [circle[0]] + [circle[-1]] + circle[1:-1]
    return tuple(rounds)


@functools.lru_cache(maxsize=None)
def _round_index(k: int, device: torch.device) -> tuple:
    return tuple(
        (torch.tensor(ip, device=device), torch.tensor(iq, device=device))
        for ip, iq in _round_pairs(k)
    )


def _jacobi_sweeps(A: torch.Tensor, sweeps: int):
    """One-sided Jacobi: (B, V) with B = A @ V and the columns of B
    orthogonal after `sweeps` round-robin sweeps."""
    k = A.shape[-1]
    V = torch.eye(k, dtype=A.dtype, device=A.device).expand(
        A.shape[:-2] + (k, k)).clone()
    B = A.clone()
    rounds = _round_index(k, A.device)
    for _ in range(sweeps):
        for ip, iq in rounds:
            Bp, Bq = B[..., ip], B[..., iq]
            gpp = (Bp * Bp).sum(-2)
            gqq = (Bq * Bq).sum(-2)
            gpq = (Bp * Bq).sum(-2)
            th = 0.5 * torch.atan2(2.0 * gpq, gqq - gpp)
            c = torch.cos(th)[..., None, :]
            s = torch.sin(th)[..., None, :]
            B[..., ip] = c * Bp - s * Bq
            B[..., iq] = s * Bp + c * Bq
            Vp, Vq = V[..., ip], V[..., iq]
            V[..., ip] = c * Vp - s * Vq
            V[..., iq] = s * Vp + c * Vq
    return B, V


def nullspace_jacobi(A: torch.Tensor, sweeps: int = 8) -> torch.Tensor:
    """(..., m, k) -> (..., k) right-singular vector of the smallest
    singular value, via one-sided Jacobi on A directly."""
    B, V = _jacobi_sweeps(A, sweeps)
    i = torch.argmin((B * B).sum(-2), dim=-1)
    k = V.shape[-1]
    return torch.gather(V, -1, i[..., None, None].expand(
        i.shape + (k, 1)))[..., 0]


def null_basis_jacobi(A: torch.Tensor, nb: int, sweeps: int = 8
                      ) -> torch.Tensor:
    """(..., m, k) -> (..., nb, k) orthonormal right-singular vectors of the
    nb smallest singular values, largest of those first (the LAPACK Vt
    tail order)."""
    B, V = _jacobi_sweeps(A, sweeps)
    sv2 = (B * B).sum(-2)
    # nb smallest with ties in index order (lax.top_k of -sv2), then
    # reversed so the largest of them comes first
    idx = torch.sort(-sv2, dim=-1, descending=True, stable=True).indices
    idx = torch.flip(idx[..., :nb], [-1])
    Vt = V.transpose(-1, -2)
    k = V.shape[-1]
    return torch.gather(Vt, -2, idx[..., :, None].expand(idx.shape + (k,)))


def gauss_jordan_solve(A: torch.Tensor, B: torch.Tensor, eps: float = 1e-12):
    """Batched A @ X = B by Gauss-Jordan with partial pivoting:
    (..., n, n), (..., n, m) -> (X, ok) with ok False where a pivot fell
    below eps."""
    n = A.shape[-1]
    M = torch.cat([A, B], dim=-1)
    idx = torch.arange(n, device=A.device)
    ok = torch.ones(A.shape[:-2], dtype=torch.bool, device=A.device)
    for kk in range(n):
        score = torch.where(idx >= kk, M[..., :, kk].abs(), -torch.inf)
        p = torch.argmax(score, dim=-1)
        prow = torch.gather(M, -2, p[..., None, None].expand(
            p.shape + (1, M.shape[-1])))
        piv = prow[..., 0, kk]
        good = piv.abs() > eps
        ok = ok & good
        prow = prow / torch.where(good, piv, torch.ones_like(piv))[..., None, None]
        is_k = idx == kk
        is_p = idx == p[..., None]
        M = torch.where((is_p & ~is_k)[..., None], M[..., kk:kk + 1, :], M)
        M = torch.where(is_k[:, None], prow, M)
        f = torch.where(is_k, torch.zeros_like(M[..., :, kk]), M[..., :, kk])
        M = M - f[..., None] * prow
    return M[..., :, n:], ok
