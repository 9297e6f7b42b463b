"""SoA ("planes") 3x3 / vec3 math on torch tensors.

Port of gsmpm_tpu/ops/m33.py.  A 3x3 matrix batch is a tuple of nine (N,)
planes (row-major: m00,m01,m02,m10,...) and a vec3 batch is a tuple of three
(N,) planes; every operation is an elementwise formula, so the stress and
postprocess code reads the same as the JAX package and rounds the same way.
"""

from __future__ import annotations

from typing import Tuple

import torch

Mat = Tuple  # 9 planes, row-major
Vec = Tuple  # 3 planes

_EPS = 1e-12


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def from_aos(A: torch.Tensor) -> Mat:
    """(N,3,3) -> 9 planes."""
    return tuple(A[..., i, j] for i in range(3) for j in range(3))


def to_aos(M: Mat) -> torch.Tensor:
    """9 planes -> (N,3,3)."""
    rows = [torch.stack(M[3 * i: 3 * i + 3], dim=-1) for i in range(3)]
    return torch.stack(rows, dim=-2)


def vec_from_aos(v: torch.Tensor) -> Vec:
    return tuple(v[..., i] for i in range(3))


def vec_to_aos(v: Vec) -> torch.Tensor:
    return torch.stack(v, dim=-1)


def from_upper6(u: Tuple) -> Mat:
    """6 symmetric planes [xx,xy,xz,yy,yz,zz] -> 9 planes."""
    xx, xy, xz, yy, yz, zz = u
    return (xx, xy, xz, xy, yy, yz, xz, yz, zz)


def to_upper6(M: Mat) -> Tuple:
    return (M[0], M[1], M[2], M[4], M[5], M[8])


def identity_like(x: torch.Tensor) -> Mat:
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    return (one, zero, zero, zero, one, zero, zero, zero, one)


# ---------------------------------------------------------------------------
# algebra
# ---------------------------------------------------------------------------

def transpose(M: Mat) -> Mat:
    return (M[0], M[3], M[6], M[1], M[4], M[7], M[2], M[5], M[8])


def matmul(A: Mat, B: Mat) -> Mat:
    return tuple(
        sum(A[3 * i + k] * B[3 * k + j] for k in range(3))
        for i in range(3)
        for j in range(3)
    )


def matmul_t(A: Mat, B: Mat) -> Mat:
    """A @ B^T."""
    return tuple(
        sum(A[3 * i + k] * B[3 * j + k] for k in range(3))
        for i in range(3)
        for j in range(3)
    )


def t_matmul(A: Mat, B: Mat) -> Mat:
    """A^T @ B."""
    return tuple(
        sum(A[3 * k + i] * B[3 * k + j] for k in range(3))
        for i in range(3)
        for j in range(3)
    )


def matvec(A: Mat, v: Vec) -> Vec:
    return tuple(sum(A[3 * i + k] * v[k] for k in range(3)) for i in range(3))


def add(A: Mat, B: Mat) -> Mat:
    return tuple(a + b for a, b in zip(A, B))


def sub(A: Mat, B: Mat) -> Mat:
    return tuple(a - b for a, b in zip(A, B))


def scale(A: Mat, s) -> Mat:
    return tuple(a * s for a in A)


def add_scaled_identity(A: Mat, s) -> Mat:
    return (A[0] + s, A[1], A[2], A[3], A[4] + s, A[5], A[6], A[7], A[8] + s)


def diag(d: Vec) -> Mat:
    z = torch.zeros_like(d[0])
    return (d[0], z, z, z, d[1], z, z, z, d[2])


def trace(A: Mat):
    return A[0] + A[4] + A[8]


def det(A: Mat):
    return (
        A[0] * (A[4] * A[8] - A[5] * A[7])
        - A[1] * (A[3] * A[8] - A[5] * A[6])
        + A[2] * (A[3] * A[7] - A[4] * A[6])
    )


def symmetrize(A: Mat) -> Mat:
    m01 = 0.5 * (A[1] + A[3])
    m02 = 0.5 * (A[2] + A[6])
    m12 = 0.5 * (A[5] + A[7])
    return (A[0], m01, m02, m01, A[4], m12, m02, m12, A[8])


def mul_diag_right(A: Mat, d: Vec) -> Mat:
    """A @ diag(d)."""
    return (
        A[0] * d[0], A[1] * d[1], A[2] * d[2],
        A[3] * d[0], A[4] * d[1], A[5] * d[2],
        A[6] * d[0], A[7] * d[1], A[8] * d[2],
    )


def outer(u: Vec, v: Vec) -> Mat:
    return tuple(u[i] * v[j] for i in range(3) for j in range(3))


def col(M: Mat, j: int) -> Vec:
    return (M[j], M[3 + j], M[6 + j])


def with_col(M: Mat, j: int, v: Vec) -> Mat:
    M = list(M)
    M[j], M[3 + j], M[6 + j] = v
    return tuple(M)


def vdot(u: Vec, v: Vec):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def vnorm(u: Vec):
    return torch.sqrt(vdot(u, u))


def vcross(u: Vec, v: Vec) -> Vec:
    return (
        u[1] * v[2] - u[2] * v[1],
        u[2] * v[0] - u[0] * v[2],
        u[0] * v[1] - u[1] * v[0],
    )


def vadd(u: Vec, v: Vec) -> Vec:
    return tuple(a + b for a, b in zip(u, v))


def vsub(u: Vec, v: Vec) -> Vec:
    return tuple(a - b for a, b in zip(u, v))


def vscale(u: Vec, s) -> Vec:
    return tuple(a * s for a in u)


def vwhere(c, u: Vec, v: Vec) -> Vec:
    return tuple(torch.where(c, a, b) for a, b in zip(u, v))


def mwhere(c, A: Mat, B: Mat) -> Mat:
    return tuple(torch.where(c, a, b) for a, b in zip(A, B))


# ---------------------------------------------------------------------------
# SVD via cyclic Jacobi on A^T A (planes form of ops/svd3.py:svd3x3)
# ---------------------------------------------------------------------------

def _jacobi_sym(s00, s01, s02, s11, s12, s22, V: Mat, p: int, q: int):
    """One Jacobi rotation zeroing S[p,q] of a symmetric S; updates V = V @ J."""
    S = {
        (0, 0): s00, (0, 1): s01, (0, 2): s02,
        (1, 1): s11, (1, 2): s12, (2, 2): s22,
    }

    def get(i, j):
        return S[(i, j)] if (i, j) in S else S[(j, i)]

    app, aqq, apq = get(p, p), get(q, q), get(p, q)
    small = torch.abs(apq) < _EPS
    tau = (aqq - app) / (2.0 * torch.where(small, torch.ones_like(apq), apq))
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c

    r = 3 - p - q  # the untouched index
    arp, arq = get(r, p), get(r, q)
    new_pp = app - t * apq
    new_qq = aqq + t * apq
    new_rp = c * arp - s * arq
    new_rq = s * arp + c * arq

    def put(d, i, j, v):
        if (i, j) in S:
            d[(i, j)] = v
        else:
            d[(j, i)] = v

    out = dict(S)
    put(out, p, p, new_pp)
    put(out, q, q, new_qq)
    put(out, p, q, torch.zeros_like(apq))
    put(out, r, p, new_rp)
    put(out, r, q, new_rq)

    vp, vq = col(V, p), col(V, q)
    V = with_col(V, p, vsub(vscale(vp, c), vscale(vq, s)))
    V = with_col(V, q, vadd(vscale(vp, s), vscale(vq, c)))
    return (
        out[(0, 0)], out[(0, 1)], out[(0, 2)],
        out[(1, 1)], out[(1, 2)], out[(2, 2)], V,
    )


def eigh3(S: Mat, sweeps: int = 5):
    """Eigendecomposition of a symmetric planes matrix: (eigvals Vec, V Mat)."""
    s00, s01, s02, s11, s12, s22 = S[0], S[1], S[2], S[4], S[5], S[8]
    V = identity_like(s00)
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            s00, s01, s02, s11, s12, s22, V = _jacobi_sym(
                s00, s01, s02, s11, s12, s22, V, p, q
            )
    return (s00, s11, s22), V


def _sort_desc(eig: Vec, V: Mat):
    def cswap(eig, V, i, j):
        swap = eig[i] < eig[j]
        eig = list(eig)
        ei, ej = eig[i], eig[j]
        eig[i] = torch.where(swap, ej, ei)
        eig[j] = torch.where(swap, ei, ej)
        vi, vj = col(V, i), col(V, j)
        V = with_col(V, i, vwhere(swap, vj, vi))
        V = with_col(V, j, vwhere(swap, vi, vj))
        return tuple(eig), V

    eig, V = cswap(eig, V, 0, 1)
    eig, V = cswap(eig, V, 0, 2)
    eig, V = cswap(eig, V, 1, 2)
    return eig, V


def _safe_normalize(v: Vec, fallback: Vec) -> Vec:
    n = vnorm(v)
    ok = n > 1e-8
    inv = 1.0 / torch.where(ok, n, torch.ones_like(n))
    return vwhere(ok, vscale(v, inv), fallback)


def svd3(A: Mat, sweeps: int = 5):
    """Planes SVD: A ~= U @ diag(sig) @ V^T, sig descending >= 0.

    Same convention as ops/svd3.py:svd3x3; if det(A) < 0 then
    det(U)*det(V) = -1.
    """
    S = t_matmul(A, A)
    eig, V = eigh3(S, sweeps)
    eig, V = _sort_desc(eig, V)
    sig = tuple(torch.sqrt(torch.clamp_min(e, 0.0)) for e in eig)

    B = matmul(A, V)  # columns ~ sigma_i u_i
    zero = torch.zeros_like(A[0])
    one = torch.ones_like(A[0])
    e0 = (one, zero, zero)
    e1 = (zero, one, zero)

    u0 = _safe_normalize(col(B, 0), e0)
    b1 = col(B, 1)
    b1 = vsub(b1, vscale(u0, vdot(u0, b1)))
    alt = vcross(u0, e0)
    alt2 = vcross(u0, e1)
    use_alt = vnorm(alt) > 0.1
    fallback1 = _safe_normalize(vwhere(use_alt, alt, alt2), e0)
    u1 = _safe_normalize(b1, fallback1)
    b2 = col(B, 2)
    b2 = vsub(b2, vscale(u0, vdot(u0, b2)))
    b2 = vsub(b2, vscale(u1, vdot(u1, b2)))
    u2 = _safe_normalize(b2, vcross(u0, u1))

    # u0, u1, u2 are the COLUMNS of U
    U = (
        u0[0], u1[0], u2[0],
        u0[1], u1[1], u2[1],
        u0[2], u1[2], u2[2],
    )
    return U, sig, V


def polar_rotation(F: Mat) -> Mat:
    """R of F = R S with det(R) = +1 (planes form of svd3.polar_rotation)."""
    U, _, V = svd3(F)
    su = torch.where(det(U) < 0, -1.0, 1.0)
    sv = torch.where(det(V) < 0, -1.0, 1.0)
    U = with_col(U, 2, vscale(col(U, 2), su))
    V = with_col(V, 2, vscale(col(V, 2), sv))
    return matmul_t(U, V)
