"""Batched, branch-free 3x3 SVD on torch tensors.

Port of gsmpm_tpu/ops/svd3.py: cyclic Jacobi (5 sweeps) on A^T A with a
fixed compare-swap sort.  torch.linalg.svd is not a substitute: its singular
vector signs and its handling of repeated values differ, and the stress
laws consume U and V directly.

Convention: returns U, sigma (descending, >= 0), V with A ~= U @ diag(sigma)
@ V^T; if det(A) < 0, det(U)*det(V) = -1.
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-12


def _eye_like(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=A.dtype, device=A.device).expand_as(A).clone()


def _jacobi_rotation(A: torch.Tensor, V: torch.Tensor, p: int, q: int):
    """One Jacobi rotation zeroing A[p,q], batched and branch-free."""
    apq = A[..., p, q]
    app = A[..., p, p]
    aqq = A[..., q, q]

    small = torch.abs(apq) < _EPS
    tau = (aqq - app) / (2.0 * torch.where(small, torch.ones_like(apq), apq))
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c

    # J = I with [pp,pq;qp,qq] = [c, s; -s, c]
    J = _eye_like(A)
    J[..., p, p] = c
    J[..., q, q] = c
    J[..., p, q] = s
    J[..., q, p] = -s

    A = J.transpose(-1, -2) @ A @ J
    V = V @ J
    return A, V


def _eigh3(S: torch.Tensor, sweeps: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a batched symmetric 3x3 via cyclic Jacobi."""
    V = _eye_like(S)
    A = S
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            A, V = _jacobi_rotation(A, V, p, q)
    eig = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], dim=-1)
    return eig, V


def _sort_desc3(eig: torch.Tensor, V: torch.Tensor):
    """Sort 3 eigenpairs descending with a fixed compare-swap network."""

    def cswap(eig, V, i, j):
        swap = eig[..., i] < eig[..., j]
        ei, ej = eig[..., i], eig[..., j]
        eig = eig.clone()
        eig[..., i] = torch.where(swap, ej, ei)
        eig[..., j] = torch.where(swap, ei, ej)
        vi, vj = V[..., :, i], V[..., :, j]
        V = V.clone()
        V[..., :, i] = torch.where(swap[..., None], vj, vi)
        V[..., :, j] = torch.where(swap[..., None], vi, vj)
        return eig, V

    eig, V = cswap(eig, V, 0, 1)
    eig, V = cswap(eig, V, 0, 2)
    eig, V = cswap(eig, V, 1, 2)
    return eig, V


def _safe_normalize(v: torch.Tensor, fallback: torch.Tensor):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ok = n > 1e-8
    return torch.where(ok, v / torch.where(ok, n, torch.ones_like(n)), fallback)


def svd3x3(A: torch.Tensor, sweeps: int = 5):
    """Batched SVD of (..., 3, 3): returns (U, sigma, V), sigma descending >= 0."""
    S = A.transpose(-1, -2) @ A
    eig, V = _eigh3(S, sweeps)
    eig, V = _sort_desc3(eig, V)
    sigma = torch.sqrt(torch.clamp_min(eig, 0.0))

    B = A @ V  # columns ~ sigma_i * u_i
    e0 = torch.zeros_like(B[..., :, 0])
    e0[..., 0] = 1.0
    e1 = torch.zeros_like(B[..., :, 0])
    e1[..., 1] = 1.0
    u0 = _safe_normalize(B[..., :, 0], e0)
    b1 = B[..., :, 1]
    b1 = b1 - torch.sum(u0 * b1, dim=-1, keepdim=True) * u0
    # fallback for u1: any unit vector orthogonal to u0
    alt = torch.linalg.cross(u0, e0)
    alt2 = torch.linalg.cross(u0, e1)
    use_alt = torch.linalg.vector_norm(alt, dim=-1, keepdim=True) > 0.1
    fallback1 = _safe_normalize(torch.where(use_alt, alt, alt2), e0)
    u1 = _safe_normalize(b1, fallback1)
    b2 = B[..., :, 2]
    b2 = (
        b2
        - torch.sum(u0 * b2, dim=-1, keepdim=True) * u0
        - torch.sum(u1 * b2, dim=-1, keepdim=True) * u1
    )
    u2 = _safe_normalize(b2, torch.linalg.cross(u0, u1))
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, sigma, V


def polar_rotation(F: torch.Tensor) -> torch.Tensor:
    """Rotation factor R of the polar decomposition F = R S (det R = +1).

    Flips the third columns of U and V when their determinants are negative
    before forming R = U V^T (the reference's compute_R_from_F).
    """
    U, _, V = svd3x3(F)
    su = torch.where(torch.linalg.det(U) < 0, -1.0, 1.0)
    sv = torch.where(torch.linalg.det(V) < 0, -1.0, 1.0)
    U = U.clone()
    V = V.clone()
    U[..., :, 2] = U[..., :, 2] * su[..., None]
    V[..., :, 2] = V[..., :, 2] * sv[..., None]
    return U @ V.transpose(-1, -2)
