"""Jelly, the simulation path: the fixed-corotated law with no plasticity.

F is F_trial, which a jelly keeps as its elastic F; the stress is the
symmetrised Kirchhoff stress 2 mu (F - R) F^T + lam J (J - 1) I, with R
the polar rotation of F by Newton's iteration.
"""

from __future__ import annotations

import torch


def _inv_t(M: torch.Tensor) -> torch.Tensor:
    """Inverse transpose of (N, 3, 3) by cofactors."""
    a, b, c = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    d, e, f = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    g, h, i = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
    A, B, Cc = e * i - f * h, f * g - d * i, d * h - e * g
    det = a * A + b * B + c * Cc
    cof = torch.stack([
        torch.stack([A, B, Cc], -1),
        torch.stack([c * h - b * i, a * i - c * g, b * g - a * h], -1),
        torch.stack([b * f - c * e, c * d - a * f, a * e - b * d], -1),
    ], -2)
    return cof / det[:, None, None]


def polar_rotation(F: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """R of F = R S (det F > 0) by Newton's iteration R <- (R + R^-T) / 2."""
    R = F
    for _ in range(iters):
        R = 0.5 * (R + _inv_t(R))
    return R


def stress(F, mu, lam):
    """(F, the symmetrised fixed-corotated Kirchhoff stress)."""
    R = polar_rotation(F)
    J = torch.linalg.det(F.float()).to(F.dtype)
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    tau = (2.0 * mu[:, None, None] * ((F - R) @ F.transpose(-1, -2))
           + (lam * J * (J - 1.0))[:, None, None] * eye)
    return F, 0.5 * (tau + tau.transpose(-1, -2))
