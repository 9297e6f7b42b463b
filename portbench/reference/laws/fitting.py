"""The fitting path, whatever the material: the Green-Lagrange StVK law.

The stress is the Cauchy stress F S F^T / J with S = 2 mu E + lam tr(E) I
and E = (F^T F - I) / 2, |J| clamped to at least 1e-2; F is kept as it is.
"""

from __future__ import annotations

import torch

J_CLAMP = 1e-2


def stress(F, mu, lam):
    """(F, the StVK Cauchy stress)."""
    J = torch.linalg.det(F.float()).to(F.dtype)
    zero = (J == 0).to(J.dtype)
    J = torch.where(torch.abs(J) < J_CLAMP,
                    J_CLAMP * torch.sign(J) + zero * J_CLAMP, J)
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    E = 0.5 * (F.transpose(-1, -2) @ F - eye)
    trE = E.diagonal(dim1=-2, dim2=-1).sum(-1)
    S = 2.0 * mu[:, None, None] * E + (lam * trE)[:, None, None] * eye
    return F, F @ S @ F.transpose(-1, -2) / J[:, None, None]
