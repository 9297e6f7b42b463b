"""Real spherical harmonics: evaluation (degree 0-3) and SH rotation.

Port of gsmpm_tpu/render/sh.py.  ``eval_sh`` is the 3DGS rasterizer's
SH -> RGB evaluation; ``rotate_sh`` rotates bands 1..3 by
per-gaussian rotations with the exact projection method (evaluate the band
basis at fixed sample directions, solve the linear system once).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def _band_basis(d, l: int, stack):
    """Band-l real SH basis, term for term as the 3DGS rasterizer.

    d: (..., 3); returns (..., 2l+1).  ``stack`` is np.stack or torch.stack
    with the last axis as its keyword default (see the callers).
    """
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    if l == 1:
        return stack([-C1 * y, C1 * z, -C1 * x])
    if l == 2:
        xx, yy, zz = x * x, y * y, z * z
        return stack([
            C2[0] * x * y,
            C2[1] * y * z,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * x * z,
            C2[4] * (xx - yy),
        ])
    if l == 3:
        xx, yy, zz = x * x, y * y, z * z
        return stack([
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * x * y * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ])
    raise ValueError(l)


def _tstack(xs):
    return torch.stack(xs, dim=-1)


def _nstack(xs):
    return np.stack(xs, axis=-1)


def band_basis(d: torch.Tensor, l: int) -> torch.Tensor:
    return _band_basis(d, l, _tstack)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Evaluate real SH colors.

    sh: (N, K, 3) coefficients, K >= (degree+1)^2; dirs: (N, 3) unit view
    dirs.  Returns (N, 3) RGB (before the +0.5 shift).
    """
    result = C0 * sh[:, 0]
    offset = 1
    for l in range(1, degree + 1):
        m = 2 * l + 1
        result = result + torch.einsum("nk,nkc->nc", band_basis(dirs, l),
                                       sh[:, offset:offset + m])
        offset += m
    return result


@lru_cache(maxsize=None)
def _sample_dirs_and_inv(l: int):
    """Fixed sample directions for band l and the inverse basis matrix."""
    m = 2 * l + 1
    rng = np.random.default_rng(12345 + l)
    dirs = rng.normal(size=(m, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    A = _band_basis(dirs, l, _nstack)  # (m, m) rows=samples, cols=basis fns
    return dirs.astype(np.float32), np.linalg.inv(A).astype(np.float32)


def band_rotation(R: torch.Tensor, l: int) -> torch.Tensor:
    """(.., 3, 3) rotation -> (.., 2l+1, 2l+1) SH-coefficient rotation M;
    c' = M @ c reproduces color'(d) = color(R^T d)."""
    dirs_np, A_inv_np = _sample_dirs_and_inv(l)
    dirs = torch.from_numpy(dirs_np).to(R.device)
    A_inv = torch.from_numpy(A_inv_np).to(R.device)
    d_rot = torch.einsum("...ji,kj->...ki", R, dirs)  # R^T d_k
    B = band_basis(d_rot, l)  # (..., m, m)
    return torch.einsum("km,...ml->...kl", A_inv, B)


def rotate_sh(sh: torch.Tensor, R: torch.Tensor, degree: int) -> torch.Tensor:
    """Rotate SH coefficients (N, K, 3) by per-gaussian rotations R (N, 3, 3)."""
    out = [sh[:, 0:1]]
    offset = 1
    for l in range(1, degree + 1):
        m = 2 * l + 1
        M = band_rotation(R, l)
        out.append(torch.einsum("nij,njc->nic", M, sh[:, offset:offset + m]))
        offset += m
    return torch.cat(out, dim=1)
