"""Quadratic B-spline interpolation weights for MLS-MPM transfers.

Port of gsmpm_tpu/ops/bspline.py: the reference's per-particle weight and
derivative construction of p2g / g2p (the quadratic spline kernel),
batched over all particles on (N,3) positions.  The AoS oracle
(sim/solver.p2g / g2p) uses it; the engines compute the same weights per
axis on planes (sim/kernels._axis_stencil, sim/tiles).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# the 27 nodes of the 3x3x3 stencil, shape (27, 3)
SPLINE_OFFSETS = np.stack(
    np.meshgrid(np.arange(3), np.arange(3), np.arange(3), indexing="ij"), axis=-1
).reshape(27, 3)


def quadratic_bspline_weights(
    x: torch.Tensor, inv_dx: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-particle stencil data.

    Returns:
      base (N,3) int32 -- bottom-left-front grid node of the 3x3x3 stencil
      fx   (N,3)       -- fractional offset of the particle from base
      w    (N,3,3)     -- per-axis weights for stencil nodes 0,1,2
      dw   (N,3,3)     -- per-axis weight derivative factors
    """
    grid_pos = x * inv_dx
    base = torch.floor(grid_pos - 0.5).to(torch.int32)
    fx = grid_pos - base.to(x.dtype)

    wa = 1.5 - fx
    wb = fx - 1.0
    wc = fx - 0.5
    w = torch.stack([0.5 * wa * wa, 0.75 - wb * wb, 0.5 * wc * wc], dim=-1)
    dw = torch.stack([fx - 1.5, -2.0 * (fx - 1.0), fx - 0.5], dim=-1)
    return base, fx, w, dw


def stencil_weights(w: torch.Tensor) -> torch.Tensor:
    """(N,3,3) per-axis weights -> (N,27) product weights in SPLINE_OFFSETS
    order."""
    wx, wy, wz = w[:, 0, :], w[:, 1, :], w[:, 2, :]
    return (wx[:, :, None, None] * wy[:, None, :, None]
            * wz[:, None, None, :]).reshape(-1, 27)


def stencil_dweights(w: torch.Tensor, dw: torch.Tensor,
                     inv_dx: float) -> torch.Tensor:
    """(N,27,3) gradient of the product weight wrt position (times inv_dx),
    the reference's compute_dweight."""
    wx, wy, wz = w[:, 0, :], w[:, 1, :], w[:, 2, :]
    dwx, dwy, dwz = dw[:, 0, :], dw[:, 1, :], dw[:, 2, :]
    gx = dwx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    gy = wx[:, :, None, None] * dwy[:, None, :, None] * wz[:, None, None, :]
    gz = wx[:, :, None, None] * wy[:, None, :, None] * dwz[:, None, None, :]
    g = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 27, 3)
    return g * inv_dx
