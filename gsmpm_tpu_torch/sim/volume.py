"""Per-particle volume initialization from grid occupancy.

Port of gsmpm_tpu/sim/volume.py: histogram particles into cells
(``bincount`` in place of the scatter-add), volume = dx^3 / count(cell),
optionally replaced by its mean.
"""

from __future__ import annotations

import torch


def particle_volume(
    x: torch.Tensor, n_grid: int, grid_extent: float, uniform: bool = False
) -> torch.Tensor:
    dx = grid_extent / n_grid
    cell = torch.clamp(torch.floor(x / dx).to(torch.int64), 0, n_grid - 1)
    flat = (cell[:, 0] * n_grid + cell[:, 1]) * n_grid + cell[:, 2]
    counts = torch.bincount(flat, minlength=n_grid ** 3).to(torch.float32)
    vol = (dx ** 3) / counts[flat]
    if uniform:
        vol = torch.full_like(vol, vol.mean())
    return vol
