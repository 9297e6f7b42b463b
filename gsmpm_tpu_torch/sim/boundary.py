"""Boundary conditions and colliders as functional grid/particle transforms.

Port of gsmpm_tpu/sim/boundary.py (the reference's boundary_conditions.py
and collider.py).  Each BC is a small dataclass of tensors; the solver holds
an ordered tuple of grid ops (registration order matters) and applies them
with time activity as ``torch.where`` masks.  A time-windowed BC takes the
clock as a 0-d float32 tensor (the tiled frame's device clock, so a
captured substep needs no host read) or as a host float, whose inactive
windows return early and launch nothing.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from gsmpm_tpu_torch.config import BoundaryConditionConfig, MPMConfig
from gsmpm_tpu_torch.sim.state import (
    MPMModel,
    MPMState,
    logE_y_from_E_nu,
    material_types,
    mu_lam_from_logE_y,
)


def _vec(v, device) -> torch.Tensor:
    return torch.tensor(np.asarray(v, np.float32), device=device)


def _window(bc, time):
    """bc's time window [start_time, end_time) at ``time``: for a 0-d
    float32 tensor clock its mask (compared in float32, as gsmpm_tpu's
    traced clock); for a host float None inside the window and False
    outside it."""
    if isinstance(time, torch.Tensor):
        return (time >= bc.start_time) & (time < bc.end_time)
    return None if bc.start_time <= time < bc.end_time else False


# ---------------------------------------------------------------------------
# grid-phase ops (applied to grid velocities after normalization+gravity)
# ---------------------------------------------------------------------------

@dataclass
class FixedCubeBC:
    """Zero grid velocities inside an AABB while time-active."""

    center: torch.Tensor  # (3,)
    size: torch.Tensor  # (3,)
    start_time: float
    end_time: float

    def apply_grid(self, grid_v, grid_coords, time, dt, dx):
        window = _window(self, time)
        if window is False:
            return grid_v
        inside = torch.all(
            torch.abs(grid_coords * dx - self.center) < self.size, dim=-1
        )
        if window is not None:
            inside = inside & window
        return torch.where(inside[..., None], 0.0, grid_v)


@dataclass
class StickyGroundBC:
    """Always-active hard-coded ground slab zeroing grid velocities: center
    (1.0, 0.6, 1.0), half-size (1.0, 0.1, 1.0)."""

    center: torch.Tensor
    size: torch.Tensor

    def apply_grid(self, grid_v, grid_coords, time, dt, dx):
        inside = torch.all(
            torch.abs(grid_coords * dx - self.center) < self.size, dim=-1
        )
        return torch.where(inside[..., None], 0.0, grid_v)


@dataclass
class SurfaceCollider:
    """Half-space collider with Coulomb-style friction and the reference's
    hidden 0.99 velocity damping."""

    point: torch.Tensor  # (3,)
    normal: torch.Tensor  # (3,) unit
    friction: float

    def apply_grid(self, grid_v, grid_coords, time, dt, dx):
        offset = grid_coords * dx - self.point
        below = (offset * self.normal).sum(-1) < 0.0

        v = grid_v
        normal_comp = (v * self.normal).sum(-1)
        v_proj = v - torch.clamp_max(normal_comp, 0.0)[..., None] * self.normal
        speed = torch.linalg.vector_norm(v_proj, dim=-1)
        apply_fric = (normal_comp < 0.0) & (speed > 1e-20)
        safe_speed = torch.where(speed > 1e-20, speed, 1.0)
        v_fric = (
            torch.clamp_min(speed + normal_comp * self.friction, 0.0)[..., None]
            * v_proj
            / safe_speed[..., None]
        )
        v_new = torch.where(apply_fric[..., None], v_fric, v_proj) * 0.99
        return torch.where(below[..., None], v_new, grid_v)


GridOp = Union[FixedCubeBC, StickyGroundBC, SurfaceCollider]


def sticky_ground(device="cpu") -> StickyGroundBC:
    """The reference's StickyGroundBC slab on ``device``."""
    return StickyGroundBC(_vec([1.0, 0.6, 1.0], device),
                          _vec([1.0, 0.1, 1.0], device))


# ---------------------------------------------------------------------------
# particle-phase ops (applied to particle velocities before P2G)
# ---------------------------------------------------------------------------

@dataclass
class ImpulseBC:
    """Add F/m*dt to particle velocities inside an AABB while active."""

    center: torch.Tensor  # (3,)
    size: torch.Tensor  # (3,)
    force: torch.Tensor  # (3,)
    start_time: float
    end_time: float

    def apply_particles(self, x, v, mass, time, dt):
        window = _window(self, time)
        if window is False:
            return v
        # massless slots (the tiled layout's padding, a mesh's fillers) get
        # no impulse: F / 0 would put NaN into the grid through 0 * v
        inside = (torch.all(torch.abs(x - self.center) < self.size, dim=-1)
                  & (mass > 0))
        if window is not None:
            inside = inside & window
        dv = self.force[None, :] / mass[:, None] * dt
        return torch.where(inside[:, None], v + dv, v)


@dataclass
class BCSet:
    """Ordered collection of boundary conditions."""

    particle_ops: Tuple[ImpulseBC, ...] = ()
    grid_ops: Tuple[GridOp, ...] = ()


# ---------------------------------------------------------------------------
# registry / construction from config
# ---------------------------------------------------------------------------

def make_surface_collider(
    point: Sequence[float],
    normal: Sequence[float],
    surface: str = "sticky",
    friction: float = 0.0,
    start_time: float = 0.0,
    end_time: float = 999.0,
    *,
    device="cpu",
) -> SurfaceCollider:
    """The reference's add_surface_collider (sticky surface, always
    active); normalizes the normal.  ``surface``, ``start_time`` and
    ``end_time`` are accepted and unused, as in gsmpm_tpu."""
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    return SurfaceCollider(
        point=_vec(point, device), normal=_vec(n, device),
        friction=float(np.float32(friction)),
    )


def build_boundary_conditions(
    bc_configs: Sequence[BoundaryConditionConfig],
    cfg: MPMConfig,
    state: MPMState,
    model: MPMModel,
) -> Tuple[BCSet, MPMState, MPMModel]:
    """Construct the BC set and apply the init-phase BCs.

    additional_params sets E/nu/density in a region, recomputes mu/lam and
    optionally overrides mu; modify_material switches the material id.
    Times are float32 values, as the JAX package compares them.
    """
    dev = state.x.device
    particle_ops: List[ImpulseBC] = []
    grid_ops: List[GridOp] = []

    for bc in bc_configs:
        end_time = float(np.float32(bc.start_time + cfg.substep_dt * bc.num_dt))
        start_time = float(np.float32(bc.start_time))
        center = _vec(bc.center, dev)
        size = _vec(bc.size, dev)
        if bc.type == "fixed_cube":
            grid_ops.append(FixedCubeBC(center, size, start_time, end_time))
        elif bc.type == "impulse":
            particle_ops.append(ImpulseBC(
                center, size, _vec(bc.force, dev), start_time, end_time,
            ))
        elif bc.type == "sticky_ground":
            grid_ops.append(sticky_ground(dev))
        elif bc.type == "additional_params":
            inside = torch.all(torch.abs(state.x - center) < size, dim=-1)
            logE_r, y_r = logE_y_from_E_nu(bc.E, bc.nu)
            new_logE = torch.where(inside, float(np.float32(logE_r)), model.logE)
            new_y = torch.where(inside, float(np.float32(y_r)), model.y)
            mu, lam = mu_lam_from_logE_y(new_logE, new_y)
            if bc.mu is not None and bc.mu != 1000:
                mu = torch.where(inside, float(np.float32(bc.mu)), mu)
            model = dataclasses.replace(
                model, logE=new_logE, y=new_y, mu=mu, lam=lam
            )
            new_density = torch.where(
                inside, float(np.float32(bc.density)), state.density
            )
            state = dataclasses.replace(
                state, density=new_density, mass=new_density * state.vol
            )
        elif bc.type == "modify_material":
            inside = torch.all(torch.abs(state.x - center) < size, dim=-1)
            mat_id = (
                material_types[bc.material]
                if isinstance(bc.material, str)
                else int(bc.material)
            )
            new_mat = torch.where(
                inside, torch.tensor(mat_id, dtype=torch.int32, device=dev),
                model.material,
            )
            model = dataclasses.replace(
                model,
                material=new_mat,
                active_materials=tuple(
                    sorted(set(model.active_materials) | {mat_id})
                ),
            )
        else:
            raise ValueError(f"Unknown boundary condition type: {bc.type!r}")

    return BCSet(particle_ops=tuple(particle_ops),
                 grid_ops=tuple(grid_ops)), state, model
