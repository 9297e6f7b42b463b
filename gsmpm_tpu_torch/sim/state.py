"""MPM state and model parameters as dataclasses of torch tensors.

Port of gsmpm_tpu/sim/state.py.  Scalars that the JAX package keeps as f32
arrays (gravity, alpha, xi, plastic_viscosity, softening) stay 0-d / (3,)
float32 tensors here, so every product with them rounds as it does there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gsmpm_tpu_torch.config import MPMConfig

material_types = {
    "jelly": 0,
    "metal": 1,
    "sand": 2,
    "foam": 3,
    "fluid": 4,
    "water": 4,
    "plasticine": 5,
}


class GridConfig(NamedTuple):
    """Static Eulerian grid geometry."""

    n_grid: int
    grid_extent: float

    @property
    def dx(self) -> float:
        return self.grid_extent / self.n_grid

    @property
    def inv_dx(self) -> float:
        return self.n_grid / self.grid_extent


@dataclass
class MPMModel:
    """Per-particle material parameters + global physics constants.

    E = 10^logE and nu = 0.49*sigmoid(y), the reference's parameterization.
    """

    material: torch.Tensor  # (N,) int32
    logE: torch.Tensor  # (N,)
    y: torch.Tensor  # (N,)
    mu: torch.Tensor  # (N,)
    lam: torch.Tensor  # (N,)
    viscosity: torch.Tensor  # (N,)
    gravity: torch.Tensor  # (3,)
    alpha: torch.Tensor  # () Drucker-Prager friction coefficient
    xi: torch.Tensor  # () von-Mises hardening coefficient
    plastic_viscosity: torch.Tensor  # ()
    softening: torch.Tensor  # ()
    hardening: int = 1
    active_materials: Tuple[int, ...] = (0,)

    @property
    def n_particles(self) -> int:
        return self.material.shape[0]

    def E(self) -> torch.Tensor:
        return torch.pow(10.0, self.logE)

    def nu(self) -> torch.Tensor:
        return 0.49 / (1.0 + torch.exp(-self.y))


def mu_lam_from_logE_y(logE: torch.Tensor, y: torch.Tensor):
    """The reference's compute_mu_lam_from_E_nu on (logE, y)."""
    E = torch.pow(10.0, logE)
    nu = 0.49 / (1.0 + torch.exp(-y))
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


def logE_y_from_E_nu(E: float, nu: float) -> Tuple[float, float]:
    return math.log10(E), -math.log(0.49 / nu - 1.0)


@dataclass
class MPMState:
    """All evolving per-particle state; covariances 6-packed
    [xx,xy,xz,yy,yz,zz]."""

    x: torch.Tensor  # (N,3) positions in grid space
    v: torch.Tensor  # (N,3)
    F: torch.Tensor  # (N,3,3) elastic deformation gradient (post return map)
    F_trial: torch.Tensor  # (N,3,3)
    C: torch.Tensor  # (N,3,3) APIC affine velocity
    vol: torch.Tensor  # (N,)
    density: torch.Tensor  # (N,)
    mass: torch.Tensor  # (N,)
    init_cov: torch.Tensor  # (N,6)
    cov: torch.Tensor  # (N,6)
    yield_stress: torch.Tensor  # (N,)

    @property
    def n_particles(self) -> int:
        return self.x.shape[0]


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=device)


def init_model(cfg: MPMConfig, n_particles: int,
               device="cuda") -> MPMModel:
    """MPMModel from config (the reference's MPM_model.__init__)."""
    mat_id = material_types.get(cfg.material, -1)
    if mat_id < 0:
        raise TypeError(f"Material not supported yet: {cfg.material!r}")
    logE0, y0 = logE_y_from_E_nu(cfg.E, cfg.nu)
    f32 = dict(dtype=torch.float32, device=device)
    logE = torch.full((n_particles,), logE0, **f32)
    y = torch.full((n_particles,), y0, **f32)
    mu, lam = mu_lam_from_logE_y(logE, y)
    sin_phi = math.sin(math.radians(cfg.friction_angle))
    alpha = math.sqrt(2.0 / 3.0) * 2.0 * sin_phi / (3.0 - sin_phi)
    return MPMModel(
        material=torch.full((n_particles,), mat_id, dtype=torch.int32,
                            device=device),
        logE=logE,
        y=y,
        mu=mu,
        lam=lam,
        viscosity=torch.full((n_particles,), cfg.viscosity, **f32),
        gravity=torch.tensor(np.asarray(cfg.gravity, np.float32), **f32),
        alpha=_f32(alpha, device),
        xi=_f32(cfg.xi, device),
        plastic_viscosity=_f32(cfg.plastic_viscosity, device),
        softening=_f32(cfg.softening, device),
        hardening=int(cfg.hardening),
        active_materials=(mat_id,),
    )


def init_state(
    xyz: torch.Tensor,
    cov6: torch.Tensor,
    volumes: torch.Tensor,
    cfg: MPMConfig,
    init_velocity: Optional[torch.Tensor] = None,
) -> MPMState:
    """The reference's MPM_state.__init__ on the tensors' device."""
    n = xyz.shape[0]
    f32 = dict(dtype=torch.float32, device=xyz.device)
    eye = torch.eye(3, **f32).expand(n, 3, 3).contiguous()
    density = torch.full((n,), cfg.density, **f32)
    v0 = (torch.zeros((n, 3), **f32) if init_velocity is None
          else init_velocity.to(**f32))
    vol = volumes.to(**f32)
    cov = cov6.to(**f32).reshape(n, 6)
    return MPMState(
        x=xyz.to(**f32),
        v=v0,
        F=eye,
        F_trial=eye.clone(),
        C=torch.zeros((n, 3, 3), **f32),
        vol=vol,
        density=density,
        mass=density * vol,
        init_cov=cov,
        cov=cov.clone(),
        yield_stress=torch.full((n,), cfg.yield_stress, **f32),
    )
