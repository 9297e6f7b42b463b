"""SoA (planes) particle state and the grid update of the tiled engine.

Port of the parts of gsmpm_tpu/sim/kernels.py that the tiled engine uses:
``SoAState`` with its conversions, ``grid_update_soa`` (the reference's
grid_normalization_and_gravity) and ``postprocess_soa`` (cov = F Sigma0 F^T).
The XLA golden engine (p2g_soa / g2p_soa / substep_soa) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gsmpm_tpu_torch.ops import m33
from gsmpm_tpu_torch.sim.state import MPMState


class SoAState(NamedTuple):
    """Planes mirror of MPMState."""

    x: Tuple  # 3 x (N,)
    v: Tuple  # 3 x (N,)
    F: Tuple  # 9 x (N,)
    F_trial: Tuple  # 9 x (N,)
    C: Tuple  # 9 x (N,)
    vol: torch.Tensor
    density: torch.Tensor
    mass: torch.Tensor
    init_cov: Tuple  # 6 x (N,)
    cov: Tuple  # 6 x (N,)
    yield_stress: torch.Tensor


def soa_from_state(s: MPMState) -> SoAState:
    return SoAState(
        x=m33.vec_from_aos(s.x),
        v=m33.vec_from_aos(s.v),
        F=m33.from_aos(s.F),
        F_trial=m33.from_aos(s.F_trial),
        C=m33.from_aos(s.C),
        vol=s.vol,
        density=s.density,
        mass=s.mass,
        init_cov=tuple(s.init_cov[:, i] for i in range(6)),
        cov=tuple(s.cov[:, i] for i in range(6)),
        yield_stress=s.yield_stress,
    )


def state_from_soa(s: SoAState) -> MPMState:
    return MPMState(
        x=m33.vec_to_aos(s.x),
        v=m33.vec_to_aos(s.v),
        F=m33.to_aos(s.F),
        F_trial=m33.to_aos(s.F_trial),
        C=m33.to_aos(s.C),
        vol=s.vol,
        density=s.density,
        mass=s.mass,
        init_cov=torch.stack(s.init_cov, dim=-1),
        cov=torch.stack(s.cov, dim=-1),
        yield_stress=s.yield_stress,
    )


def grid_update_soa(grid_mass, grid_mom, gravity, dt):
    """Grid normalization + gravity: v = mom/m + dt g where m > 1e-15."""
    has_mass = grid_mass > 1e-15
    inv = torch.where(
        has_mass, 1.0 / torch.where(has_mass, grid_mass, 1.0), 0.0
    )
    return tuple(
        torch.where(has_mass, grid_mom[r] * inv + dt * gravity[r], 0.0)
        for r in range(3)
    )


def postprocess_soa(state: SoAState, rotate_sh: bool = False):
    """cov6 = F Sigma0 F^T (+ optional polar R^T), F being F_trial.

    Returns (cov6 planes tuple, R planes or None).
    """
    F = state.F_trial
    cov = m33.matmul_t(m33.matmul(F, m33.from_upper6(state.init_cov)), F)
    cov6 = m33.to_upper6(cov)
    R = m33.transpose(m33.polar_rotation(F)) if rotate_sh else None
    return cov6, R
