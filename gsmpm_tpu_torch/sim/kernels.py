"""SoA (planes) particle state and the golden MPM engine.

Port of gsmpm_tpu/sim/kernels.py: ``SoAState`` with its conversions, the
golden substep (``p2g_soa`` / ``grid_update_soa`` / ``g2p_soa`` /
``substep_soa``) and ``postprocess_soa`` (cov = F Sigma0 F^T).  The golden
engine is plain torch on a dense (G^3,) grid: P2G is one ``index_add_`` of
the 27 stencil nodes' (mass, momentum) payloads, G2P one gather.  It
generates the fitting ground truth, is the simulation engine with
``incremental_cov`` and after a tiled-engine overflow, and runs each rank's
particle shard under a mesh (``group``: the dense grid is all-reduced, the
counterpart of the JAX engine's ``axis_name`` psum); the tiled engine
(sim/tiles.py) is the fast path.  Node indices clamp to the domain, as the
JAX package's halo fold does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from gsmpm_tpu_torch.ops import m33
from gsmpm_tpu_torch.ops.constitutive import (
    cauchy_stress_stvk_green_soa,
    compute_stress_soa,
)
from gsmpm_tpu_torch.sim.state import GridConfig, MPMModel, MPMState


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


def _axis_stencil(xa: torch.Tensor, inv_dx: float):
    """One axis: (base int64, fx, (w0, w1, w2), (dw0, dw1, dw2) * inv_dx)."""
    gp = xa * inv_dx
    base = torch.floor(gp - 0.5).to(torch.int64)
    fx = gp - base.to(xa.dtype)
    w = (0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2)
    dw = ((fx - 1.5) * inv_dx, -2.0 * (fx - 1.0) * inv_dx,
          (fx - 0.5) * inv_dx)
    return base, fx, w, dw


def _stencil(x: Tuple, grid: GridConfig):
    """Per axis: fx, weights, gradients and the 3 node coordinates.  The
    base cell clips to [-1, g-1] and each node to [0, g-1], which is the
    JAX engine's halo fold written as an index clamp."""
    g = grid.n_grid
    sten = [_axis_stencil(x[a], grid.inv_dx) for a in range(3)]
    fxs = [s[1] for s in sten]
    ws = [s[2] for s in sten]
    dws = [s[3] for s in sten]
    nodes = [[torch.clamp(torch.clamp(s[0], -1, g - 1) + o, 0, g - 1)
              for o in range(3)] for s in sten]
    return fxs, ws, dws, nodes


_OFFSETS = [(i, j, k) for i in range(3) for j in range(3) for k in range(3)]


def _node_ids(nodes, g: int) -> torch.Tensor:
    """(27, N) flat grid index of every stencil node."""
    return torch.stack([(nodes[0][i] * g + nodes[1][j]) * g + nodes[2][k]
                        for i, j, k in _OFFSETS])


def p2g_soa(state: SoAState, stress: Tuple, grid: GridConfig, dt,
            group=None):
    """P2G onto the dense grid: (grid_mass (G^3,), 3 momentum planes).

    Mass, APIC momentum and the stress impulse of every stencil node, as
    the reference's p2g; all 27 x N contributions land with one
    ``index_add_``.  With a process ``group`` the (4, G^3) grid is summed
    over its ranks (one all-reduce, differentiable while autograd records
    it), each rank holding a particle shard."""
    g = grid.n_grid
    fxs, ws, dws, nodes = _stencil(state.x, grid)
    v, C, sig = state.v, state.C, stress
    mass, vol = state.mass, state.vol
    vals = []
    for i, j, k in _OFFSETS:
        w = ws[0][i] * ws[1][j] * ws[2][k]
        dwv = (dws[0][i] * ws[1][j] * ws[2][k],
               ws[0][i] * dws[1][j] * ws[2][k],
               ws[0][i] * ws[1][j] * dws[2][k])
        dpos = ((i - fxs[0]) * grid.dx, (j - fxs[1]) * grid.dx,
                (k - fxs[2]) * grid.dx)
        wm = w * mass
        comp = [wm]
        for r in range(3):
            apic = (C[3 * r + 0] * dpos[0] + C[3 * r + 1] * dpos[1]
                    + C[3 * r + 2] * dpos[2])
            sforce = (sig[3 * r + 0] * dwv[0] + sig[3 * r + 1] * dwv[1]
                      + sig[3 * r + 2] * dwv[2])
            comp.append(wm * (v[r] + apic) - dt * vol * sforce)
        vals.append(torch.stack(comp))
    vals = torch.stack(vals, dim=1)                     # (4, 27, N)
    ids = _node_ids(nodes, g).reshape(-1)
    acc = torch.zeros((4, g * g * g), dtype=mass.dtype, device=mass.device)
    acc = acc.index_add(1, ids, vals.reshape(4, -1))
    if group is not None:
        from gsmpm_tpu_torch.parallel.mesh import all_reduce_sum

        acc = all_reduce_sum(acc, group)
    return acc[0], (acc[1], acc[2], acc[3])


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


def g2p_soa(state: SoAState, grid_v: Tuple, grid: GridConfig, dt,
            incremental_cov: bool = False) -> SoAState:
    """Gather velocity, rebuild APIC C and grad v, advect x, and form
    F_trial = (I + dt grad v) F (the reference's g2p).  ``incremental_cov``
    also advances cov += dt (grad v cov + cov grad v^T) on the upper-6
    packing (the reference's update_cov)."""
    g = grid.n_grid
    fxs, ws, dws, nodes = _stencil(state.x, grid)
    ids = _node_ids(nodes, g)                           # (27, N)
    # index_select, whose backward is one index_add_ (where an indexing
    # gather's is an accumulating index_put_)
    gv_all = torch.stack(grid_v).index_select(
        1, ids.reshape(-1)).reshape(3, 27, -1)          # (3, 27, N)
    zero = torch.zeros_like(state.x[0])
    new_v = [zero] * 3
    new_C = [zero] * 9
    grad_v = [zero] * 9
    for o, (i, j, k) in enumerate(_OFFSETS):
        w = ws[0][i] * ws[1][j] * ws[2][k]
        dwv = (dws[0][i] * ws[1][j] * ws[2][k],
               ws[0][i] * dws[1][j] * ws[2][k],
               ws[0][i] * ws[1][j] * dws[2][k])
        dpos = ((i - fxs[0]), (j - fxs[1]), (k - fxs[2]))
        for r in range(3):
            gvr = gv_all[r, o]
            new_v[r] = new_v[r] + w * gvr
            for c in range(3):
                new_C[3 * r + c] = new_C[3 * r + c] + w * gvr * dpos[c]
                grad_v[3 * r + c] = grad_v[3 * r + c] + gvr * dwv[c]
    coef = grid.inv_dx * 4.0
    new_C = tuple(c * coef for c in new_C)
    new_x = tuple(state.x[a] + dt * new_v[a] for a in range(3))
    grad_v = tuple(grad_v)
    new_F_trial = m33.matmul(
        m33.add_scaled_identity(m33.scale(grad_v, dt), 1.0), state.F
    )
    new_cov = state.cov
    if incremental_cov:
        cov_m = m33.from_upper6(state.cov)
        delta = m33.add(m33.matmul(grad_v, cov_m), m33.matmul_t(cov_m, grad_v))
        new_cov = m33.to_upper6(m33.add(cov_m, m33.scale(delta, dt)))
    return state._replace(x=new_x, v=tuple(new_v), C=new_C,
                          F_trial=new_F_trial, cov=new_cov)


@functools.lru_cache(maxsize=4)
def _grid_coords(g: int, device: str) -> torch.Tensor:
    """(g^3, 3) float32 coordinates of the dense grid's nodes, built once
    per (g, device)."""
    ar = torch.arange(g, dtype=torch.float32, device=device)
    return torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                       dim=-1).reshape(-1, 3)


def substep_soa(state: SoAState, model: MPMModel, bcs, time,
                grid: GridConfig, dt: float, incremental_cov: bool = False,
                group=None, fitting: bool = False) -> SoAState:
    """One golden substep: particle BCs -> stress -> P2G -> grid update +
    grid BCs -> G2P.  ``fitting`` takes the Green StVK stress on F with no
    particle BCs and advances F := F_trial (the fitting semantics);
    ``incremental_cov`` and ``group`` go to g2p_soa and p2g_soa.  ``time``
    is a host float or a 0-d float32 tensor (a captured substep's device
    clock, sim/solver.py); the BCs' windows read either, and the substep
    reads nothing on the host."""
    if not fitting and bcs.particle_ops:
        v_aos = m33.vec_to_aos(state.v)
        x_aos = m33.vec_to_aos(state.x)
        for op in bcs.particle_ops:
            v_aos = op.apply_particles(x_aos, v_aos, state.mass, time, dt)
        state = state._replace(v=m33.vec_from_aos(v_aos))
    if fitting:
        stress = cauchy_stress_stvk_green_soa(state.F, model.mu, model.lam)
    else:
        new_F, stress, new_yield = compute_stress_soa(
            state.F_trial, model.material, model.mu, model.lam,
            state.yield_stress, model.alpha, model.hardening, model.xi,
            model.plastic_viscosity, model.softening, dt,
            active_materials=model.active_materials,
        )
        state = state._replace(F=new_F, yield_stress=new_yield)
    grid_mass, grid_mom = p2g_soa(state, stress, grid, dt, group)
    grid_v = grid_update_soa(grid_mass, grid_mom, model.gravity, dt)
    if bcs.grid_ops:
        coords = _grid_coords(grid.n_grid, str(grid_mass.device))
        gv_aos = torch.stack(grid_v, dim=-1)
        for op in bcs.grid_ops:
            gv_aos = op.apply_grid(gv_aos, coords, time, dt, grid.dx)
        grid_v = tuple(gv_aos[:, r] for r in range(3))
    state = g2p_soa(state, grid_v, grid, dt, incremental_cov)
    if fitting:
        state = state._replace(F=state.F_trial)
    return state


def postprocess_soa(state: SoAState, rotate_sh: bool = False):
    """cov6 = F Sigma0 F^T (+ optional polar R^T), F being F_trial.

    Returns (cov6 planes tuple, R planes or None).
    """
    F = state.F_trial
    cov = m33.matmul_t(m33.matmul(F, m33.from_upper6(state.init_cov)), F)
    cov6 = m33.to_upper6(cov)
    R = m33.transpose(m33.polar_rotation(F)) if rotate_sh else None
    return cov6, R
