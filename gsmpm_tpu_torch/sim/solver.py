"""MLS-MPM solver: the AoS oracle, the substep loops and ``MPMSolver``.

Port of gsmpm_tpu/sim/solver.py.
- ``p2g`` / ``grid_update`` / ``g2p`` / ``_substep_aos``: the readable
  AoS substep on (N,3) / (N,3,3) tensors, kept as the oracle that the
  planes engine (sim/kernels.substep_soa) is tested against.  P2G is one
  ``index_add_`` per grid quantity; it is for the tests on the CPU and is
  on no main path.
- ``substep``: the AoS entry point of the golden planes engine
  (sim/kernels.substep_soa), converting at the boundary.
- ``run_substeps``: n substeps of the golden engine, which generates the
  fitting ground truth, runs simulate's frames with ``incremental_cov`` or
  after a tiled-engine overflow, and is the fitting engine after one.
- ``postprocess``: cov = F Sigma0 F^T and the SH polar rotation.
- ``MPMSolver``: the facade that carries state, model, BCs and the clock
  between frames; on CUDA it steps with the tiled engine (sim/tiles.py,
  kernels K1 and K2) and falls back to the golden engine for good on a
  tile-cap overflow, as the JAX class does on a TPU.

Out-of-domain particles clamp their stencil to the grid boundary.  The
clock is a host float advanced in float32 as the JAX clock
(tiles._advance), so the boundary conditions' time windows switch on the
same substeps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from gsmpm_tpu_torch.config import MPMConfig
from gsmpm_tpu_torch.ops import m33
from gsmpm_tpu_torch.ops.bspline import (
    SPLINE_OFFSETS,
    quadratic_bspline_weights,
    stencil_dweights,
    stencil_weights,
)
from gsmpm_tpu_torch.ops.constitutive import (
    cauchy_stress_stvk_green,
    compute_stress_from_F_trial,
)
from gsmpm_tpu_torch.sim.boundary import (
    BCSet,
    build_boundary_conditions,
    make_surface_collider,
    sticky_ground,
)
from gsmpm_tpu_torch.sim.coupling import mat_from_upper, upper_from_mat
from gsmpm_tpu_torch.sim.kernels import (
    postprocess_soa,
    soa_from_state,
    state_from_soa,
    substep_soa,
)
from gsmpm_tpu_torch.sim.state import (
    GridConfig,
    MPMModel,
    MPMState,
    init_model,
    init_state,
)
from gsmpm_tpu_torch.sim.tiles import (
    _advance,
    bootstrap,
    default_tile_config,
    frame_tiled,
)
from gsmpm_tpu_torch.utils import resolve_device


# ---------------------------------------------------------------------------
# AoS P2G / grid / G2P (the oracle)
# ---------------------------------------------------------------------------

def _offsets(x: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.as_tensor(SPLINE_OFFSETS, dtype=dtype or x.dtype,
                           device=x.device)


def _stencil_nodes(base: torch.Tensor, n_grid: int):
    """(N,3) base -> (N,27,3) clamped node coords and (N,27) flat int64
    indices."""
    nodes = base[:, None, :].long() + _offsets(base, torch.int64)[None]
    nodes = torch.clamp(nodes, 0, n_grid - 1)
    flat = (nodes[..., 0] * n_grid + nodes[..., 1]) * n_grid + nodes[..., 2]
    return nodes, flat


def p2g(state: MPMState, stress: torch.Tensor, grid: GridConfig,
        dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter mass and APIC momentum + stress impulse to the grid (the
    reference's p2g).  Returns (grid_mass (G^3,), grid_mom (G^3, 3))."""
    base, fx, w, dw = quadratic_bspline_weights(state.x, grid.inv_dx)
    wN = stencil_weights(w)  # (N,27)
    dwN = stencil_dweights(w, dw, grid.inv_dx)  # (N,27,3)
    _, flat = _stencil_nodes(base, grid.n_grid)

    dpos = (_offsets(state.x)[None] - fx[:, None, :]) * grid.dx  # (N,27,3)
    # APIC momentum: w * m * (v + C @ dpos)
    c_dpos = torch.einsum("nij,nkj->nki", state.C, dpos)
    mom = wN[..., None] * (state.mass[:, None, None]
                           * (state.v[:, None, :] + c_dpos))
    # stress force impulse: -dt * V * sigma @ dweight
    mom = mom - dt * state.vol[:, None, None] * torch.einsum(
        "nij,nkj->nki", stress, dwN)

    g3 = grid.n_grid ** 3
    x = state.x
    grid_mass = torch.zeros((g3,), dtype=x.dtype, device=x.device).index_add_(
        0, flat.reshape(-1), (wN * state.mass[:, None]).reshape(-1))
    grid_mom = torch.zeros((g3, 3), dtype=x.dtype, device=x.device).index_add_(
        0, flat.reshape(-1), mom.reshape(-1, 3))
    return grid_mass, grid_mom


def grid_update(grid_mass: torch.Tensor, grid_mom: torch.Tensor,
                gravity: torch.Tensor, dt) -> torch.Tensor:
    """Momentum -> velocity + gravity where mass > 1e-15 (the reference's
    grid_normalization_and_gravity)."""
    has_mass = grid_mass > 1e-15
    safe_mass = torch.where(has_mass, grid_mass, 1.0)
    v = grid_mom / safe_mass[:, None] + dt * gravity[None, :]
    return torch.where(has_mass[:, None], v, 0.0)


def g2p(state: MPMState, grid_v: torch.Tensor, grid: GridConfig, dt,
        incremental_cov: bool = False) -> MPMState:
    """Gather velocities, rebuild APIC C and the velocity gradient, advect
    (the reference's g2p); ``incremental_cov`` also advances cov (its
    update_cov)."""
    base, fx, w, dw = quadratic_bspline_weights(state.x, grid.inv_dx)
    wN = stencil_weights(w)
    dwN = stencil_dweights(w, dw, grid.inv_dx)
    _, flat = _stencil_nodes(base, grid.n_grid)

    gv = grid_v[flat.reshape(-1)].reshape(-1, 27, 3)  # (N,27,3)
    new_v = torch.einsum("nk,nki->ni", wN, gv)
    dpos = _offsets(state.x)[None] - fx[:, None, :]  # unscaled, as the reference
    new_C = torch.einsum("nki,nkj,nk->nij", gv, dpos, wN) * (grid.inv_dx * 4.0)
    grad_v = torch.einsum("nki,nkj->nij", gv, dwN)

    new_x = state.x + dt * new_v
    eye = torch.eye(3, dtype=state.x.dtype, device=state.x.device)
    new_F_trial = (eye[None] + grad_v * dt) @ state.F

    new_cov = state.cov
    if incremental_cov:
        cov_mat = mat_from_upper(state.cov)
        cov_mat = cov_mat + dt * (
            grad_v @ cov_mat + cov_mat @ grad_v.transpose(-1, -2))
        new_cov = upper_from_mat(cov_mat)

    return dataclasses.replace(state, x=new_x, v=new_v, C=new_C,
                               F_trial=new_F_trial, cov=new_cov)


# ---------------------------------------------------------------------------
# one substep
# ---------------------------------------------------------------------------

def substep(state: MPMState, model: MPMModel, bcs: BCSet, time: float,
            grid: GridConfig, dt: float, incremental_cov: bool = False,
            group=None, fitting: bool = False) -> MPMState:
    """One MLS-MPM substep: the reference's p2g2p, or with ``fitting`` its
    p2g2p_forward (the Green StVK stress on F, no particle BCs, F :=
    F_trial).  The compute runs in the planes layout
    (sim/kernels.substep_soa); this AoS entry converts at the boundary.
    ``group`` all-reduces the grid over a process group (gsmpm_tpu's
    ``axis_name``)."""
    soa = substep_soa(soa_from_state(state), model, bcs, time, grid, dt,
                      incremental_cov=incremental_cov, group=group,
                      fitting=fitting)
    return state_from_soa(soa)


def _substep_aos(state: MPMState, model: MPMModel, bcs: BCSet, time: float,
                 grid: GridConfig, dt: float, incremental_cov: bool = False,
                 group=None, fitting: bool = False) -> MPMState:
    """Reference AoS substep: the readable oracle of ``substep``."""
    # particle-phase BCs (impulse)
    v = state.v
    if not fitting:
        for op in bcs.particle_ops:
            v = op.apply_particles(state.x, v, state.mass, time, dt)
    state = dataclasses.replace(state, v=v)

    # stress
    if fitting:
        stress = cauchy_stress_stvk_green(state.F, model.mu, model.lam)
        new_F = state.F
        new_yield = state.yield_stress
    else:
        res = compute_stress_from_F_trial(
            state.F_trial, model.material, model.mu, model.lam,
            state.yield_stress, model.alpha, model.hardening, model.xi,
            model.plastic_viscosity, model.softening, dt,
            active_materials=model.active_materials,
        )
        stress, new_F, new_yield = res.stress, res.F, res.yield_stress
    state = dataclasses.replace(state, F=new_F, yield_stress=new_yield)

    # P2G (+ the grid summed over the ranks of a process group)
    grid_mass, grid_mom = p2g(state, stress, grid, dt)
    if group is not None:
        from gsmpm_tpu_torch.parallel.mesh import all_reduce_sum

        grid_mass = all_reduce_sum(grid_mass, group)
        grid_mom = all_reduce_sum(grid_mom, group)

    # grid update + grid-phase BCs/colliders in registration order
    grid_v = grid_update(grid_mass, grid_mom, model.gravity, dt)
    if bcs.grid_ops:
        g = grid.n_grid
        ar = torch.arange(g, dtype=torch.float32, device=grid_v.device)
        coords = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                             dim=-1).reshape(-1, 3)
        for op in bcs.grid_ops:
            grid_v = op.apply_grid(grid_v, coords, time, dt, grid.dx)

    # G2P
    state = g2p(state, grid_v, grid, dt, incremental_cov)
    if fitting:
        # the fitting path advances F directly, no return map
        state = dataclasses.replace(state, F=state.F_trial)
    return state


def run_substeps(state: MPMState, model: MPMModel, bcs, time: float,
                 n_substeps: int, grid: GridConfig, dt: float,
                 incremental_cov: bool = False, group=None,
                 fitting: bool = False,
                 checkpoint_policy: Optional[str] = "substep"):
    """n_substeps of the golden engine; returns (state, time).

    ``incremental_cov`` advances cov every substep (the reference's
    update_cov); ``group`` all-reduces the dense grid over the ranks of a
    process group, each holding a particle shard (parallel/sharded.py),
    through a differentiable all-reduce while autograd records the run.

    ``checkpoint_policy="substep"`` recomputes each substep in the backward
    pass (``torch.utils.checkpoint``), keeping only the particle state
    between substeps, the JAX package's memory policy; it only matters
    when autograd records the run.  ``time`` is a host float advanced in
    float32 as the JAX clock.
    """
    soa = soa_from_state(state)
    remat = checkpoint_policy == "substep" and torch.is_grad_enabled()
    for _ in range(n_substeps):
        if remat:
            soa = torch.utils.checkpoint.checkpoint(
                substep_soa, soa, model, bcs, time, grid, dt,
                incremental_cov=incremental_cov, group=group,
                fitting=fitting, use_reentrant=False,
            )
        else:
            soa = substep_soa(soa, model, bcs, time, grid, dt,
                              incremental_cov=incremental_cov, group=group,
                              fitting=fitting)
        time = _advance(time, dt)
    return state_from_soa(soa), time


def postprocess(state: MPMState, rotate_sh: bool = False):
    """cov = F Sigma0 F^T and the SH polar rotation R, both from F_trial.

    Returns (cov6 (N,6), R (N,3,3) or None); R follows the reference's
    stored-transpose convention.
    """
    cov6_p, R_p = postprocess_soa(soa_from_state(state), rotate_sh)
    cov6 = torch.stack(cov6_p, dim=-1)
    R = m33.to_aos(R_p) if R_p is not None else None
    return cov6, R


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------

class MPMSolver:
    """Facade owning state, model, BCs and the clock between frames (the
    reference's MPM_Simulator surface).

    Runs on CUDA unless ``device="cpu"``; the inputs are moved there.  On
    CUDA, without ``incremental_cov``, ``step_frame`` runs the tiled engine
    (sim/tiles.frame_tiled: kernels K1 and K2, a persistent tiled state
    between frames).  If the occupied tiles exceed the tile cap, at the
    bootstrap or inside a frame, the frame is redone from its start state
    on the golden engine (``run_substeps``), which then runs every later
    frame.  ``use_tiled`` may be set before the first frame (the tests set
    it on the CPU, where the kernels' plain twins run).
    """

    def __init__(self, xyz, cov6, volumes, cfg: MPMConfig,
                 init_velocity=None, device="cuda"):
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        xyz = torch.as_tensor(xyz, **f32)
        if init_velocity is not None:
            init_velocity = torch.as_tensor(init_velocity, **f32)
        self.cfg = cfg
        self.grid = GridConfig(cfg.n_grid, cfg.grid_extent)
        self.model = init_model(cfg, xyz.shape[0], self.device)
        self.state = init_state(xyz, torch.as_tensor(cov6, **f32),
                                torch.as_tensor(volumes, **f32), cfg,
                                init_velocity)
        self.bcs = BCSet()
        self.time = 0.0
        self.use_tiled = (self.device.type == "cuda"
                          and not cfg.incremental_cov)
        self._ts = None
        self._tc = None

    def set_boundary_conditions(self, bc_configs):
        bcset, self.state, self.model = build_boundary_conditions(
            bc_configs, self.cfg, self.state, self.model
        )
        self.bcs = BCSet(
            particle_ops=self.bcs.particle_ops + bcset.particle_ops,
            grid_ops=self.bcs.grid_ops + bcset.grid_ops,
        )
        self._ts = None

    def set_bc_ground_only(self):
        """The reference's set_bc_ground_only: the sticky ground slab."""
        self.bcs = BCSet(
            particle_ops=self.bcs.particle_ops,
            grid_ops=self.bcs.grid_ops + (sticky_ground(self.device),),
        )
        self._ts = None

    def add_surface_collider(self, point, normal, surface="sticky",
                             friction=0.0):
        """A half-space collider (the reference implements the sticky
        surface only; ``surface`` is kept for its signature)."""
        self.bcs = BCSet(
            particle_ops=self.bcs.particle_ops,
            grid_ops=self.bcs.grid_ops + (make_surface_collider(
                point, normal, surface, friction, device=self.device),),
        )
        self._ts = None

    def step_frame(self, n_substeps: Optional[int] = None):
        """Advance one frame of n_substeps (default cfg.steps_per_frame)."""
        n = int(n_substeps or self.cfg.steps_per_frame)
        if self.use_tiled and self._step_frame_tiled(n):
            return
        self.state, self.time = run_substeps(
            self.state, self.model, self.bcs, self.time, n, self.grid,
            self.cfg.substep_dt, checkpoint_policy=None,
            incremental_cov=self.cfg.incremental_cov,
        )

    def invalidate_tiled(self):
        """Drop the tiled mirror (call after mutating self.state in place)."""
        self._ts = None

    def _step_frame_tiled(self, n: int) -> bool:
        """One tiled frame; False (state and clock untouched, the tiled
        engine off from here) if the occupied tiles overflow the cap."""
        if self._ts is None:
            self._tc = default_tile_config(self.cfg.n_grid,
                                           self.state.n_particles)
            self._ts = bootstrap(soa_from_state(self.state), self.model,
                                 self.grid, self._tc)
        ts = self._ts
        if bool(ts.ok):
            ts, soa, time = frame_tiled(
                ts, soa_from_state(self.state), self.model, self.bcs,
                self.time, n, self.grid, self._tc, self.cfg.substep_dt)
        if not bool(ts.ok):  # at the bootstrap or inside the frame
            self.use_tiled = False
            self._ts = None
            return False
        self._ts, self.state, self.time = ts, state_from_soa(soa), time
        return True

    def postprocess(self):
        """cov6 and the SH rotation R of the current state; stores cov6."""
        cov6, R = postprocess(self.state, rotate_sh=True)
        self.state = dataclasses.replace(self.state, cov=cov6)
        return cov6, R
