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
  after a tiled-engine overflow, and is the fitting engine after one.  On
  CUDA it is gsmpm_tpu's one jitted scan: a captured substep replayed
  (``_GoldenGraph``), or for a recorded fitting window a forward and an
  adjoint graph (``_GoldenFittingWindow``).
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

import collections
import dataclasses
from typing import NamedTuple, Optional, Tuple

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
from gsmpm_tpu_torch.sim.graphs import (
    _cached,
    _Captured,
    _identity,
    _owned,
    _register,
    _values,
)
from gsmpm_tpu_torch.sim.kernels import (
    SoAState,
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


# ---------------------------------------------------------------------------
# the golden engine as one program (CUDA graphs)
# ---------------------------------------------------------------------------

# the planes of a golden state as rows of one (49, N) buffer: (field, rows),
# the fields a fitting substep carries gradient through first (x, v, C, F,
# and cov when it advances it)
_LAYOUT = (("x", 3), ("v", 3), ("C", 9), ("F", 9), ("cov", 6),
           ("F_trial", 9), ("yield_stress", 1), ("vol", 1), ("density", 1),
           ("mass", 1), ("init_cov", 6))


def _spans(layout):
    spans, lo = {}, 0
    for name, k in layout:
        spans[name] = (lo, lo + k)
        lo += k
    return spans, lo


_SPANS, _ROWS = _spans(_LAYOUT)


def _carried(incremental_cov: bool) -> tuple:
    """The fields a fitting substep differentiates, the buffer's first
    rows: x, v, C, F (24 rows), and cov (6 more) when it advances it."""
    return ("x", "v", "C", "F") + (("cov",) if incremental_cov else ())


def _planes(soa: SoAState) -> list:
    """Every plane of soa, in the order of its fields."""
    return [p for f in soa for p in (f if isinstance(f, tuple) else (f,))]


def _aos(rows: torch.Tensor) -> torch.Tensor:
    """The (k, N) rows of one field as its own contiguous (N,), (N, k) or,
    for 9 rows, (N, 3, 3) tensor."""
    k, n = rows.shape
    if k == 1:
        return rows[0].clone()
    out = rows.T.contiguous()
    return out.reshape(n, 3, 3) if k == 9 else out


def _soa_of(rows: torch.Tensor) -> SoAState:
    """The SoAState whose planes are the rows of a (49, N) buffer."""
    fields = {}
    for name, (lo, hi) in _SPANS.items():
        fields[name] = rows[lo] if hi - lo == 1 else tuple(rows[lo:hi])
    return SoAState(**fields)


def _assign(dst: SoAState, src: SoAState) -> None:
    """dst's planes := src's, in place, in the order of SoAState's fields,
    each plane of src that is not dst's own.  A plane of src may be another
    of dst's buffers (the jelly return map's F is its input F_trial):
    SoAState lists F before F_trial, so that buffer is read before it is
    written."""
    for d, p in zip(_planes(dst), _planes(src)):
        if p is not d:
            d.copy_(p)


class _GoldenStatic:
    """The static buffers a golden graph reads and writes: every plane of
    an SoAState, each a row of one (49, N) float32 buffer, and a 0-d
    float32 clock (the counterpart of sim/tiles.py's ``_StaticState``)."""

    def __init__(self, n: int, device: torch.device):
        self.buf = torch.zeros((_ROWS, n), dtype=torch.float32,
                               device=device)
        self.soa = _soa_of(self.buf)
        self.clock = torch.zeros((), dtype=torch.float32, device=device)

    def load(self, state: MPMState, time) -> None:
        n = self.buf.shape[1]
        for name, (lo, hi) in _SPANS.items():
            self.buf[lo:hi].copy_(getattr(state, name).reshape(n, hi - lo).T)
        self.clock.fill_(time)

    def state(self) -> MPMState:
        """An MPMState that owns its tensors (later replays leave it)."""
        return MPMState(**{name: _aos(self.buf[lo:hi])
                           for name, (lo, hi) in _SPANS.items()})


class _GoldenGraph(_GoldenStatic):
    """Static buffers of a golden state and a clock, and the golden
    substep over them: on CUDA replayed from one CUDA graph, captured after
    the first substep ran eagerly (``_Captured``); on the CPU the same body
    run eagerly.  The body is ``substep_soa`` at the device clock, its
    planes copied back in place, then clock += dt (``_advance``'s float32
    value); it reads nothing on the host.  With a process ``group``
    (parallel/sharded.py's psum engine: the buffers hold this rank's
    particle shard) the graph holds the dense grid's all-reduce.  The graph
    bakes in the addresses of the buffers and of ``model``'s and ``bcs``'
    tensors."""

    def __init__(self, state: MPMState, model: MPMModel, bcs,
                 grid: GridConfig, dt: float, incremental_cov: bool,
                 fitting: bool, group=None, refs=()):
        super().__init__(state.x.shape[0], state.x.device)
        self.refs = refs  # what its cache key names by identity
        self.model, self.bcs, self.grid, self.dt = model, bcs, grid, dt
        self.incremental_cov, self.fitting = incremental_cov, fitting
        self.group = group
        self.substep = _Captured(state.x.device, run_substeps)

    def _body(self) -> None:
        _assign(self.soa, substep_soa(
            self.soa, self.model, self.bcs, self.clock, self.grid, self.dt,
            incremental_cov=self.incremental_cov, group=self.group,
            fitting=self.fitting))
        self.clock.add_(self.dt)

    def release(self) -> None:
        self.substep.release()

    def step(self) -> None:
        self.substep(self._body)


# captured golden substeps, least recently used first: simulate's golden
# frames, MPMSolver's, the ground truth's and the psum engine's
_GOLDEN_GRAPHS: "collections.OrderedDict[tuple, _GoldenGraph]" = (
    _register(4))


def _golden_graph(state: MPMState, model: MPMModel, bcs, grid: GridConfig,
                  dt: float, incremental_cov: bool, fitting: bool,
                  group=None) -> _GoldenGraph:
    """The cached golden substep graph of (N, grid, dt, incremental_cov,
    fitting, the device, model's and bcs' tensors, the process group): a
    new model, BC set or group captures anew."""
    refs: list = []
    key = (state.x.shape[0], grid, dt, incremental_cov, fitting,
           state.x.device, _identity(model, refs), _identity(bcs, refs),
           _identity(group, refs))
    return _cached(_GOLDEN_GRAPHS, key, lambda: _GoldenGraph(
        state, model, bcs, grid, dt, incremental_cov, fitting, group, refs))


class _Elastic(NamedTuple):
    """What a fitting substep reads of its MPMModel: the per-particle mu
    and lam (the Green StVK stress) and the grid phase's gravity."""

    mu: torch.Tensor
    lam: torch.Tensor
    gravity: torch.Tensor


class _GoldenFittingGraphs(_GoldenStatic):
    """The golden fitting window's two graphs over shared static buffers
    (a golden state, a clock, mu, lam and the cotangents of the carried
    rows, mu and lam): the forward substep and its adjoint, each a
    ``_Captured`` (on CUDA one capture, then replays; on the CPU its body
    run eagerly).

    mu and lam reach a fitting substep only through their buffers, so a
    new logE / y replays the same graphs; the graphs own copies of the
    gravity and the BC set they were captured with.  With a process
    ``group`` (the buffers hold this rank's particle shard) both graphs
    hold the grid's all-reduces among it: the forward's, and in the
    adjoint the recompute's and its VJP's."""

    def __init__(self, state: MPMState, model: MPMModel, bcs,
                 grid: GridConfig, dt: float, incremental_cov: bool,
                 group=None):
        n, device = state.x.shape[0], state.x.device
        super().__init__(n, device)
        self.carried_fields = _carried(incremental_cov)
        self.carried = self.buf[:_SPANS[self.carried_fields[-1]][1]]
        self.dcarried = torch.zeros_like(self.carried)
        f32 = dict(dtype=torch.float32, device=device)
        self.mu, self.lam = torch.zeros(n, **f32), torch.zeros(n, **f32)
        self.dmu, self.dlam = torch.zeros(n, **f32), torch.zeros(n, **f32)
        self.gravity = model.gravity.detach().clone()
        self.bcs = _owned(bcs)
        self.grid, self.dt, self.group = grid, dt, group
        self.incremental_cov = incremental_cov
        self.forward = _Captured(device, run_substeps)
        self.adjoint = _Captured(device, run_substeps)

    def load(self, state: MPMState, time, mu, lam) -> None:
        """The state's planes, the clock and mu / lam into the buffers."""
        super().load(state, time)
        self.mu.copy_(mu)
        self.lam.copy_(lam)

    def _substep(self, soa: SoAState, mu, lam) -> SoAState:
        return substep_soa(soa, _Elastic(mu, lam, self.gravity), self.bcs,
                           self.clock, self.grid, self.dt,
                           incremental_cov=self.incremental_cov,
                           group=self.group, fitting=True)

    def _forward_body(self) -> None:
        """The forward graph's body, in place: ``substep_soa(fitting=True)``
        on the buffers at the clock, its planes copied back, then clock +=
        dt (``_advance``'s value)."""
        _assign(self.soa, self._substep(self.soa, self.mu, self.lam))
        self.clock.add_(self.dt)

    def _adjoint_body(self) -> None:
        """The adjoint graph's body, in place: the substep recomputed from
        the carried rows (the other planes, mu, lam, the clock) with
        autograd on, its VJP against dcarried, the cotangent of its output
        rows; then dcarried := the cotangent of its input rows, and dmu /
        dlam += those of mu / lam.  The leaves are made here, and
        ``autograd.grad`` writes no ``.grad``."""
        rows = self.carried.detach().requires_grad_(True)
        mu = self.mu.detach().requires_grad_(True)
        lam = self.lam.detach().requires_grad_(True)
        with torch.enable_grad():
            soa = self.soa._replace(**{
                f: tuple(rows[_SPANS[f][0]:_SPANS[f][1]])
                for f in self.carried_fields})
            new = self._substep(soa, mu, lam)
            out = [p for f in self.carried_fields for p in getattr(new, f)]
            d_rows, dmu, dlam = torch.autograd.grad(
                out, (rows, mu, lam), tuple(self.dcarried))
        self.dcarried.copy_(d_rows)
        self.dmu.add_(dmu)
        self.dlam.add_(dlam)

    def release(self) -> None:
        self.forward.release()
        self.adjoint.release()

    def step(self) -> None:
        """One forward substep (replay, or warm-up and capture)."""
        self.forward(self._forward_body)

    def adjoint_step(self) -> None:
        """One adjoint substep on the loaded rows, clock and dcarried."""
        self.adjoint(self._adjoint_body)


class _GoldenFittingWindow(torch.autograd.Function):
    """N golden fitting substeps as one autograd node: the port's
    counterpart of gsmpm_tpu's ``jax.checkpoint`` + ``lax.scan`` + ``jit``
    of its golden fitting window (sim/tiles.py's ``_FittingWindow``
    without the rebucket).

    Forward: per substep the carried input rows (x, v, C, F, and cov with
    incremental_cov) kept in a stack (the scan's carries, the checkpoint
    path's memory), then the forward graph.  Backward: the window's other
    planes, mu and lam loaded again, then for k = N-1 ... 0 the adjoint
    graph on row k of the stack and the clock t_k.  Inputs (carried, mu,
    lam, graphs, state, time, n_substeps), carried being state's carried
    planes stacked and state detached; output the carried rows after the
    window.
    """

    @staticmethod
    def forward(ctx, carried, mu, lam, graphs, state, time, n_substeps):
        g = graphs
        g.load(state, time, mu, lam)
        stack = carried.new_empty((n_substeps,) + tuple(carried.shape))
        times = []
        for k in range(n_substeps):
            stack[k].copy_(g.carried)
            times.append(time)
            g.step()
            time = _advance(time, g.dt)
        ctx.graphs, ctx.stack, ctx.times = g, stack, times
        ctx.inputs = (state, mu.detach(), lam.detach())
        return g.carried.clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_carried):
        g = ctx.graphs
        state, mu, lam = ctx.inputs
        g.load(state, 0.0, mu, lam)
        g.dcarried.copy_(d_carried)
        g.dmu.zero_()
        g.dlam.zero_()
        for k in reversed(range(len(ctx.times))):
            g.carried.copy_(ctx.stack[k])
            g.clock.fill_(ctx.times[k])
            g.adjoint_step()
        return (g.dcarried.clone(), g.dmu.clone(), g.dlam.clone(), None,
                None, None, None)


# the golden fitting window's graphs, least recently used first: a single
# device fit's, a mesh step's and camera-DP's (each after a tile-cap
# overflow) side by side
_GOLDEN_FIT_GRAPHS: "collections.OrderedDict[tuple, _GoldenFittingGraphs]" \
    = _register(4)


def _golden_fitting_graphs(state: MPMState, model: MPMModel, bcs,
                           grid: GridConfig, dt: float,
                           incremental_cov: bool = False,
                           group=None) -> _GoldenFittingGraphs:
    """The cached golden fitting graphs of (N, grid, dt, incremental_cov,
    the device, gravity and the BC set by value, the process group by
    identity): a new logE / y (any other field of model) or a new BC set
    with the same values captures nothing, a new group captures anew."""
    key = (state.x.shape[0], grid, dt, incremental_cov, state.x.device,
           _values(model.gravity), _values(bcs), _identity(group, []))
    return _cached(_GOLDEN_FIT_GRAPHS, key, lambda: _GoldenFittingGraphs(
        state, model, bcs, grid, dt, incremental_cov, group))


def _golden_window(state: MPMState, model: MPMModel, bcs, time: float,
                   n_substeps: int, grid: GridConfig, dt: float,
                   incremental_cov: bool = False, group=None):
    """n_substeps golden fitting substeps through ``_GoldenFittingWindow``
    (graphs from ``_golden_fitting_graphs``); differentiable in the state's
    x, v, C and F (cov too with incremental_cov) and in model.mu /
    model.lam.  Returns (state, time)."""
    for name in ("vol", "mass", "density", "init_cov"):
        if getattr(state, name).requires_grad:
            raise ValueError(f"the golden fitting window differentiates x, "
                             f"v, C, F, cov, mu and lam, not {name}")
    if model.gravity.requires_grad:
        raise ValueError("the golden fitting window does not differentiate "
                         "gravity")
    n = state.x.shape[0]
    carried = torch.cat([getattr(state, f).reshape(n, -1).T
                         for f in _carried(incremental_cov)])
    graphs = _golden_fitting_graphs(state, model, bcs, grid, dt,
                                    incremental_cov, group)
    rows = _GoldenFittingWindow.apply(
        carried, model.mu, model.lam, graphs,
        MPMState(**{f.name: getattr(state, f.name).detach()
                    for f in dataclasses.fields(state)}),
        time, n_substeps)
    for _ in range(n_substeps):
        time = _advance(time, dt)

    out = {f: _aos(rows[_SPANS[f][0]:_SPANS[f][1]])
           for f in _carried(incremental_cov)}
    return dataclasses.replace(state, F_trial=out["F"], **out), time


def _records(*objs) -> bool:
    """Whether autograd records a call on objs: grad mode on and a tensor
    in them (dataclasses and tuples walked) requiring grad."""
    if not torch.is_grad_enabled():
        return False

    def any_grad(obj):
        if isinstance(obj, torch.Tensor):
            return obj.requires_grad
        if dataclasses.is_dataclass(obj):
            return any(any_grad(getattr(obj, f.name))
                       for f in dataclasses.fields(obj))
        if isinstance(obj, (tuple, list)):
            return any(any_grad(o) for o in obj)
        return False

    return any_grad(objs)


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
    pass, keeping only the particle state between substeps, the JAX
    package's memory policy; it only matters when autograd records the
    run.  ``time`` is a host float advanced in float32 as the JAX clock.

    On CUDA the run is gsmpm_tpu's one compiled program: when autograd
    does not record the call (grad mode off, or no tensor of state, model
    and bcs requires grad) the substeps replay one cached CUDA graph
    (``_GoldenGraph``, captured once per N, grid, dt, incremental_cov,
    fitting, model, BC set and process group; the returned state owns its
    tensors), and a recorded ``fitting`` call under the "substep" policy
    runs ``_GoldenFittingWindow`` (a forward and an adjoint graph, captured
    once per N, grid, dt, incremental_cov, gravity, BC set and group).
    ``run_substeps.captures`` / ``replays`` count their work.  Elsewhere,
    and for a recorded call of another kind, each substep runs eagerly
    (``torch.utils.checkpoint`` of ``substep_soa`` under the "substep"
    policy).
    """
    if state.x.device.type == "cuda":
        if not _records(state, model, bcs):
            graph = _golden_graph(state, model, bcs, grid, dt,
                                  incremental_cov, fitting, group)
            graph.load(state, time)
            for _ in range(n_substeps):
                graph.step()
                time = _advance(time, dt)
            return graph.state(), time
        if fitting and checkpoint_policy == "substep":
            return _golden_window(state, model, bcs, time, n_substeps, grid,
                                  dt, incremental_cov, group)
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


run_substeps.captures = run_substeps.replays = 0


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
