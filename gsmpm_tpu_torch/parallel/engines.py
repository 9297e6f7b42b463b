"""Multi-process engine selection for apps/simulate.

Port of gsmpm_tpu/parallel/engines.py.  ``MeshSimEngine`` puts the mesh
engines behind one (state, model, t) -> (state, t, R) step on this rank's
particle shard:

- ``tiled`` -- CUDA: the chunk-sharded tiled engine
  (parallel/tiled_sharded.py, K1 / K2 on each rank's chunks, one
  blocked-grid all-reduce a substep);
- ``halo`` -- elsewhere at n_grid >= 64: x-slabs of cells, the golden
  engine on each rank, halo strips exchanged (parallel/halo.py);
- ``halo_tiled2d`` -- elsewhere after ``halo``, when x-slabs do not fit:
  (x, y) tile rectangles of a 2-D mesh, K1 / K2 (their twins on the CPU)
  on each rank's particles (parallel/halo_tiled2d.py);
- ``psum`` -- everywhere else, and with ``incremental_cov``: the golden
  engine on the particle shard with the dense grid all-reduced
  (parallel/sharded.py).  Always valid; also the redo path when another
  engine's ``ok`` flag trips;
- ``halo_tiled`` -- by name only: x-tile slabs owned per rank, K1 / K2
  on each rank's particles, boundary tile-slabs exchanged with the
  neighbours (parallel/halo_tiled.py).

gsmpm_tpu puts halo_tiled and halo_tiled2d ahead of tiled on its TPU at
n_grid >= 96; on four H100s halo_tiled ran slower than tiled, so the
port keeps tiled first on CUDA (ROADMAP C).  A halo engine whose scene
is too narrow for its slabs falls through to the next engine in the
order.  Fallback semantics are the JAX package's: a frame whose engine
reports not-ok is redone from the same start state on the psum engine,
which stays in use from then on, and the switch is announced.  System
identification on a mesh takes its own engines (``tiled_vjp``,
``golden``) in parallel/sharded.py's fit steps.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from gsmpm_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    all_ranks,
    gather,
    reshape_mesh,
)
from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa
from gsmpm_tpu_torch.sim.solver import postprocess
from gsmpm_tpu_torch.sim.state import GridConfig
from gsmpm_tpu_torch.sim.tiles import bootstrap, unpack_q

ENGINES = ("halo", "halo_tiled", "halo_tiled2d", "tiled", "psum")
HALO_ENGINES = ("halo", "halo_tiled", "halo_tiled2d")


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def engine_order(prefer: Optional[str], device_type: str, n_grid: int,
                 incremental_cov: bool) -> List[str]:
    """The engines to try: ``prefer`` alone when given; on CUDA without
    incremental_cov, tiled, psum at every n_grid (gsmpm_tpu's TPU order
    starts with halo_tiled, halo_tiled2d at n_grid >= 96; ROADMAP C);
    elsewhere, as gsmpm_tpu, halo, halo_tiled2d, psum at n_grid >= 64
    without incremental_cov; else psum."""
    if prefer is not None:
        if prefer not in ENGINES:
            raise ValueError(f"engine {prefer!r}: the port has {ENGINES}")
        return [prefer]
    if device_type == "cuda" and not incremental_cov:
        return ["tiled", "psum"]
    if n_grid >= 64 and not incremental_cov:
        return ["halo", "halo_tiled2d", "psum"]
    return ["psum"]


def mesh_2d_shape(ndev: int):
    """(dx, dy) of the halo_tiled2d mesh over ndev ranks (dy the largest
    divisor <= sqrt(ndev)), or None for a prime count above 2, which would
    be 1-D (the 1-D engine already declined)."""
    dy = _largest_divisor_leq(ndev, int(np.sqrt(ndev)))
    if dy < 2 and ndev > 2:
        return None
    return ndev // dy, dy


class MeshSimEngine:
    """Forward-sim engine over a mesh with selection and fallback.

    frame(state, model, t) -> (state', t', R) on this rank's particle
    shard (R is None unless rotate_sh).  ``engine`` names the path in use;
    it may change to "psum" after a fallback.  ``state`` (this rank's shard
    of the start state) is needed when a halo engine is in the order: the
    slab quantiles are taken over every rank's gathered x, the same bytes
    and so the same starts and engine on every rank.
    """

    def __init__(self, mesh: Mesh, *, bcs, grid: GridConfig,
                 substep_dt: float, n_steps: int,
                 incremental_cov: bool = False,
                 rotate_sh: bool = False, prefer: Optional[str] = None,
                 quiet: bool = True, state=None):
        self.mesh = mesh
        self.bcs = bcs
        self.grid = grid
        self.dt = substep_dt
        self.n_steps = n_steps
        self.rotate_sh = rotate_sh
        self.incremental_cov = incremental_cov
        self.quiet = quiet
        self._psum_fn = None
        self._tiled = None  # [frame fn, tile config, this rank's TiledState]
        # [(frame fn, bootstrap fn, slots a rank), this rank's slots]
        self._halo = None
        self._geometry = None  # the halo engine's starts and configs
        self.engine = self._select(prefer, state)

    # --- selection -------------------------------------------------------

    def _select(self, prefer: Optional[str], state) -> str:
        order = engine_order(prefer, self.mesh.device.type,
                             self.grid.n_grid, self.incremental_cov)
        x = None
        for name in order:
            if name not in HALO_ENGINES:
                return name
            if x is None:
                if state is None:
                    raise ValueError(f"engine {name} needs the start state "
                                     "(MeshSimEngine(..., state=))")
                x = all_gather_cat(state.x, self.mesh).cpu().numpy()
            geometry = self._halo_geometry(name, x)
            if geometry is not None:  # else too narrow: fall through
                self._geometry = geometry
                return name
        return "psum"

    def _halo_geometry(self, name: str, x: np.ndarray):
        from gsmpm_tpu_torch.parallel import halo, halo_tiled, halo_tiled2d

        g, ext, ndev = self.grid.n_grid, self.grid.grid_extent, \
            self.mesh.world_size
        if name == "halo":
            return halo.quantile_slab_starts(x[:, 0], g, ext, ndev)
        if name == "halo_tiled":
            return halo_tiled.quantile_tile_starts(x[:, 0], g, ext, ndev)
        shape = mesh_2d_shape(ndev)
        if shape is None:
            return None
        res = halo_tiled2d.quantile_tile_starts_2d(x[:, :2], g, ext, *shape)
        if res is None:
            return None
        # every rank lays out the same 2-D mesh, in the same order
        mesh2 = reshape_mesh(self.mesh, (("hx", shape[0]), ("hy", shape[1])))
        return (*res, mesh2)

    # --- engines ---------------------------------------------------------

    def _post(self, state):
        cov6, R = postprocess(state, rotate_sh=self.rotate_sh)
        return dataclasses.replace(state, cov=cov6), R

    def _frame_psum(self, state, model, t):
        if self._psum_fn is None:
            from gsmpm_tpu_torch.parallel.sharded import make_sharded_frame_fn

            self._psum_fn = make_sharded_frame_fn(
                self.mesh, bcs=self.bcs, grid=self.grid, dt=self.dt,
                n_substeps=self.n_steps,
                incremental_cov=self.incremental_cov,
                rotate_sh=self.rotate_sh)
        return self._psum_fn(state, model, t)

    def _frame_tiled(self, state, model, t):
        """One tiled frame, or None when the caller must redo it on psum."""
        from gsmpm_tpu_torch.parallel.tiled_sharded import (
            make_sharded_frame_tiled, shard_tiled, sharded_tile_config,
        )

        mesh = self.mesh
        if self._tiled is None:
            n = state.x.shape[0] * mesh.world_size
            tc = sharded_tile_config(self.grid.n_grid, n, mesh.world_size)
            fn = make_sharded_frame_tiled(
                mesh, model=model, bcs=self.bcs, grid=self.grid, tc=tc,
                dt=self.dt, n_substeps=self.n_steps,
                rebucket_every=_largest_divisor_leq(self.n_steps, 10))
            self._tiled = [fn, tc, None]
        fn, tc, ts = self._tiled
        if ts is None:
            # bootstrap the global layout replicated, keep this rank's chunks
            full_state, full_model = gather((state, model), mesh)
            ts = bootstrap(soa_from_state(full_state), full_model, self.grid,
                           tc)
            if not bool(ts.ok):
                return None
            ts = shard_tiled(ts, mesh, tc)
        ts, q_full, t2 = fn(ts, t)
        if not bool(ts.ok):
            self._tiled[2] = None
            return None
        self._tiled[2] = ts
        nl = state.x.shape[0]
        q = q_full[:, mesh.rank * nl:(mesh.rank + 1) * nl]
        new_state, R = self._post(state_from_soa(
            unpack_q(q, soa_from_state(state))))
        return new_state, t2, R

    def _halo_engine(self):
        """(frame fn taking (slots, model, t), bootstrap of the gathered
        state and model -> (every rank's slots, ok), slots a rank) of the
        halo engine in use."""
        from gsmpm_tpu_torch.parallel import halo, halo_tiled, halo_tiled2d

        me = _largest_divisor_leq(self.n_steps, 10)
        args = (self.bcs, self.grid)
        if self.engine == "halo":
            starts, hc = self._geometry
            fn = halo.make_halo_frame(self.mesh, None, *args, hc, self.dt,
                                      self.n_steps, migrate_every=me)
            return ((lambda slots, model, t: fn(*slots, starts, model, t)),
                    (lambda st, md: halo.bootstrap_slots(
                        st, md, starts, self.grid, hc)), hc.cap)
        if self.engine == "halo_tiled":
            tstarts, hc, tc = self._geometry
            fn = halo_tiled.make_halo_tiled_frame(
                self.mesh, None, *args, hc, tc, self.dt, self.n_steps,
                migrate_every=me)
            return ((lambda slots, model, t: fn(*slots, tstarts, model, t)),
                    (lambda st, md: halo_tiled.bootstrap_slots_tiled(
                        st, md, tstarts, self.grid, hc)[0]), hc.cap)
        txs, tys, hc2, tc, mesh2 = self._geometry
        dx, dy = mesh2.sizes
        fn = halo_tiled2d.make_halo_tiled2d_frame(
            mesh2, "hx", "hy", *args, hc2, tc, self.dt, self.n_steps,
            migrate_every=me)
        return ((lambda slots, model, t: fn(*slots, txs, tys, model, t)),
                (lambda st, md: halo_tiled2d.bootstrap_slots_2d(
                    st, md, txs, tys, self.grid, hc2, dx, dy)), hc2.cap)

    def _frame_halo(self, state, model, t):
        """One frame of the halo engine in use, or None when the caller
        must redo it on psum.  The rank's slots carry over to the next
        frame; a not-ok frame drops them."""
        from gsmpm_tpu_torch.parallel.halo import original_view, rank_segment

        mesh = self.mesh
        if self._halo is None:
            self._halo = [self._halo_engine(), None]
        (fn, boot, cap), slots = self._halo
        if slots is None:
            # partition every rank's particles replicated, keep this rank's
            *every, ok0 = boot(*gather((state, model), mesh))
            if not all_ranks(bool(ok0), mesh):
                return None  # slot capacity overflow at bootstrap
            slots = rank_segment(every, mesh.rank, cap)
        *slots, full, t2, ok = fn(slots, model, t)
        if not ok:
            self._halo[1] = None
            return None
        self._halo[1] = tuple(slots)
        nl = state.x.shape[0]
        out = state_from_soa(original_view(full, (mesh.rank + 1) * nl,
                                           mesh.rank * nl))
        new_state, R = self._post(dataclasses.replace(
            out, init_cov=state.init_cov))
        return new_state, t2, R

    def frame(self, state, model, t):
        if self.engine != "psum":
            out = (self._frame_tiled(state, model, t)
                   if self.engine == "tiled"
                   else self._frame_halo(state, model, t))
            if out is not None:
                return out
            if not self.quiet and self.mesh.rank == 0:
                what = ("cap overflow" if self.engine == "tiled"
                        else "drift/overflow")
                print(f"({self.engine} engine {what}: falling back to the "
                      "psum-sharded engine)", flush=True)
            self.engine = "psum"
        return self._frame_psum(state, model, t)


def make_mesh_render_fn(mesh: Mesh, *, camera, bg, sh_degree: int, rcfg,
                        transform_fn):
    """Tile-sharded app render over the mesh.

    transform_fn(xyz_g, cov_g, R, opacity, features) -> (w_xyz, w_cov,
    opacity, shs) runs on this rank's particle shard (the app's
    grid2world, inverse rotation and SH rotation chain); the gaussians are
    then all-gathered and the block rows split over the same ranks
    (parallel/sharded.py, kernel K4).  Returns fn(xyz_g, cov_g, R,
    opacity, features) -> (image, n_dropped), both replicated.
    """
    from gsmpm_tpu_torch.parallel.sharded import _render_tile_sharded

    def render(xyz_g, cov_g, R, opacity, features):
        full = gather(transform_fn(xyz_g, cov_g, R, opacity, features), mesh)
        return _render_tile_sharded(*full, camera, bg, sh_degree, rcfg, mesh)

    return render
