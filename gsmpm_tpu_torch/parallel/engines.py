"""Multi-process engine selection for apps/simulate.

Port of gsmpm_tpu/parallel/engines.py with its ``tiled`` and ``psum``
engines.  ``MeshSimEngine`` puts both behind one
(state, model, t) -> (state, t, R) step on this rank's particle shard:

- ``tiled`` -- CUDA default: the chunk-sharded tiled engine
  (parallel/tiled_sharded.py, kernels K1 / K2 on each rank's chunks, one
  blocked-grid all-reduce per substep);
- ``psum`` -- everywhere else, and with ``incremental_cov``: the golden
  engine on the particle shard with the dense grid all-reduced
  (parallel/sharded.py).  Always valid; also the redo path when the tiled
  engine's ``ok`` flag trips.

Fallback semantics are the JAX package's: a frame whose engine reports
not-ok is redone from the same start state on the psum engine, which
stays in use from then on, and the switch is announced.

The halo engines (``halo``, ``halo_tiled``, ``halo_tiled2d``) are not
ported yet (ROADMAP A4).  System identification on a mesh takes its own
engines (``tiled_vjp``, ``golden``) in parallel/sharded.py's fit steps.  Where the JAX package would pick
``halo_tiled`` (TPU, n_grid >= 96) the port picks ``tiled``: another
engine, the same result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from gsmpm_tpu_torch.parallel.mesh import Mesh, gather
from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa
from gsmpm_tpu_torch.sim.solver import postprocess
from gsmpm_tpu_torch.sim.state import GridConfig
from gsmpm_tpu_torch.sim.tiles import bootstrap, unpack_q

ENGINES = ("tiled", "psum")
NOT_PORTED = ("halo", "halo_tiled", "halo_tiled2d")


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


class MeshSimEngine:
    """Forward-sim engine over a mesh with selection and fallback.

    frame(state, model, t) -> (state', t', R) on this rank's particle
    shard (R is None unless rotate_sh).  ``engine`` names the path in use
    ("tiled" | "psum"); it may change to "psum" after a fallback.
    """

    def __init__(self, mesh: Mesh, bcs, grid: GridConfig, substep_dt: float,
                 n_steps: int, incremental_cov: bool = False,
                 rotate_sh: bool = False, prefer: Optional[str] = None,
                 quiet: bool = True):
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
        self.engine = self._select(prefer)

    def _select(self, prefer: Optional[str]) -> str:
        """``engine=`` when given; else ``tiled`` on CUDA without
        incremental_cov (the JAX package's TPU order minus the halo
        engines), else ``psum``."""
        if prefer is not None:
            if prefer not in ENGINES:
                raise ValueError(f"engine {prefer!r}: the port has {ENGINES}")
            return prefer
        if self.mesh.device.type == "cuda" and not self.incremental_cov:
            return "tiled"
        return "psum"

    def _post(self, state):
        cov6, R = postprocess(state, rotate_sh=self.rotate_sh)
        return dataclasses.replace(state, cov=cov6), R

    def _frame_psum(self, state, model, t):
        if self._psum_fn is None:
            from gsmpm_tpu_torch.parallel.sharded import make_sharded_frame_fn

            self._psum_fn = make_sharded_frame_fn(
                self.mesh, self.bcs, self.grid, self.dt, self.n_steps,
                self.incremental_cov, self.rotate_sh)
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
                mesh, model, self.bcs, self.grid, tc, self.dt, self.n_steps,
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

    def frame(self, state, model, t):
        if self.engine == "tiled":
            out = self._frame_tiled(state, model, t)
            if out is not None:
                return out
            if not self.quiet and self.mesh.rank == 0:
                print("(tiled engine cap overflow: falling back to the "
                      "psum-sharded engine)", flush=True)
            self.engine = "psum"
        return self._frame_psum(state, model, t)


def make_mesh_render_fn(mesh: Mesh, camera, bg, sh_degree: int, rcfg,
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
