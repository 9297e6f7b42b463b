"""Particle-sharded simulation frame and tile-sharded render over a mesh.

Port of gsmpm_tpu/parallel/sharded.py's forward pieces
(``make_sharded_frame_fn``, ``make_sharded_render_fn``,
``_render_tile_sharded``) on the multi-process mesh of parallel/mesh.py:

- simulation: each rank runs the golden engine on its particle shard; its
  dense P2G grid (mass and the 3 momentum planes) is all-reduced over the
  mesh before the grid update (``run_substeps(..., group=...)``, the JAX
  engine's ``psum``).  The grid is small (n_grid^3 nodes), so replicate
  and reduce needs no halo bookkeeping;
- rendering: the gaussians are all-gathered, every rank preprocesses and
  depth-sorts all of them (replicated, so n_dropped is the same on every
  rank) and renders a contiguous range of block rows with
  ``render_block_rows`` (kernel K4); the rows are all-gathered.

The sharded fit steps (``make_sharded_fit_step``, ``make_camera_dp_fit_step``)
are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from gsmpm_tpu_torch.parallel.mesh import Mesh, all_gather_cat, gather
from gsmpm_tpu_torch.render.camera import Camera
from gsmpm_tpu_torch.render.renderer import (
    RasterConfig,
    _xla_dropped_count,
    assemble_blocks,
    block_origins,
    preprocess,
    render_block_rows,
)
from gsmpm_tpu_torch.sim.solver import postprocess, run_substeps
from gsmpm_tpu_torch.sim.state import GridConfig


def _render_tile_sharded(means3d, cov6, opacity, shs, camera: Camera, bg,
                         sh_degree: int, rcfg: RasterConfig,
                         mesh: Mesh = None):
    """Full-image render with the block rows split over the mesh's ranks
    (all of them on one device when mesh is None).  Inputs are the full
    (gathered) arrays.  Returns (image, n_dropped over k_row / k_block)."""
    pre = preprocess(means3d, cov6, opacity, shs, camera, sh_degree, rcfg)
    key = torch.where(pre.valid, pre.depth, torch.inf)
    order = torch.sort(key, stable=True).indices
    dropped = _xla_dropped_count(pre, camera, rcfg)
    _, nbx, nby = block_origins(camera, rcfg)
    if mesh is None:
        blocks = render_block_rows(pre, order, 0.0, nby, nbx, bg, rcfg)
        return assemble_blocks(blocks, camera, rcfg), dropped
    rows_local = -(-nby // mesh.world_size)
    y_start = float(mesh.rank * rows_local * rcfg.block)
    blocks = render_block_rows(pre, order, y_start, rows_local, nbx, bg, rcfg)
    blocks = all_gather_cat(blocks, mesh)[: nby * nbx]
    return assemble_blocks(blocks, camera, rcfg), dropped


def make_sharded_frame_fn(mesh: Mesh, bcs, grid: GridConfig, dt: float,
                          n_substeps: int, incremental_cov: bool = False,
                          rotate_sh: bool = False):
    """(state, model, t) -> (state, t, R) on this rank's particle shard,
    the dense grid all-reduced every substep.  R is None unless rotate_sh.
    The particle count must be divisible by the mesh size (pad with
    parallel.mesh.pad_particles first)."""

    def frame(state, model, t):
        state, t = run_substeps(
            state, model, bcs, t, n_substeps, grid, dt,
            checkpoint_policy=None, incremental_cov=incremental_cov,
            group=mesh.group,
        )
        cov6, R = postprocess(state, rotate_sh=rotate_sh)
        return dataclasses.replace(state, cov=cov6), t, R

    return frame


def make_sharded_render_fn(mesh: Mesh, camera: Camera, bg, sh_degree: int,
                           rcfg: RasterConfig = RasterConfig()):
    """fn(means3d, cov6, opacity, shs) on this rank's shard -> (H, W, 3),
    the image replicated on every rank."""

    def render(means3d, cov6, opacity, shs):
        full = gather((means3d, cov6, opacity, shs), mesh)
        img, _ = _render_tile_sharded(*full, camera, bg, sh_degree, rcfg, mesh)
        return img

    return render
