"""Chunk-sharded tiled MPM engine: kernels K1 and K2 per rank, one grid
all-reduce per substep.

Port of gsmpm_tpu/parallel/tiled_sharded.py on the multi-process mesh of
parallel/mesh.py:

- the particles, in the tiled engine's S-aligned chunk layout, are split
  over the ranks: each holds nchunk / N contiguous chunks and runs the
  particle phase, P2G (K1) and G2P (K2) on them only, with the kernels
  unchanged (they take the chunk count from the tables they are given);
- the folded blocked grid of each rank is all-reduced once per substep;
  the grid update, the BCs and the window extraction then run
  replicated;
- rebucketing is global, at the start of every segment of
  ``rebucket_every`` substeps, as in the JAX engine: the chunks are
  all-gathered, rebucketed identically on every rank and re-sliced;
- a segment's substeps are gsmpm_tpu's ``sub_body`` scan: the cached
  substep graph of sim/tiles.py (``_substep_graph`` with the group) is
  loaded with the rebucketed slice and the host clock, then stepped
  ``rebucket_every`` times with no host read.  On CUDA each step replays
  one CUDA graph that holds the grid's NCCL all-reduce; on the CPU the
  same body runs eagerly (``substep_tiled(..., group=...)``'s work);
- ``ok`` goes False on a tile-cap overflow at a rebucket or on hard drift
  (a real particle whose stencil base left its window's support, a flag
  all-reduced with MAX at the end of each segment), the same on every
  rank; the caller (parallel/engines.py) reads it once a frame and then
  redoes the frame on the psum engine.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gsmpm_tpu_torch.parallel.mesh import Mesh, all_gather_cat
from gsmpm_tpu_torch.sim.state import GridConfig, MPMModel
from gsmpm_tpu_torch.sim.tiles import (
    LOCAL_MAX,
    LOCAL_MIN,
    PAD_LO,
    RMASS,
    RX,
    T_TILE,
    TileConfig,
    TiledState,
    _advance,
    _substep_graph,
    default_tile_config,
    rebucket,
    to_original_order,
)


def sharded_tile_config(n_grid: int, n_particles: int,
                        ndev: int) -> TileConfig:
    """default_tile_config with nchunk padded to a multiple of ndev."""
    tc = default_tile_config(n_grid, n_particles)
    pad = (-tc.nchunk) % ndev
    if pad:
        tc = tc._replace(n_occ_cap=tc.n_occ_cap + pad)
    return tc


_SLOT_FIELDS = ("q", "aux", "material", "orig")
_CHUNK_FIELDS = ("chunk_tile", "chunk_first", "chunk_live")


def shard_tiled(ts: TiledState, mesh: Mesh, tc: TileConfig) -> TiledState:
    """This rank's contiguous slice of a global TiledState's chunks."""
    ncl = tc.nchunk // mesh.world_size
    c0, s0 = mesh.rank * ncl, mesh.rank * ncl * tc.S
    out = {f: getattr(ts, f)[..., s0:s0 + ncl * tc.S].contiguous()
           for f in _SLOT_FIELDS}
    out.update({f: getattr(ts, f)[c0:c0 + ncl].contiguous()
                for f in _CHUNK_FIELDS})
    return dataclasses.replace(ts, **out)


def gather_tiled(ts: TiledState, mesh: Mesh) -> TiledState:
    """The global TiledState from every rank's slice (all-gathers)."""
    out = {f: all_gather_cat(getattr(ts, f), mesh, dim=getattr(ts, f).ndim - 1)
           for f in _SLOT_FIELDS}
    out.update({f: all_gather_cat(getattr(ts, f), mesh)
                for f in _CHUNK_FIELDS})
    return dataclasses.replace(ts, **out)


def _hard_drift(q: torch.Tensor, grid: GridConfig, tc: TileConfig,
                chunk_tile: torch.Tensor) -> torch.Tensor:
    """True if any real particle's stencil base left its window support."""
    nt, g = tc.nt, tc.n_grid
    ct = chunk_tile.to(torch.int64)
    torg = torch.stack([(ct // (nt * nt)) * T_TILE, ((ct // nt) % nt) * T_TILE,
                        (ct % nt) * T_TILE]).to(torch.float32)
    torg_slots = torch.repeat_interleave(torg, tc.S, dim=1)
    basep = torch.clamp(torch.floor(q[RX:RX + 3] * grid.inv_dx - 0.5),
                        -1, g - 1) + PAD_LO
    local = basep - torg_slots
    bad = (q[RMASS:RMASS + 1] > 0) & ((local < LOCAL_MIN) | (local > LOCAL_MAX))
    return torch.any(bad)


def make_sharded_frame_tiled(mesh: Mesh, *, model: MPMModel, bcs,
                             grid: GridConfig, tc: TileConfig, dt: float,
                             n_substeps: int, rebucket_every: int = 10):
    """Build the sharded frame step: (ts, time) -> (ts, q, time).

    ts is this rank's slice of a global TiledState (``shard_tiled``); q is
    the (QROWS, n_particles) packed state in original particle order,
    replicated on every rank.  ts.ok is False, the same on every rank, on a
    tile-cap overflow or hard drift.  Every rank runs the same segments, so
    every rank replays (or, once, warms up and captures) the same graph in
    the same order; ``frame_tiled.captures`` / ``replays`` count them.
    """
    ndev = mesh.world_size
    if tc.nchunk % ndev:
        raise ValueError("pad nchunk to the mesh (sharded_tile_config)")
    seg = min(rebucket_every, n_substeps)
    if n_substeps % seg:
        raise ValueError("n_substeps must be a multiple of rebucket_every")

    def gathered_rebucket(ts_loc: TiledState) -> TiledState:
        # replicated global rebucket: gather the slices, recompute, re-slice
        full = rebucket(gather_tiled(ts_loc, mesh), grid, tc)
        return shard_tiled(full, mesh, tc)

    def frame(ts_loc: TiledState, time: float):
        ok = ts_loc.ok
        for _ in range(n_substeps // seg):
            ts_loc = gathered_rebucket(ts_loc)
            ok = ok & ts_loc.ok
            graph = _substep_graph(ts_loc, model, bcs, grid, tc, dt,
                                   mesh.group)
            graph.load(ts_loc, time)
            for _ in range(seg):
                graph.step()
                time = _advance(time, dt)
            ts_loc = graph.ts  # the buffers: the next rebucket gathers them
            bad = _hard_drift(ts_loc.q, grid, tc,
                              ts_loc.chunk_tile).to(torch.int32).reshape(1)
            dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=mesh.group)
            ok = ok & (bad[0] == 0)
        ts_loc = dataclasses.replace(graph.state(), ok=ok)
        # original-order view: local scatter + all-reduce (orig is global)
        q_full = to_original_order(ts_loc, tc.n_particles).contiguous()
        dist.all_reduce(q_full, group=mesh.group)
        return ts_loc, q_full, time

    return frame
