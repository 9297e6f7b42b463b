"""x-tile-slab halo engine: the halo decomposition with the tiled
transfer (kernels K1 and K2) on each rank.

Port of gsmpm_tpu/parallel/halo_tiled.py on the multi-process mesh of
parallel/mesh.py.  Each rank owns a slab of whole 8-cell x-tiles, runs the
tiled substep (sim/tiles.py:substep_tiled, K1 / K2 on CUDA, their twins on
the CPU) on its own particles, and exchanges only boundary x-tile slabs of
the blocked grid with its two neighbours:

- slab boundaries are equal-particle-count x-quantiles snapped to tiles
  (``quantile_tile_starts``), at least 2 tiles a slab, so n_grid >=
  16 * ranks; particle slots, capacity and migration are parallel/halo.py's
  with the starts in cells (8 x the tile starts) and a margin of one tile;
- per substep, in substep_tiled's ``grid_reduce`` hook, the folded
  (T,T,T,32,64) accumulation of a rank is nonzero only on padded x-tiles
  [t0-1, t1+1); the W = 2 tile slabs beyond each boundary go to the owner,
  who adds them in (``_exchange_accum_tiles``).  In the ``grid_exchange``
  hook, after the grid update and BCs, the x-tiles the rank does not own
  are zeroed and the owners' boundary velocity slabs fetched the same way
  (``_exchange_edges_tiles``).  That is 2 x (W,T,T,32,64) plus
  2 x (3,W,T,T,8,64) float32 a substep for an inner rank, half for an edge
  rank, whatever the number of ranks;
- each segment of ``migrate_every`` substeps bootstraps the tiled layout
  from the rank's slots; rebucketing on drift stays local (no collective
  inside it); at the segment's end the slots come back in slot order and
  migrate.

``ok`` is the MIN over the ranks of the slot capacity at bootstrap and
migration, the tile cap at every bootstrap and rebucket, and drift beyond
one tile, reduced before the host reads it.  gsmpm_tpu ANDs each device's
own tile-cap flag into an ``ok`` it returns under a replicated out_spec
without a reduction, which reports device 0's flag only (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gsmpm_tpu_torch.parallel.halo import (
    HaloConfig,
    _dyn_add,
    _slab,
    all_ranks_ok,
    bootstrap_slots,
    migrate_neighbor_slots,
    original_order_view,
    segment_plan,
)
from gsmpm_tpu_torch.parallel.mesh import Mesh, neighbor_ppermute
from gsmpm_tpu_torch.sim.state import GridConfig, MPMModel
from gsmpm_tpu_torch.sim.tiles import (
    T_TILE,
    TileConfig,
    _advance,
    bootstrap,
    substep_tiled,
    to_original_order,
    unpack_q,
)

_W = 2  # exchanged tile-slab width a direction (the window and a drift)


def _axis_quantile_starts(coord: np.ndarray, nt: int, inv_dx: float,
                          ndev: int) -> Optional[np.ndarray]:
    """Equal-count quantile tile starts along one coordinate, or None when
    the slabs cannot all be >= 2 tiles wide."""
    tiles = np.clip((coord * inv_dx).astype(np.int64) // T_TILE, 0, nt - 1)
    qs = np.quantile(tiles, np.linspace(0.0, 1.0, ndev + 1))
    starts = np.round(qs).astype(np.int64)
    starts[0], starts[-1] = 0, nt
    # >= 2 tiles a slab: push up, then back down (a scene in a sub-range
    # of the axis still gives valid slabs, with lighter edge ranks)
    for d in range(1, ndev):
        starts[d] = max(starts[d], starts[d - 1] + 2)
    for d in range(ndev - 1, 0, -1):
        starts[d] = min(starts[d], starts[d + 1] - 2)
    if (np.diff(starts) < 2).any():
        return None
    return starts


def quantile_tile_starts(
    x: np.ndarray, n_grid: int, grid_extent: float, ndev: int,
    cap_slack: float = 1.5,
) -> Optional[Tuple[Tuple[int, ...], HaloConfig, TileConfig]]:
    """Equal-count x-quantile slab boundaries snapped to 8-cell tiles.

    Returns (tile_starts, halo_cfg, tile_cfg) or None when the grid or the
    scene cannot give every rank >= 2 tiles.  halo_cfg.margin is one tile
    (8 cells), matching the W = 2 exchange.  The tile config's occupied-tile
    cap is the geometric bound (slab plus one tile each side) intersected
    with a particle-derived one; an overflow at run time trips ``ok``.
    """
    nt = -(-n_grid // T_TILE)
    if nt < 2 * ndev:
        return None
    x = np.asarray(x)
    n = x.shape[0]
    starts = _axis_quantile_starts(x, nt, n_grid / grid_extent, ndev)
    if starts is None:
        return None
    cap = int(-(-int(n * cap_slack) // (128 * ndev)) * 128)
    hc = HaloConfig(ndev=ndev, n_grid=n_grid, cap=cap, margin=T_TILE)
    max_w = int(np.diff(starts).max())
    occ_cap = min(nt ** 3, (max_w + 2) * nt * nt,
                  max(256, 4 * (-(-hc.cap // 256))))
    tc = TileConfig(n_grid, hc.cap, S=256, n_occ_cap=occ_cap)
    return tuple(int(s) for s in starts), hc, tc


def cell_starts(tile_starts, n_grid: int) -> Tuple[int, ...]:
    """Tile starts -> cell starts (8 per tile, the last clipped to n_grid)."""
    return tuple(min(t * T_TILE, n_grid) for t in tile_starts)


def _exchange_accum_tiles(acc, t0: int, t1: int, mesh: Mesh, axis,
                          adim: int = 0):
    """P2G phase: route boundary tile-slab contributions to their owner.

    acc (T,T,T,32,64), dimension ``adim`` the padded tile axis decomposed
    (0 = x, 1 = y).  A rank's particles (its slab and a tile of drift)
    touch padded tiles [t0-1, t1+1) along it; the W-wide slabs outside
    [t0, t1) go to the neighbours, who add them in (halo.py's protocol in
    tile units).  The 2-D engine runs it once per mesh axis, x first: the
    x-pass moves corner contributions into the right x-range, the y-pass
    finishes, exact since the accumulation is linear."""
    T = acc.shape[adim]
    left_out = _slab(acc, max(t0 - _W, 0), _W, adim)
    right_out = _slab(acc, min(t1, T - _W), _W, adim)
    from_left, from_right = neighbor_ppermute(left_out, right_out, mesh,
                                              axis)
    acc = _dyn_add(acc, from_left, min(t0, T - _W), adim)
    return _dyn_add(acc, from_right, max(t1 - _W, 0), adim)


def _fetch_edges_stacked(gv, t0: int, t1: int, mesh: Mesh, axis,
                         adim: int = 0):
    """Send the owned edge tile-slabs along one axis; the neighbours add
    them into their zeroed non-owned tiles (a copy).  gv (3,T,T,T,8,64);
    adim 0 = x tiles (dimension 1), 1 = y tiles (dimension 2).  In 2-D the
    y-pass slab spans the whole x-range, so the tiles fetched in the x-pass
    ride on to the diagonal neighbours."""
    ax = 1 + adim
    T = gv.shape[ax]
    left_edge = _slab(gv, min(t0, T - _W), _W, ax)
    right_edge = _slab(gv, max(t1 - _W, 0), _W, ax)
    from_left, from_right = neighbor_ppermute(left_edge, right_edge, mesh,
                                              axis)
    gv = _dyn_add(gv, from_left, max(t0 - _W, 0), ax)
    return _dyn_add(gv, from_right, min(t1, T - _W), ax)


def _own_mask_stacked(gv, t0: int, t1: int, index: int, ndev: int,
                      adim: int = 0):
    """Ownership along one tile axis of the stacked (3,T,...) planes.  The
    last padded tile (index nt) still holds real cells [g-4, g), so the
    last rank owns it too."""
    ax = 1 + adim
    shape = [1] * gv.ndim
    shape[ax] = gv.shape[ax]
    xt = torch.arange(gv.shape[ax], device=gv.device).reshape(shape)
    t1_own = t1 + 1 if index == ndev - 1 else t1
    return (xt >= t0) & (xt < t1_own)


def _exchange_edges_tiles(grid_v, t0: int, t1: int, mesh: Mesh, axis):
    """G2P phase: zero the x-tiles outside [t0, t1), fetch the owners'
    boundary velocities.  grid_v: 3 planes (T,T,T,8,64)."""
    gv = torch.stack(grid_v)
    own = _own_mask_stacked(gv, t0, t1, mesh.axis_index(axis),
                            mesh.axis_size(axis), 0)
    gv = _fetch_edges_stacked(torch.where(own, gv, 0.0), t0, t1, mesh, axis,
                              0)
    return tuple(gv[r] for r in range(3))


def bootstrap_slots_tiled(state, model: MPMModel, tile_starts,
                          grid: GridConfig, hc: HaloConfig):
    """halo.bootstrap_slots with the starts given in tiles; returns
    (slots and ok, cell starts)."""
    cells = cell_starts(tile_starts, hc.n_grid)
    return bootstrap_slots(state, model, cells, grid, hc), cells


def tiled_segment(soa, aux, material, orig, model: MPMModel, bcs, time: float,
                  n_substeps: int, grid: GridConfig, tc: TileConfig, dt: float,
                  grid_reduce, grid_exchange):
    """One segment of a rank's slots through the tiled substep: bootstrap
    the layout, substeps with the halo hooks, back to slot order.  Returns
    (soa, time, ok): ok ANDs the tile-cap flag of the bootstrap and of
    every substep's rebucket (sticky: a later rebucket within the cap does
    not hide an overflow that dropped particles)."""
    model_l = dataclasses.replace(model, mu=aux[0], lam=aux[1],
                                  viscosity=aux[2], material=material)
    ts = bootstrap(soa, model_l, grid, tc)
    ok = ts.ok
    for _ in range(n_substeps):
        ts = substep_tiled(ts, model_l, bcs, time, grid, tc, dt,
                           rebucket_on_drift=True, grid_reduce=grid_reduce,
                           grid_exchange=grid_exchange)
        ok = ok & ts.ok
        time = _advance(time, dt)
    # the layout's orig maps its slots to this rank's slot indices
    return unpack_q(to_original_order(ts, soa.mass.shape[0]), soa), time, ok


def make_halo_tiled_frame(mesh: Mesh, axis, bcs, grid: GridConfig,
                          hc: HaloConfig, tc: TileConfig, dt: float,
                          n_substeps: int, migrate_every: int = 10):
    """Build the frame step of this rank: tiled local substeps (K1 / K2)
    with the x-tile-slab halo exchange.

    frame(soa, aux, material, orig, tile_starts, model, time) ->
    (soa', aux', material', orig', full, time', ok)

    halo.make_halo_frame's slot protocol; ok (equal on every rank) is False
    on a slot or tile-cap overflow on any rank or on drift beyond one tile:
    the caller redoes the frame on psum.
    """
    n_seg, seg_len = segment_plan(n_substeps, migrate_every)
    i = mesh.axis_index(axis)

    def frame(soa, aux, material, orig, tstarts, model, time):
        t0, t1 = tstarts[i], tstarts[i + 1]
        cells = cell_starts(tstarts, hc.n_grid)

        def grid_reduce(acc):
            return _exchange_accum_tiles(acc, t0, t1, mesh, axis)

        def grid_exchange(grid_v):
            return _exchange_edges_tiles(grid_v, t0, t1, mesh, axis)

        ok = torch.ones((), dtype=torch.bool, device=soa.mass.device)
        for _ in range(n_seg):
            soa, time, ok_t = tiled_segment(
                soa, aux, material, orig, model, bcs, time, seg_len, grid, tc,
                dt, grid_reduce, grid_exchange)
            tile = torch.floor(soa.x[0] * grid.inv_dx).to(torch.int64) \
                // T_TILE
            drift = (orig >= 0) & ((tile < t0 - 1) | (tile >= t1 + 1))
            soa, aux, material, orig, ok_m = migrate_neighbor_slots(
                soa, aux, material, orig, cells, grid, hc, axis, mesh=mesh)
            ok = ok & ok_t & ~torch.any(drift) & ok_m
        full = original_order_view(soa, orig, hc.ndev * hc.cap, mesh)
        return soa, aux, material, orig, full, time, all_ranks_ok(ok, mesh)

    return frame
