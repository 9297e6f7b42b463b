"""2-D (x, y) tile-rectangle halo engine with the tiled transfer (kernels
K1 and K2) on each rank.

Port of gsmpm_tpu/parallel/halo_tiled2d.py on the multi-process mesh of
parallel/mesh.py.  The 1-D x-slab engine (halo_tiled.py) needs >= 2
x-tiles a rank; this one lays the ranks on a ("hx", "hy") mesh and rank
(ix, iy) owns the tile rectangle [txs[ix], txs[ix+1]) x [tys[iy],
tys[iy+1]), so each axis needs only 2 tiles per mesh row or column.

It is the 1-D machinery once per axis, on that axis's process group:

- P2G accumulation: ``_exchange_accum_tiles`` along "hx" (x tiles), then
  along "hy" (y tiles); corner contributions ride two hops, exact because
  the x-pass moves them into the right x-range and the sum is linear;
- grid velocities: masked to the owned rectangle (the last rank of each
  axis owns the extra padded tile), then ``_fetch_edges_stacked`` along
  "hx" and then "hy"; the y-pass slabs span the whole x-range, so corner
  tiles fetched in the x-pass ride on to the diagonal neighbours;
- migration: halo.py's neighbour exchange along "hx" keyed on x, then
  along "hy" keyed on y.  Each row takes its own neighbour / gathered
  branch on its axis group's flag, so no collective of a branch spans the
  world.

``ok`` is reduced with MIN over the world before the host reads it
(gsmpm_tpu returns device 0's, ROADMAP C).
"""

from __future__ import annotations

import numpy as np
import torch

from gsmpm_tpu_torch.parallel.halo import (
    HaloConfig,
    _device_of,
    _mid,
    _segments,
    _take_slots,
    all_ranks_ok,
    migrate_neighbor_slots,
    original_order_view,
    segment_plan,
)
from gsmpm_tpu_torch.parallel.halo_tiled import (
    _axis_quantile_starts,
    _exchange_accum_tiles,
    _fetch_edges_stacked,
    _own_mask_stacked,
    cell_starts,
    tiled_segment,
)
from gsmpm_tpu_torch.parallel.mesh import Mesh
from gsmpm_tpu_torch.sim.kernels import SoAState, soa_from_state
from gsmpm_tpu_torch.sim.state import GridConfig, MPMModel
from gsmpm_tpu_torch.sim.tiles import T_TILE, TileConfig


def quantile_tile_starts_2d(xy: np.ndarray, n_grid: int, grid_extent: float,
                            dx: int, dy: int, cap_slack: float = 1.5):
    """(x, y) quantile tile rectangles for a dx x dy mesh.

    Returns (txs, tys, hc2, tc) or None when either axis cannot give every
    mesh row / column >= 2 tiles.  hc2.cap is the slot count a rank, from
    the rectangles' actual occupancy (tile-snapped quantiles of a
    concentrated scene are imbalanced)."""
    nt = -(-n_grid // T_TILE)
    if nt < 2 * dx or nt < 2 * dy:
        return None
    xy = np.asarray(xy)
    inv_dx = n_grid / grid_extent
    txs = _axis_quantile_starts(xy[:, 0], nt, inv_dx, dx)
    tys = _axis_quantile_starts(xy[:, 1], nt, inv_dx, dy)
    if txs is None or tys is None:
        return None
    ndev = dx * dy
    tilex = np.clip((xy[:, 0] * inv_dx).astype(np.int64) // T_TILE, 0, nt - 1)
    tiley = np.clip((xy[:, 1] * inv_dx).astype(np.int64) // T_TILE, 0, nt - 1)
    devx = np.searchsorted(txs[1:-1], tilex, side="right")
    devy = np.searchsorted(tys[1:-1], tiley, side="right")
    counts = np.bincount(devx * dy + devy, minlength=ndev)
    cap = int(max(128, -(-int(counts.max() * cap_slack) // 128) * 128))
    hc2 = HaloConfig(ndev=ndev, n_grid=n_grid, cap=cap, margin=T_TILE)
    max_wx = int(np.diff(txs).max())
    max_wy = int(np.diff(tys).max())
    occ_cap = min(nt ** 3, (max_wx + 2) * (max_wy + 2) * nt,
                  max(256, 4 * (-(-cap // 256))))
    tc = TileConfig(n_grid, cap, S=256, n_occ_cap=occ_cap)
    return (tuple(int(s) for s in txs), tuple(int(s) for s in tys), hc2,
            tc)


def _axis_config(hc2: HaloConfig, n: int) -> HaloConfig:
    return HaloConfig(ndev=n, n_grid=hc2.n_grid, cap=hc2.cap,
                      margin=hc2.margin)


def partition_slots_2d(soa: SoAState, aux, material, orig, cell_xs, cell_ys,
                       grid: GridConfig, hc2: HaloConfig, dx: int, dy: int):
    """Repartition slots into per-rectangle segments: rank (ix, iy) owns
    segment ix * dy + iy (row-major, the order of the ("hx", "hy") mesh's
    ranks).  halo.partition_slots' protocol; dead slots park at the
    rectangle centre."""
    devx = _device_of(soa.x[0], cell_xs, grid, _axis_config(hc2, dx))
    devy = _device_of(soa.x[1], cell_ys, grid, _axis_config(hc2, dy))
    ndev = dx * dy
    dev = torch.where(orig >= 0, devx * dy + devy, ndev)
    live, src, ok, d_ids = _segments(dev, ndev, hc2.cap)
    xs = torch.as_tensor(cell_xs, dtype=torch.int64, device=dev.device)
    ys = torch.as_tensor(cell_ys, dtype=torch.int64, device=dev.device)
    ix, iy = d_ids // dy, d_ids % dy
    park = (_mid(xs[ix], xs[ix + 1], grid), _mid(ys[iy], ys[iy + 1], grid),
            float(np.float32(0.5 * hc2.n_grid * grid.dx)))
    return (*_take_slots(soa, aux, material, orig, live, src, park), ok)


def bootstrap_slots_2d(state, model: MPMModel, txs, tys, grid: GridConfig,
                       hc2: HaloConfig, dx: int, dy: int):
    """Original-order state -> the 2-D partitioned slot arrays of every
    rank (a rank keeps segment ix * dy + iy)."""
    soa = state if isinstance(state, SoAState) else soa_from_state(state)
    n = soa.mass.shape[0]
    aux = torch.stack([model.mu, model.lam, model.viscosity])
    orig = torch.arange(n, dtype=torch.int64, device=soa.mass.device)
    return partition_slots_2d(
        soa, aux, model.material.to(torch.int32), orig,
        cell_starts(txs, hc2.n_grid), cell_starts(tys, hc2.n_grid), grid,
        hc2, dx, dy)


def make_halo_tiled2d_frame(mesh: Mesh, ax_x: str, ax_y: str, bcs,
                            grid: GridConfig, hc2: HaloConfig, tc: TileConfig,
                            dt: float, n_substeps: int,
                            migrate_every: int = 10):
    """Build the frame step of this rank over the (ax_x, ax_y) rectangles.

    frame(soa, aux, material, orig, txs, tys, model, time) ->
    (soa', aux', material', orig', full, time', ok)

    halo_tiled.make_halo_tiled_frame's protocol with every exchange and
    migration once per mesh axis, x first.
    """
    dx, dy = mesh.axis_size(ax_x), mesh.axis_size(ax_y)
    hx, hy = _axis_config(hc2, dx), _axis_config(hc2, dy)
    ix, iy = mesh.axis_index(ax_x), mesh.axis_index(ax_y)
    n_seg, seg_len = segment_plan(n_substeps, migrate_every)

    def frame(soa, aux, material, orig, txs, tys, model, time):
        tx0, tx1 = txs[ix], txs[ix + 1]
        ty0, ty1 = tys[iy], tys[iy + 1]
        cell_xs, cell_ys = (cell_starts(txs, hc2.n_grid),
                            cell_starts(tys, hc2.n_grid))

        def grid_reduce(acc):
            acc = _exchange_accum_tiles(acc, tx0, tx1, mesh, ax_x, adim=0)
            return _exchange_accum_tiles(acc, ty0, ty1, mesh, ax_y, adim=1)

        def grid_exchange(grid_v):
            gv = torch.stack(grid_v)
            own = (_own_mask_stacked(gv, tx0, tx1, ix, dx, adim=0)
                   & _own_mask_stacked(gv, ty0, ty1, iy, dy, adim=1))
            gv = torch.where(own, gv, 0.0)
            gv = _fetch_edges_stacked(gv, tx0, tx1, mesh, ax_x, adim=0)
            gv = _fetch_edges_stacked(gv, ty0, ty1, mesh, ax_y, adim=1)
            return tuple(gv[r] for r in range(3))

        ok = torch.ones((), dtype=torch.bool, device=soa.mass.device)
        for _ in range(n_seg):
            soa, time, ok_t = tiled_segment(
                soa, aux, material, orig, model, bcs, time, seg_len, grid, tc,
                dt, grid_reduce, grid_exchange)
            tx = torch.floor(soa.x[0] * grid.inv_dx).to(torch.int64) \
                // T_TILE
            ty = torch.floor(soa.x[1] * grid.inv_dx).to(torch.int64) \
                // T_TILE
            drift = (orig >= 0) & ((tx < tx0 - 1) | (tx >= tx1 + 1)
                                   | (ty < ty0 - 1) | (ty >= ty1 + 1))
            soa, aux, material, orig, ok_x = migrate_neighbor_slots(
                soa, aux, material, orig, cell_xs, grid, hx, ax_x, coord=0,
                mesh=mesh)
            soa, aux, material, orig, ok_y = migrate_neighbor_slots(
                soa, aux, material, orig, cell_ys, grid, hy, ax_y, coord=1,
                mesh=mesh)
            ok = ok & ok_t & ~torch.any(drift) & ok_x & ok_y
        full = original_order_view(soa, orig, dx * dy * hc2.cap, mesh)
        return soa, aux, material, orig, full, time, all_ranks_ok(ok, mesh)

    return frame
