"""x-slab halo engine: grid ownership by x-slab, neighbour strips and
particle migration, the golden engine on each rank.

Port of gsmpm_tpu/parallel/halo.py on the multi-process mesh of
parallel/mesh.py.  Instead of all-reducing the whole dense grid every
substep (parallel/sharded.py), each rank owns an x-slab of grid cells and
only halo strips move between neighbours:

- slab boundaries are equal-particle-count x-quantiles of the particles,
  snapped to cells (``quantile_slab_starts``, numpy on the host; every rank
  computes them from the same gathered bytes);
- each rank holds ``cap`` particle slots: the particles of its slab (dead
  slots parked at the slab centre, mass 0) and runs stress, P2G, grid
  update and G2P on them with the golden engine (sim/kernels.py) on a dense
  G^3 grid.  With up to ``margin`` cells of drift between migrations every
  stencil write stays within HX = margin + 3 cells of the slab;
- after P2G each rank sends the HX-wide strips of contributions it made in
  its neighbours' slabs to them (``_exchange_accum``); after the grid
  update and BCs it zeroes the cells it does not own and receives the
  owners' boundary velocities (``_exchange_edges``), both with
  ``parallel/mesh.neighbor_ppermute``, O(G^2 HX) bytes a substep;
- every ``migrate_every`` substeps particles move to their new owner:
  neighbour-only buffers of ``mcap`` rows, or the gathered repartition when
  a buffer or the free slots would overflow (decided on an all-reduced
  flag that every rank of the axis reads alike);
- ``ok`` (slot capacity, drift beyond ``margin``) is reduced with MIN over
  the mesh before the host reads it.

Slot order is gsmpm_tpu's slot for slot (stable sorts); the starts of a
slab and a strip clamp as ``lax.dynamic_slice`` clamps them.  Scenes too
narrow for slabs give None from ``quantile_slab_starts``: the engine
selection falls through (parallel/engines.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gsmpm_tpu_torch.ops import m33
from gsmpm_tpu_torch.ops.constitutive import compute_stress_soa
from gsmpm_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    neighbor_ppermute,
)
from gsmpm_tpu_torch.sim.kernels import (
    SoAState,
    g2p_soa,
    grid_update_soa,
    p2g_soa,
    soa_from_state,
)
from gsmpm_tpu_torch.sim.state import GridConfig, MPMModel
from gsmpm_tpu_torch.sim.tiles import _advance


class HaloConfig(NamedTuple):
    """Static decomposition geometry (host-computed)."""

    ndev: int
    n_grid: int
    cap: int        # particle slots per rank
    margin: int = 2  # drift cells tolerated between migrations

    @property
    def HX(self) -> int:
        return self.margin + 3

    @property
    def mcap(self) -> int:
        """Emigrant-buffer rows per direction for neighbour migration:
        cap / 8 covers any boundary layer the margin admits; an overflow
        takes the gathered repartition."""
        return max(128, -(-self.cap // 8 // 128) * 128)


def quantile_slab_starts(
    x: np.ndarray, n_grid: int, grid_extent: float, ndev: int,
    margin: int = 2, cap_slack: float = 1.5,
) -> Optional[Tuple[Tuple[int, ...], HaloConfig]]:
    """Equal-count x-quantile slab boundaries snapped to cells.

    Returns (starts, cfg) with starts an (ndev+1,)-tuple of cell indices
    (starts[0] == 0, starts[-1] == n_grid, every width > HX), or None when
    the particle x-extent is too narrow for valid slabs.
    """
    x = np.asarray(x)
    n = x.shape[0]
    inv_dx = n_grid / grid_extent
    cells = np.clip((x * inv_dx).astype(np.int64), 0, n_grid - 1)
    qs = np.quantile(cells, np.linspace(0.0, 1.0, ndev + 1))
    starts = np.round(qs).astype(np.int64)
    starts[0], starts[-1] = 0, n_grid
    HX = margin + 3
    for d in range(1, ndev):
        starts[d] = max(starts[d], starts[d - 1] + HX + 1)
    if starts[ndev - 1] + HX + 1 > n_grid:
        return None
    widths = np.diff(starts)
    if (widths <= HX).any():
        return None
    cap = int(-(-int(n * cap_slack) // (128 * ndev)) * 128)
    cfg = HaloConfig(ndev=ndev, n_grid=n_grid, cap=cap, margin=margin)
    return tuple(int(s) for s in starts), cfg


# ---------------------------------------------------------------------------
# slot repartitioning (replicated on every rank of the axis)
# ---------------------------------------------------------------------------

_DEAD_F = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def _device_of(xp: torch.Tensor, starts, grid: GridConfig, hc: HaloConfig):
    """The slab of each position: interior boundaries at or below its cell."""
    cell = torch.clamp(torch.floor(xp * grid.inv_dx).to(torch.int64), 0,
                       hc.n_grid - 1)
    b = torch.as_tensor(starts, dtype=torch.int64, device=xp.device)[1:-1]
    return torch.sum(cell[:, None] >= b[None, :], dim=1)


def _map_soa(fn, *soas) -> SoAState:
    """fn over every plane of SoAStates of one layout."""
    out = []
    for parts in zip(*soas):
        if isinstance(parts[0], tuple):
            out.append(tuple(fn(*p) for p in zip(*parts)))
        else:
            out.append(fn(*parts))
    return SoAState(*out)


def _take_slots(soa: SoAState, aux, material, orig, live, src, park):
    """Slot arrays gathered from src where live, else dead: parked at
    ``park`` (3 positions), F = I, everything else 0, orig -1."""
    def take(plane, dead):
        return torch.where(live, plane[src], dead)

    out = SoAState(
        x=tuple(take(p, d) for p, d in zip(soa.x, park)),
        v=tuple(take(p, 0.0) for p in soa.v),
        F=tuple(take(p, d) for p, d in zip(soa.F, _DEAD_F)),
        F_trial=tuple(take(p, d) for p, d in zip(soa.F_trial, _DEAD_F)),
        C=tuple(take(p, 0.0) for p in soa.C),
        vol=take(soa.vol, 0.0),
        density=take(soa.density, 0.0),
        mass=take(soa.mass, 0.0),
        init_cov=tuple(take(p, 0.0) for p in soa.init_cov),
        cov=tuple(take(p, 0.0) for p in soa.cov),
        yield_stress=take(soa.yield_stress, 0.0),
    )
    aux_out = torch.stack([take(aux[r], 0.0) for r in range(aux.shape[0])])
    return out, aux_out, take(material, 0), take(orig, -1)


def _segments(dev: torch.Tensor, ndev: int, cap: int):
    """Stable partition of slots by owner (ndev = dead): (live, src, ok)
    for the ndev * cap output slots, slot d * cap + s holding owner d's
    s-th particle in slot order."""
    n_slots = dev.shape[0]
    i64 = dict(dtype=torch.int64, device=dev.device)
    order = torch.sort(dev, stable=True).indices
    counts = torch.bincount(dev, minlength=ndev + 1)[:ndev]
    seg_start = torch.cat([torch.zeros(1, **i64), torch.cumsum(counts, 0)])
    ok = torch.all(counts <= cap)
    d_ids = torch.arange(ndev, **i64).repeat_interleave(cap)
    s_ids = torch.arange(cap, **i64).repeat(ndev)
    live = s_ids < counts[d_ids]
    src = order[torch.clamp(seg_start[d_ids] + s_ids, 0, n_slots - 1)]
    return live, src, ok, d_ids


def _mid(a, b, grid: GridConfig) -> torch.Tensor:
    """(a + b) / 2 cells in grid units, float32 as gsmpm_tpu rounds it."""
    return (a + b).to(torch.float32) * 0.5 * grid.dx


def partition_slots(soa: SoAState, aux, material, orig, starts,
                    grid: GridConfig, hc: HaloConfig, coord: int = 0):
    """Repartition slot arrays (any length; dead slots have orig -1) into
    per-rank slab segments along coordinate ``coord``.

    Returns (soa', aux', material', orig', ok) of length ndev * cap: slot
    d * cap + s holds the s-th live particle owned by rank d, dead slots
    are parked at the slab centre (along coord; the grid centre on the
    other axes) with zero mass, and ok is False when a rank's live count
    exceeds cap.
    """
    dev = torch.where(orig >= 0, _device_of(soa.x[coord], starts, grid, hc),
                      hc.ndev)
    live, src, ok, d_ids = _segments(dev, hc.ndev, hc.cap)
    st = torch.as_tensor(starts, dtype=torch.int64, device=dev.device)
    mid_yz = float(np.float32(0.5 * hc.n_grid * grid.dx))
    park = tuple(_mid(st[d_ids], st[d_ids + 1], grid) if c == coord
                 else mid_yz for c in range(3))
    return (*_take_slots(soa, aux, material, orig, live, src, park), ok)


# ---------------------------------------------------------------------------
# packed particle rows (the migration buffers)
# ---------------------------------------------------------------------------

# 49 SoA planes + 3 aux rows + material + orig = 54 rows a particle
_N_ROWS = 54


def _soa_planes(soa: SoAState):
    return (list(soa.x) + list(soa.v) + list(soa.F) + list(soa.F_trial)
            + list(soa.C) + [soa.vol, soa.density, soa.mass]
            + list(soa.init_cov) + list(soa.cov) + [soa.yield_stress])


def _soa_from_rows(rows) -> SoAState:
    r = iter(range(49))

    def take(k):
        return tuple(rows[next(r)] for _ in range(k))

    return SoAState(
        x=take(3), v=take(3), F=take(9), F_trial=take(9), C=take(9),
        vol=rows[next(r)], density=rows[next(r)], mass=rows[next(r)],
        init_cov=take(6), cov=take(6), yield_stress=rows[next(r)],
    )


def _pack_rows(soa: SoAState, aux, material, orig) -> torch.Tensor:
    """All per-particle state as one (54, n) float32 tensor; material and
    orig ride as floats (exact below 2^24)."""
    return torch.stack(_soa_planes(soa) + [aux[r] for r in range(3)]
                       + [material.to(torch.float32),
                          orig.to(torch.float32)])


def _unpack_rows(rows: torch.Tensor):
    material = torch.round(rows[52]).to(torch.int32)
    orig = torch.round(rows[53]).to(torch.int64)
    return _soa_from_rows(rows), rows[49:52], material, orig


def bootstrap_slots(state, model: MPMModel, starts, grid: GridConfig,
                    hc: HaloConfig):
    """Original-order MPMState / SoAState -> the partitioned slot arrays of
    every rank (ndev * cap slots; a rank keeps its segment)."""
    soa = state if isinstance(state, SoAState) else soa_from_state(state)
    n = soa.mass.shape[0]
    aux = torch.stack([model.mu, model.lam, model.viscosity])
    orig = torch.arange(n, dtype=torch.int64, device=soa.mass.device)
    return partition_slots(soa, aux, model.material.to(torch.int32), orig,
                           starts, grid, hc)


def rank_segment(slots, rank: int, cap: int):
    """Rank's segment of partitioned slot arrays (soa, aux, material, orig)."""
    soa, aux, material, orig = slots
    cut = slice(rank * cap, (rank + 1) * cap)
    return (_map_soa(lambda p: p[cut].contiguous(), soa),
            aux[:, cut].contiguous(), material[cut].contiguous(),
            orig[cut].contiguous())


# ---------------------------------------------------------------------------
# halo exchanges
# ---------------------------------------------------------------------------

def _slab(arr: torch.Tensor, start: int, size: int, dim: int):
    """``lax.dynamic_slice_in_dim``: start clamps to [0, len - size]."""
    start = min(max(start, 0), arr.shape[dim] - size)
    return arr.narrow(dim, start, size)


def _dyn_add(arr: torch.Tensor, strip: torch.Tensor, start: int, dim: int):
    """arr with strip added at the clamped start, in place."""
    _slab(arr, start, strip.shape[dim], dim).add_(strip)
    return arr


def _exchange_accum(arr, x0: int, x1: int, mesh: Mesh, axis,
                    hc: HaloConfig, ax: int = 1):
    """P2G phase: route boundary-strip contributions to their owner.

    arr (C, G, G, G): this rank's P2G accumulation.  The HX-wide strip left
    of x0 goes to the left neighbour, the strip right of x1 to the right
    one; the owner adds them in place (from the left at its x0, from the
    right at its x1 - HX).  A rank without a neighbour adds zeros, as the
    JAX engine adds its zero-filled ``ppermute`` result."""
    HX = hc.HX
    left_out = _slab(arr, max(x0 - HX, 0), HX, ax)
    right_out = _slab(arr, min(x1, hc.n_grid - HX), HX, ax)
    from_left, from_right = neighbor_ppermute(left_out, right_out, mesh,
                                              axis)
    arr = _dyn_add(arr, from_left, min(x0, hc.n_grid - HX), ax)
    return _dyn_add(arr, from_right, max(x1 - HX, 0), ax)


def _exchange_edges(arr, x0: int, x1: int, mesh: Mesh, axis,
                    hc: HaloConfig, ax: int = 1):
    """G2P phase: fetch the owners' boundary values from the neighbours.

    arr (C, G, G, G) is already zero outside this rank's [x0, x1).  The
    owned left edge [x0, x0+HX) goes to the left neighbour (placed at its
    [x1, x1+HX)), the right edge [x1-HX, x1) to the right one (at its
    [x0-HX, x0)); adding into zeroed cells is a copy."""
    HX = hc.HX
    left_edge = _slab(arr, min(x0, hc.n_grid - HX), HX, ax)
    right_edge = _slab(arr, max(x1 - HX, 0), HX, ax)
    from_left, from_right = neighbor_ppermute(left_edge, right_edge, mesh,
                                              axis)
    arr = _dyn_add(arr, from_left, max(x0 - HX, 0), ax)
    return _dyn_add(arr, from_right, min(x1, hc.n_grid - HX), ax)


# ---------------------------------------------------------------------------
# migration (shared with halo_tiled and halo_tiled2d)
# ---------------------------------------------------------------------------

def migrate_gathered_slots(soa, aux, material, orig, starts,
                           grid: GridConfig, hc: HaloConfig, axis,
                           coord: int = 0, *, mesh: Mesh):
    """Gathered repartition: all-gather every slot of the axis, repartition
    (replicated), keep this rank's segment.  O(N) bytes, always valid."""
    rows = all_gather_cat(_pack_rows(soa, aux, material, orig), mesh, dim=1,
                          axis=axis)
    *slots, ok = partition_slots(*_unpack_rows(rows), starts, grid, hc,
                                 coord)
    return (*rank_segment(slots, mesh.axis_index(axis), hc.cap), ok)


def migrate_neighbor_slots(soa, aux, material, orig, starts,
                           grid: GridConfig, hc: HaloConfig, axis,
                           coord: int = 0, *, mesh: Mesh):
    """Neighbour-only emigrant exchange: bounded buffers of mcap rows each
    way (drift bounded by the margin puts an emigrant's new owner next
    door).  A buffer or free-slot overflow, or a stray, on any rank of the
    axis (counts exchanged first, the flag all-reduced and read once on
    the host, equal on every rank of the axis) takes the gathered
    repartition on the whole axis."""
    i = mesh.axis_index(axis)
    x0, x1 = starts[i], starts[i + 1]
    mcap, n_slots = hc.mcap, hc.cap
    dev = soa.mass.device
    live = orig >= 0
    dev_new = torch.where(live, _device_of(soa.x[coord], starts, grid, hc),
                          i)
    go_l = live & (dev_new == i - 1)
    go_r = live & (dev_new == i + 1)
    stray = live & ((dev_new - i).abs() > 1)
    n_l, n_r = go_l.sum(), go_r.sum()
    stay = live & ~go_l & ~go_r
    n_free = n_slots - stay.sum()
    recv_l_cnt, recv_r_cnt = (
        c[0] for c in neighbor_ppermute(n_l.reshape(1), n_r.reshape(1), mesh,
                                        axis))
    bad = ((n_l > mcap) | (n_r > mcap) | torch.any(stray)
           | (recv_l_cnt + recv_r_cnt > n_free)).to(torch.int32).reshape(1)
    dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=mesh.axis_group(axis))
    if bool(bad[0]):  # one host read, equal on every rank of the axis
        return migrate_gathered_slots(soa, aux, material, orig, starts, grid,
                                      hc, axis, coord, mesh=mesh)

    rows = _pack_rows(soa, aux, material, orig)
    jj = torch.arange(mcap, dtype=torch.int64, device=dev)

    def build(mask, cnt):
        src = torch.sort((~mask).to(torch.uint8), stable=True).indices[:mcap]
        return torch.where((jj < cnt)[None, :], rows[:, src], 0.0)

    recv_from_left, recv_from_right = neighbor_ppermute(
        build(go_l, n_l), build(go_r, n_r), mesh, axis)

    # emigrants die: parked at the slab centre along coord, mass 0
    mid_yz = float(np.float32(0.5 * hc.n_grid * grid.dx))
    park = tuple(_mid(torch.tensor(x0), torch.tensor(x1), grid).to(dev)
                 if c == coord else mid_yz for c in range(3))
    dead = SoAState(
        x=park, v=(0.0,) * 3, F=_DEAD_F, F_trial=_DEAD_F, C=(0.0,) * 9,
        vol=0.0, density=0.0, mass=0.0, init_cov=(0.0,) * 6, cov=(0.0,) * 6,
        yield_stress=0.0,
    )
    soa_k = _map_soa(lambda p, d: torch.where(stay, p, d), soa, dead)
    rows_k = _pack_rows(soa_k, torch.where(stay[None, :], aux, 0.0),
                        torch.where(stay, material, 0),
                        torch.where(stay, orig, -1))

    # immigrants into free slots, dead slots first; slot n_slots takes the
    # writes past the counts and is cut off
    free_order = torch.sort(stay.to(torch.uint8), stable=True).indices
    dst_l = torch.where(jj < recv_l_cnt,
                        free_order[torch.clamp(jj, max=n_slots - 1)], n_slots)
    dst_r = torch.where(
        jj < recv_r_cnt,
        free_order[torch.clamp(recv_l_cnt + jj, max=n_slots - 1)], n_slots)
    rows_k = torch.cat([rows_k, torch.zeros_like(rows_k[:, :1])], dim=1)
    rows_k[:, dst_l] = recv_from_left
    rows_k[:, dst_r] = recv_from_right
    return (*_unpack_rows(rows_k[:, :n_slots]),
            torch.ones((), dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

def segment_plan(n_substeps: int, migrate_every: int) -> Tuple[int, int]:
    """(segments, substeps a segment): migrations every migrate_every."""
    seg_len = min(migrate_every, n_substeps)
    if n_substeps % seg_len:
        raise ValueError("n_substeps must be a multiple of migrate_every")
    return n_substeps // seg_len, seg_len


def all_ranks_ok(ok: torch.Tensor, mesh: Mesh) -> bool:
    """ok reduced with MIN over the mesh, read on the host: the same on
    every rank.  (gsmpm_tpu returns its halo_tiled flags under a
    replicated out_spec without a reduction, i.e. device 0's; ROADMAP C.)"""
    t = ok.to(torch.int32).reshape(1)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(t[0])


def original_order_view(soa: SoAState, orig: torch.Tensor, n_slots: int,
                        mesh: Mesh) -> SoAState:
    """Every rank's slots in original particle order: a local scatter into
    (49, n_slots + 1) zeros (dead slots into the last column), then one
    all-reduce; planes of length n_slots + 1 (``original_view`` trims)."""
    planes = torch.stack(_soa_planes(soa))
    idx = torch.where(orig >= 0, orig, n_slots)
    full = torch.zeros((planes.shape[0], n_slots + 1), dtype=planes.dtype,
                       device=planes.device)
    full[:, idx] = planes
    dist.all_reduce(full, group=mesh.group)
    return _soa_from_rows(full)


def original_view(full_padded: SoAState, n: int, lo: int = 0) -> SoAState:
    """Trim the all-reduced (n_slots + 1,) planes back to particles
    [lo, n) (a rank's shard of them: lo = rank * n / ranks)."""
    return _map_soa(lambda p: p[lo:n], full_padded)


def _grid_coords(g: int, device) -> torch.Tensor:
    ar = torch.arange(g, dtype=torch.float32, device=device)
    return torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                       dim=-1).reshape(-1, 3)


def make_halo_frame(mesh: Mesh, axis, bcs, grid: GridConfig, hc: HaloConfig,
                    dt: float, n_substeps: int, migrate_every: int = 10):
    """Build the frame step of this rank.

    frame(soa, aux, material, orig, starts, model, time) ->
    (soa', aux', material', orig', full, time', ok)

    soa / aux / material / orig are this rank's cap slots (``rank_segment``
    of ``bootstrap_slots``); starts the (ndev+1,) cell starts; model's
    scalar fields are read (per-slot parameters ride in aux).  full is the
    original-order view, equal on every rank (``original_view`` trims it);
    ok (a bool, equal on every rank) is False on a slot overflow or on
    drift beyond the margin: the caller redoes the frame on psum.
    Particles migrate through bounded neighbour buffers, or the gathered
    repartition when one would overflow (``migrate_neighbor_slots``).
    """
    n_seg, seg_len = segment_plan(n_substeps, migrate_every)
    g = grid.n_grid
    i = mesh.axis_index(axis)

    def frame(soa, aux, material, orig, starts, model, time):
        x0, x1 = starts[i], starts[i + 1]
        dev = soa.mass.device
        coords = _grid_coords(g, dev) if bcs.grid_ops else None
        xc = torch.arange(g, device=dev).reshape(1, g, 1, 1)
        own = (xc >= x0) & (xc < x1)

        def substep(soa, time):
            if bcs.particle_ops:
                v_aos = m33.vec_to_aos(soa.v)
                x_aos = m33.vec_to_aos(soa.x)
                for op in bcs.particle_ops:
                    v_aos = op.apply_particles(x_aos, v_aos, soa.mass, time,
                                               dt)
                soa = soa._replace(v=m33.vec_from_aos(v_aos))
            new_F, stress, new_yield = compute_stress_soa(
                soa.F_trial, material, aux[0], aux[1], soa.yield_stress,
                model.alpha, model.hardening, model.xi,
                model.plastic_viscosity, model.softening, dt,
                active_materials=model.active_materials,
            )
            soa = soa._replace(F=new_F, yield_stress=new_yield)
            mass, mom = p2g_soa(soa, stress, grid, dt)
            acc = torch.stack([mass, *mom]).reshape(4, g, g, g)
            acc = _exchange_accum(acc, x0, x1, mesh, axis, hc).reshape(4, -1)
            grid_v = grid_update_soa(acc[0], (acc[1], acc[2], acc[3]),
                                     model.gravity, dt)
            if bcs.grid_ops:
                gv_aos = torch.stack(grid_v, dim=-1)
                for op in bcs.grid_ops:
                    gv_aos = op.apply_grid(gv_aos, coords, time, dt, grid.dx)
                grid_v = tuple(gv_aos[:, r] for r in range(3))
            # owned cells only, then the owners' boundary velocities
            gv = torch.where(own, torch.stack(grid_v).reshape(3, g, g, g),
                             0.0)
            gv = _exchange_edges(gv, x0, x1, mesh, axis, hc)
            return g2p_soa(soa, tuple(gv.reshape(3, -1)), grid, dt)

        ok = torch.ones((), dtype=torch.bool, device=dev)
        for _ in range(n_seg):
            for _ in range(seg_len):
                soa = substep(soa, time)
                time = _advance(time, dt)
            cell = torch.floor(soa.x[0] * grid.inv_dx).to(torch.int64)
            drift = (orig >= 0) & ((cell < x0 - hc.margin)
                                   | (cell >= x1 + hc.margin))
            soa, aux, material, orig, ok2 = migrate_neighbor_slots(
                soa, aux, material, orig, starts, grid, hc, axis, mesh=mesh)
            ok = ok & ~torch.any(drift) & ok2
        full = original_order_view(soa, orig, hc.ndev * hc.cap, mesh)
        return soa, aux, material, orig, full, time, all_ranks_ok(ok, mesh)

    return frame
