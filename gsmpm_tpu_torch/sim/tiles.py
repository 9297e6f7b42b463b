"""Tile-bucketed MPM transfer: the fast engine of the port.

Port of gsmpm_tpu/sim/tiles.py: the forward engine and its differentiable
fitting substeps (``substep_tiled_fitting``, whose transfers are the
hand-written VJPs of sim/transfer_vjp.py).  Particles are bucketed
into 8-cell grid tiles; each tile owns a 16^3-cell window, emitted
octant-decomposed so that the fold onto the blocked grid is eight in-order
slice adds.  This module holds everything around the two transfer kernels:
tile geometry, the packed particle layout ``q`` (QROWS rows), rebucketing,
window fold/extract, the blocked grid BCs, the substep driver, and the plain
twins of the kernels (``p2g_tiled_ref`` / ``g2p_tiled_ref``, batched over
chunks).  The kernels themselves are in sim/cuda_mpm.py; ``substep_tiled``
calls their wrappers, which take the twins for CPU tensors.

gsmpm_tpu compiles a frame's substep scan into one program.  Its
counterpart here: on CUDA, ``frame_tiled`` captures the substep's device
work (particle phase, K1, grid phase, K2, drift flag, the float32 clock)
once in a ``torch.cuda.CUDAGraph`` over static buffers and replays it
every substep; the rebucket stays eager between replays.  The fitting
window (gsmpm_tpu's jitted ``value_and_grad`` of a checkpointed scan) is
``_FittingWindow``: a forward graph of one fitting substep replayed N
times, and in the backward pass an adjoint graph (the substep recomputed
from its kept input rows, then its VJP) replayed for k = N-1 ... 0.  The
mesh paths (gsmpm_tpu's ``shard_map`` programs) take the same graphs with
a process group: the grid's all-reduce (and in the adjoint its VJP's) is
captured inside them, and ``_drop_group_graphs`` frees a group's graphs
before the group is destroyed.  The capture machinery (``_Captured``, the
cache keys, ``_drop_group_graphs``) is sim/graphs.py's, shared with the
golden engine's graphs (sim/solver.py).

Differences from the JAX engine, none of which changes a result:
- the drift check that triggers a rebucket is a host-side ``if`` (one
  device->host read per substep) in place of ``lax.cond``;
- dropped scatter writes (``mode="drop"``) go to one extra slot that is cut
  off afterwards;
- the blocked-grid coordinates for the grid BCs are built once per
  geometry and cached.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from gsmpm_tpu_torch.ops.constitutive import (
    cauchy_stress_stvk_green_soa,
    compute_stress_soa,
)
from gsmpm_tpu_torch.sim.graphs import (  # noqa: F401 (tiles' names)
    _cached,
    _Captured,
    _drop_group_graphs,
    _identity,
    _owned,
    _register,
    _values,
)
from gsmpm_tpu_torch.sim.kernels import SoAState, grid_update_soa
from gsmpm_tpu_torch.sim.state import GridConfig, MPMModel

# packed q row indices
RX = 0       # 0..2   position (grid coords)
RV = 3       # 3..5   velocity
RC = 6       # 6..14  APIC C (row-major)
RF = 15      # 15..23 F (post return-map)
RFT = 24     # 24..32 F_trial
RMASS = 33
RVOL = 34
RYIELD = 35
RDRIFT = 36  # scratch: G2P writes per-particle drift flag here
QROWS = 40

# aux row indices (per-particle material params, permuted with q)
AMU, ALAM, AVISC = 0, 1, 2
AUXROWS = 8

T_TILE = 8     # cells per tile per axis
W_WIN = 16     # window cells per axis (= 2 padded-grid tiles)
PAD_LO = 4     # padded coord = cell + PAD_LO; window origin of tile t = 8t
LOCAL_MIN, LOCAL_MAX = 0, 13       # valid base slots inside a window
SAFE_MIN, SAFE_MAX = 1, 12         # drift trigger outside this range


class TileConfig(NamedTuple):
    """Static tiling geometry for a given (n_grid, n_particles)."""

    n_grid: int
    n_particles: int
    S: int = 256            # chunk rows (particles per chunk)
    n_occ_cap: int = 0      # max occupied tiles (0 = ntiles)

    @property
    def nt(self) -> int:    # tiles per axis
        return -(-self.n_grid // T_TILE)

    @property
    def ntiles(self) -> int:
        return self.nt ** 3

    @property
    def occ_cap(self) -> int:
        return self.n_occ_cap or self.ntiles

    @property
    def nchunk(self) -> int:
        return -(-self.n_particles // self.S) + self.occ_cap

    @property
    def np_rows(self) -> int:  # padded particle slots
        return self.nchunk * self.S

    @property
    def pad_axis(self) -> int:  # padded grid cells per axis
        return (self.nt + 1) * T_TILE


def default_tile_config(n_grid: int, n_particles: int) -> TileConfig:
    nt = -(-n_grid // T_TILE)
    # cap occupied tiles so NP stays bounded for big grids; rebucket reports
    # overflow through TiledState.ok
    cap = min(nt ** 3, max(512, 4 * max(1, n_particles // 256)))
    return TileConfig(n_grid, n_particles, S=256, n_occ_cap=cap)


@dataclass
class TiledState:
    """Particle state in tile-sorted packed layout."""

    q: torch.Tensor            # (QROWS, NP) f32
    aux: torch.Tensor          # (AUXROWS, NP) f32: mu, lam, viscosity
    material: torch.Tensor     # (NP,) int32
    orig: torch.Tensor         # (NP,) int64 original index, -1 = padding
    chunk_tile: torch.Tensor   # (NCHUNK,) int32, non-decreasing
    chunk_first: torch.Tensor  # (NCHUNK,) int32 (1 = first chunk of its tile)
    chunk_live: torch.Tensor   # (NCHUNK,) int32 (1 = holds real slots)
    need_rebucket: torch.Tensor  # () bool
    ok: torch.Tensor           # () bool: tiled layout valid (occ <= cap)


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def pack_q(soa: SoAState) -> torch.Tensor:
    """SoA planes -> (QROWS, N) packed matrix."""
    rows = (
        list(soa.x) + list(soa.v) + list(soa.C) + list(soa.F)
        + list(soa.F_trial)
        + [soa.mass, soa.vol, soa.yield_stress]
    )
    zero = torch.zeros_like(soa.mass)
    return torch.stack(rows + [zero] * (QROWS - len(rows)))


def unpack_q(q: torch.Tensor, soa_template: SoAState) -> SoAState:
    """(QROWS, N) in ORIGINAL order -> SoAState (cov/init_cov from template)."""
    return soa_template._replace(
        x=tuple(q[RX + i] for i in range(3)),
        v=tuple(q[RV + i] for i in range(3)),
        C=tuple(q[RC + i] for i in range(9)),
        F=tuple(q[RF + i] for i in range(9)),
        F_trial=tuple(q[RFT + i] for i in range(9)),
        mass=q[RMASS],
        vol=q[RVOL],
        yield_stress=q[RYIELD],
    )


def to_original_order(ts: TiledState, n: int) -> torch.Tensor:
    """Scatters ts.q back to original particle order -> (QROWS, n).

    Padding slots write to one extra column that is cut off.
    """
    idx = torch.where(ts.orig >= 0, ts.orig, n)
    out = torch.zeros((QROWS, n + 1), dtype=ts.q.dtype, device=ts.q.device)
    out[:, idx] = ts.q
    return out[:, :n]


# ---------------------------------------------------------------------------
# rebucketing
# ---------------------------------------------------------------------------

def _pad_pattern(tc: TileConfig, grid: GridConfig, slot_tile: torch.Tensor):
    """Default q columns for padding slots: tile-center x, F=I, mass=0."""
    nt = tc.nt
    t3 = torch.stack([
        slot_tile // (nt * nt), (slot_tile // nt) % nt, slot_tile % nt
    ])  # (3, NP)
    x = (t3.to(torch.float32) * T_TILE + T_TILE / 2 + 0.5) * grid.dx
    pat = torch.zeros((QROWS, slot_tile.shape[0]), dtype=torch.float32,
                      device=slot_tile.device)
    pat[RX:RX + 3] = x
    for d in (0, 4, 8):
        pat[RF + d] = 1.0
        pat[RFT + d] = 1.0
    return pat


def rebucket(ts: TiledState, grid: GridConfig, tc: TileConfig) -> TiledState:
    """Sort particles into tile buckets with S-aligned per-tile ranges.

    The result's chunk_tile is non-decreasing: live chunks follow the tile
    order and the dead (slack) chunks at the end carry the last used tile.
    """
    return _rebucket(ts, grid, tc)[0]


def _rebucket(ts: TiledState, grid: GridConfig, tc: TileConfig):
    """``rebucket``, and its permutation: (new state, src_c, has_src), slot
    s of the new rows gathered from old slot src_c[s] where has_src[s]
    (``_unpermute`` is its VJP)."""
    g, nt, S, NP = tc.n_grid, tc.nt, tc.S, tc.np_rows
    ntiles = tc.ntiles
    dev = ts.q.device
    i64 = dict(dtype=torch.int64, device=dev)
    x = ts.q[RX:RX + 3]
    valid = ts.orig >= 0

    cell = torch.clamp(torch.floor(x * grid.inv_dx), 0, g - 1).to(torch.int64)
    t3 = cell // T_TILE
    tid = (t3[0] * nt + t3[1]) * nt + t3[2]
    tid = torch.where(valid, tid, ntiles)

    counts = torch.bincount(tid, minlength=ntiles + 1)
    n_occ = torch.sum(counts[:ntiles] > 0)
    ok = n_occ <= tc.occ_cap

    padded = -(-counts[:ntiles] // S) * S
    dst_start = torch.cat([torch.zeros(1, **i64), torch.cumsum(padded, 0)])
    total_used = dst_start[-1]

    tid_sorted, order = torch.sort(tid, stable=True)
    first_pos = torch.searchsorted(tid_sorted, torch.arange(ntiles + 1, **i64))
    rank = torch.arange(NP, **i64) - first_pos[torch.clamp(tid_sorted, 0, ntiles)]
    valid_sorted = tid_sorted < ntiles
    dest = torch.where(
        valid_sorted,
        dst_start[torch.clamp(tid_sorted, 0, ntiles - 1)] + rank, NP,
    )
    # slots beyond NP (occupied-tile cap overflow) are dropped into slot NP
    dest = torch.clamp(dest, max=NP)
    src = torch.full((NP + 1,), -1, **i64)
    src[dest] = order
    src = src[:NP]
    has_src = src >= 0
    src_c = torch.clamp(src, 0, NP - 1)

    # chunk -> tile first (searchsorted over nchunk positions, not NP slots),
    # then slot_tile by repeat: slot s lives in chunk s // S
    cpos = torch.arange(tc.nchunk, **i64) * S
    chunk_tile0 = torch.clamp(
        torch.searchsorted(dst_start, cpos, right=True) - 1, 0, ntiles - 1
    )
    slot_tile = torch.repeat_interleave(chunk_tile0, S)

    pat = _pad_pattern(tc, grid, slot_tile)
    # index_select: its backward (the fitting path differentiates through
    # this permutation) is an index_add_, not a sort of the indices
    new_q = torch.where(has_src[None, :], ts.q.index_select(1, src_c), pat)
    new_aux = torch.where(has_src[None, :], ts.aux.index_select(1, src_c),
                          0.0)
    new_mat = torch.where(has_src, ts.material[src_c], 0)
    new_orig = torch.where(has_src, ts.orig[src_c], -1)

    # chunk tables
    active = cpos < total_used
    last_tile = slot_tile[torch.clamp(total_used - 1, 0, NP - 1)]
    chunk_tile = torch.where(active, chunk_tile0, last_tile)
    chunk_first = active & (
        cpos == dst_start[torch.clamp(chunk_tile, 0, ntiles - 1)]
    )

    i32 = torch.int32
    return TiledState(
        q=new_q, aux=new_aux, material=new_mat.to(i32), orig=new_orig,
        chunk_tile=chunk_tile.to(i32), chunk_first=chunk_first.to(i32),
        chunk_live=active.to(i32),
        need_rebucket=torch.zeros((), dtype=torch.bool, device=dev),
        ok=ok,
    ), src_c, has_src


def _unpermute(d: torch.Tensor, src_c: torch.Tensor,
               has_src: torch.Tensor) -> torch.Tensor:
    """VJP of a rebucket's gather ``where(has_src, x.index_select(1,
    src_c), pad)`` for rows (R, NP): the cotangent of the slots with a
    source scattered back to it, autograd's ``index_add_`` (each source
    slot is taken once, so no two terms meet)."""
    return torch.zeros_like(d).index_add_(
        1, src_c, torch.where(has_src[None, :], d, 0.0))


def bootstrap(
    soa: SoAState, model: MPMModel, grid: GridConfig, tc: TileConfig
) -> TiledState:
    """Initial TiledState from SoA state + per-particle model params."""
    n, NP = tc.n_particles, tc.np_rows
    dev = soa.mass.device
    q = torch.nn.functional.pad(pack_q(soa), (0, NP - n))
    aux = torch.zeros((AUXROWS, NP), dtype=torch.float32, device=dev)
    aux[AMU, :n] = model.mu
    aux[ALAM, :n] = model.lam
    aux[AVISC, :n] = model.viscosity
    material = torch.nn.functional.pad(model.material.to(torch.int32),
                                       (0, NP - n))
    orig = torch.cat([
        torch.arange(n, dtype=torch.int64, device=dev),
        torch.full((NP - n,), -1, dtype=torch.int64, device=dev),
    ])
    zeros = torch.zeros((tc.nchunk,), dtype=torch.int32, device=dev)
    ts = TiledState(
        q=q, aux=aux, material=material, orig=orig,
        chunk_tile=zeros, chunk_first=zeros, chunk_live=zeros,
        need_rebucket=torch.zeros((), dtype=torch.bool, device=dev),
        ok=torch.ones((), dtype=torch.bool, device=dev),
    )
    return rebucket(ts, grid, tc)


# ---------------------------------------------------------------------------
# window fold / extract (static shapes)
# ---------------------------------------------------------------------------

def fold_windows(windows: torch.Tensor, tc: TileConfig) -> torch.Tensor:
    """Octant P2G windows (ntiles, 256, 64) -> blocked grid (T,T,T,32,64).

    Octant o = a*4+b*2+c of tile t (rows [o*32, o*32+32), row comp*8+xl,
    col yl*8+zl) belongs entirely to padded-grid tile t+(a,b,c), so the fold
    is 8 in-order slice adds.  Domain-boundary clamping already happened in
    the transfer, so there is no pad folding here.
    """
    nt, T = tc.nt, tc.nt + 1
    acc = torch.zeros((T, T, T, 4 * T_TILE, T_TILE * T_TILE),
                      dtype=windows.dtype, device=windows.device)
    o = 0
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                oc = windows[:, o * 32:(o + 1) * 32, :].reshape(
                    nt, nt, nt, 4 * T_TILE, T_TILE * T_TILE
                )
                acc[a:a + nt, b:b + nt, c:c + nt] += oc
                o += 1
    return acc


def extract_windows(gvb: torch.Tensor, tc: TileConfig) -> torch.Tensor:
    """Blocked grid velocities (T,T,T,24,64) -> octant blocks (ntiles,192,64).

    Inverse addressing of fold_windows: tile t's G2P input stacks the 8
    padded-grid tiles t+(a,b,c) (rows oct*24 + comp*8 + xl, col yl*8+zl).
    """
    nt = tc.nt
    parts = []
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                parts.append(
                    gvb[a:a + nt, b:b + nt, c:c + nt].reshape(
                        tc.ntiles, 3 * T_TILE, T_TILE * T_TILE
                    )
                )
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# per-chunk separable transfer math: the plain twins of the kernels
# ---------------------------------------------------------------------------

def _tile_origins(tid: torch.Tensor, tc: TileConfig):
    """(nchunk,) tile ids -> three (nchunk,) window origins (padded coords)."""
    nt = tc.nt
    t3 = (tid // (nt * nt), (tid // nt) % nt, tid % nt)
    return tuple(t.to(torch.int64) * T_TILE for t in t3)


def _axis_bases(xrow, torg, grid: GridConfig, tc: TileConfig):
    """Per-axis 16-slot spline bases for every chunk.

    xrow: (nchunk, S) positions along the axis; torg: (nchunk,) window
    origins.  Returns (w, dw, u) each (nchunk, 16, S); dw is inv_dx-scaled,
    u is the unscaled APIC moment basis w*(k - fx).  Out-of-domain stencil
    weight is folded onto the boundary cell (slot torg+k clips to the core
    [PAD_LO, PAD_LO+g-1]), the reference's implicit out-of-bounds clamp.
    """
    g = tc.n_grid
    dev = xrow.device
    gp = xrow * grid.inv_dx
    basef = torch.floor(gp - 0.5)
    fx = gp - basef
    basep = torch.clamp(basef, -1, g - 1).to(torch.int64) + PAD_LO
    local = torch.clamp(basep - torg[:, None], LOCAL_MIN, LOCAL_MAX)
    slots = torch.arange(W_WIN, dtype=torch.int64, device=dev)[None, :, None]
    k = slots - local[:, None, :]                       # (c, 16, S)
    kf = k.to(xrow.dtype)
    fxb = fx[:, None, :]
    w0 = 0.5 * (1.5 - fxb) ** 2
    w1 = 0.75 - (fxb - 1.0) ** 2
    w2 = 0.5 * (fxb - 0.5) ** 2
    w = torch.where(k == 0, w0, torch.where(k == 1, w1,
                                            torch.where(k == 2, w2, 0.0)))
    d0 = (fxb - 1.5) * grid.inv_dx
    d1 = -2.0 * (fxb - 1.0) * grid.inv_dx
    d2 = (fxb - 0.5) * grid.inv_dx
    dw = torch.where(k == 0, d0, torch.where(k == 1, d1,
                                             torch.where(k == 2, d2, 0.0)))
    u = w * (kf - fxb)
    # M[c, j, k] = 1 where slot k folds onto slot j
    kk = torch.arange(W_WIN, dtype=torch.int64, device=dev)[None, None, :]
    tk = torch.clamp(kk + torg[:, None, None], PAD_LO, PAD_LO + g - 1) \
        - torg[:, None, None]
    M = (tk == slots).to(w.dtype)                       # (c, 16, 16)
    return M @ w, M @ dw, M @ u


def _live_chunks(ts: TiledState) -> torch.Tensor:
    """Indices of the chunks that hold real slots: the twins skip the
    others, whose slots are padding (mass and volume 0)."""
    return torch.nonzero(ts.chunk_live == 1).squeeze(1)


def _chunk_bases(q, chunk_tile, grid, tc, live):
    """Rows and per-axis bases of the chunks ``live``: (qc (c, QROWS, S),
    window origins, [(w, dw, u)] per axis)."""
    qc = q.reshape(QROWS, -1, tc.S)[:, live].permute(1, 0, 2)
    torg = _tile_origins(chunk_tile[live], tc)
    bases = [_axis_bases(qc[:, RX + a], torg[a], grid, tc) for a in range(3)]
    return qc, torg, bases


def _pair(a, b):
    """(c,16,S) x (c,16,S) -> (c, 256_jk, S) y/z pair table."""
    c, _, S = a.shape
    return (a[:, :, None, :] * b[:, None, :, :]).reshape(c, 256, S)


def p2g_tiled_ref(ts: TiledState, sig: torch.Tensor, grid: GridConfig,
                  tc: TileConfig, dt) -> torch.Tensor:
    """Plain twin of the P2G kernel: octant windows (ntiles, 256, 64).

    Per chunk, the window is the sum of the separable terms (mass, momentum
    m v, APIC m dx C u, stress -dt V sigma dw) contracted as
    wx @ (pair table)^T, the order of gsmpm_tpu's p2g_chunk_mm; chunks of
    one tile accumulate with ``index_add_``.  Float32 matmuls throughout
    (TF32 stays off).
    """
    live = _live_chunks(ts)
    qc, _, ((wx, dwx, ux), (wy, dwy, uy), (wz, dwz, uz)) = _chunk_bases(
        ts.q, ts.chunk_tile, grid, tc, live
    )
    nchunk = qc.shape[0]
    sc = sig.reshape(16, -1, tc.S)[:, live].permute(1, 0, 2)
    m = qc[:, RMASS][:, None, :]
    vol = qc[:, RVOL][:, None, :]
    dx = grid.dx

    ww = _pair(wy, wz)
    uw = _pair(uy, wz)
    wu = _pair(wy, uz)
    dw = _pair(dwy, wz)
    wd = _pair(wy, dwz)

    def mm(x16, w256):  # (c,16,S) @ (c,256,S)^T -> (c,16,256)
        return torch.bmm(x16, w256.transpose(1, 2))

    win = [mm(wx, ww * m)]
    for r in range(3):
        c0 = m * dx * qc[:, RC + 3 * r + 0][:, None, :]
        c1 = m * dx * qc[:, RC + 3 * r + 1][:, None, :]
        c2 = m * dx * qc[:, RC + 3 * r + 2][:, None, :]
        s0 = -dt * vol * sc[:, 3 * r + 0][:, None, :]
        s1 = -dt * vol * sc[:, 3 * r + 1][:, None, :]
        s2 = -dt * vol * sc[:, 3 * r + 2][:, None, :]
        w1 = (ww * (m * qc[:, RV + r][:, None, :]) + uw * c1 + wu * c2
              + dw * s1 + wd * s2)
        x2 = ux * c0 + dwx * s0
        win.append(mm(wx, w1) + mm(x2, ww))
    # (c,4,16,16,16) -> octant rows (a,b,c,comp,xl) x cols (yl,zl)
    w4 = torch.stack(win, dim=1).reshape(
        nchunk, 4, 2, T_TILE, 2, T_TILE, 2, T_TILE
    )
    cw = w4.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(
        nchunk, 8 * 4 * T_TILE, T_TILE * T_TILE
    )
    out = torch.zeros((tc.ntiles, 8 * 4 * T_TILE, T_TILE * T_TILE),
                      dtype=cw.dtype, device=cw.device)
    return out.index_add_(0, ts.chunk_tile[live].to(torch.int64), cw)


def g2p_tiled_ref(ts: TiledState, windows: torch.Tensor, grid: GridConfig,
                  tc: TileConfig, dt) -> torch.Tensor:
    """Plain twin of the G2P kernel: new q (QROWS, NP).

    Gathers v, grad v and APIC C from each chunk's (192, 64) octant block,
    advects x, forms F_trial = (I + dt grad v) F, zeroes v/C of massless
    slots and writes the drift flag (gsmpm_tpu's g2p_chunk_ref semantics,
    contracted in g2p_chunk_mm's order).
    """
    qc, torg, ((wx, dwx, ux), (wy, dwy, uy), (wz, dwz, uz)) = _chunk_bases(
        ts.q, ts.chunk_tile, grid, tc, slice(None)
    )
    nchunk = qc.shape[0]
    ext = windows[ts.chunk_tile.to(torch.int64)]       # (c, 192, 64)
    gv = ext.reshape(nchunk, 2, 2, 2, 3, T_TILE, T_TILE, T_TILE).permute(
        0, 4, 1, 5, 2, 6, 3, 7
    ).reshape(nchunk, 3, W_WIN, W_WIN * W_WIN)          # (c, 3, 16_i, 256_jk)

    ww = _pair(wy, wz)
    uw = _pair(uy, wz)
    wu = _pair(wy, uz)
    dw = _pair(dwy, wz)
    wd = _pair(wy, dwz)

    def red(A, P):  # (c,S,256) x (c,256,S) -> (c,S)
        return torch.sum(A * P.transpose(1, 2), dim=2)

    new_v, grad, new_C = [], [], []
    coef = 4.0 * grid.inv_dx
    for r in range(3):
        G = gv[:, r]                                    # (c, 16, 256)
        A = torch.bmm(wx.transpose(1, 2), G)            # (c, S, 256)
        B = torch.bmm(dwx.transpose(1, 2), G)
        U = torch.bmm(ux.transpose(1, 2), G)
        new_v.append(red(A, ww))
        grad.append([red(B, ww), red(A, dw), red(A, wd)])
        new_C.append([coef * red(U, ww), coef * red(A, uw),
                      coef * red(A, wu)])

    valid = qc[:, RMASS] > 0
    new_x = [qc[:, RX + a] + dt * new_v[a] for a in range(3)]
    Ft = []
    for r in range(3):
        for c in range(3):
            acc = 0.0
            for k in range(3):
                gk = grad[r][k] * dt + (1.0 if k == r else 0.0)
                acc = acc + gk * qc[:, RF + 3 * k + c]
            Ft.append(acc)

    out = qc.clone()
    for a in range(3):
        out[:, RX + a] = torch.where(valid, new_x[a], qc[:, RX + a])
        out[:, RV + a] = torch.where(valid, new_v[a], 0.0)
    for r in range(3):
        for c in range(3):
            out[:, RC + 3 * r + c] = torch.where(valid, new_C[r][c], 0.0)
            out[:, RFT + 3 * r + c] = torch.where(
                valid, Ft[3 * r + c], qc[:, RF + 3 * r + c]
            )
    # drift flag on the advected position
    g = tc.n_grid
    drift = torch.zeros_like(valid)
    for a in range(3):
        gp = out[:, RX + a] * grid.inv_dx
        basep = torch.clamp(torch.floor(gp - 0.5), -1, g - 1).to(torch.int64) \
            + PAD_LO
        local = basep - torg[a][:, None]
        drift = drift | (local < SAFE_MIN) | (local > SAFE_MAX)
    out[:, RDRIFT] = (valid & drift).to(qc.dtype)
    return out.permute(1, 0, 2).reshape(QROWS, ts.q.shape[1])


# ---------------------------------------------------------------------------
# substep driver
# ---------------------------------------------------------------------------

def particle_phase(ts: TiledState, model: MPMModel, bcs, time,
                   dt: float):
    """Particle BCs and the stress return map on the packed rows.

    ``time``: a host float or a 0-d float32 tensor (the device clock of a
    captured substep).  Returns (ts with q updated, stress rows sig (16,
    NP)): the inputs of the P2G kernel.
    """
    q = ts.q.clone()
    # particle-phase BCs (impulse) on the packed rows
    if bcs.particle_ops:
        x_aos = q[RX:RX + 3].T
        v_aos = q[RV:RV + 3].T
        for op in bcs.particle_ops:
            v_aos = op.apply_particles(x_aos, v_aos, q[RMASS], time, dt)
        q[RV:RV + 3] = v_aos.T

    F_trial = tuple(q[RFT + i] for i in range(9))
    new_F, stress, new_yield = compute_stress_soa(
        F_trial, ts.material, ts.aux[AMU], ts.aux[ALAM], q[RYIELD],
        model.alpha, model.hardening, model.xi, model.plastic_viscosity,
        model.softening, dt, active_materials=model.active_materials,
    )
    q[RF:RF + 9] = torch.stack(new_F)
    q[RYIELD] = new_yield
    sig = torch.cat([
        torch.stack(stress),
        torch.zeros((16 - 9, q.shape[1]), dtype=q.dtype, device=q.device),
    ])
    return dataclasses.replace(ts, q=q), sig


def grid_phase(windows: torch.Tensor, model: MPMModel, bcs, time,
               grid: GridConfig, tc: TileConfig, dt: float,
               group=None, grid_reduce=None,
               grid_exchange=None) -> torch.Tensor:
    """P2G windows -> fold -> grid update + grid BCs -> extract: the octant
    velocity blocks (ntiles, 192, 64) the G2P kernel reads.  With a process
    ``group`` the folded blocked grid is summed over its ranks first (one
    all-reduce, differentiable while autograd records it), each rank
    holding a slice of the chunks or its own particle shard.

    The spatial-decomposition hooks (parallel/halo_tiled.py):
    ``grid_reduce(acc)`` replaces the all-reduce of the folded (T,T,T,32,64)
    grid with the neighbours' boundary-slab accumulation, and
    ``grid_exchange(grid_v)`` runs on the three (T,T,T,8,64) velocity
    planes after the grid BCs (mask the tiles this rank does not own, fetch
    the owners' boundary velocities)."""
    acc = fold_windows(windows, tc)
    if grid_reduce is not None:
        acc = grid_reduce(acc)
    elif group is not None:
        from gsmpm_tpu_torch.parallel.mesh import all_reduce_sum

        acc = all_reduce_sum(acc, group)
    grid_v = grid_update_soa(
        acc[:, :, :, 0:T_TILE],
        (acc[:, :, :, T_TILE:2 * T_TILE],
         acc[:, :, :, 2 * T_TILE:3 * T_TILE],
         acc[:, :, :, 3 * T_TILE:4 * T_TILE]),
        model.gravity, dt,
    )  # 3 planes of (T,T,T,8,64)
    if bcs.grid_ops:
        grid_v = _apply_grid_bcs_blocked(grid_v, bcs, time, dt, grid, tc)
    if grid_exchange is not None:
        grid_v = grid_exchange(grid_v)
    return extract_windows(torch.cat(grid_v, dim=3), tc)


def substep_tiled(
    ts: TiledState,
    model: MPMModel,
    bcs,
    time: float,
    grid: GridConfig,
    tc: TileConfig,
    dt: float,
    *,
    group=None,
    rebucket_on_drift: bool = True,
    grid_reduce=None,
    grid_exchange=None,
) -> TiledState:
    """One MLS-MPM substep in the tiled layout.

    The reference's order: particle BCs -> stress -> P2G (kernel K1) -> fold
    -> grid update + grid BCs -> extract -> G2P (kernel K2).  ``time`` is a
    host float (float32 value).

    ``group``: chunk-sharded multi-process mode (parallel/tiled_sharded.py)
    -- ts holds this rank's chunks and the folded grid is all-reduced over
    the group; rebucketing is then the caller's (rebucket_on_drift=False).
    ``grid_reduce`` / ``grid_exchange``: the spatial-decomposition hooks of
    grid_phase (parallel/halo_tiled.py), in place of the all-reduce.
    """
    if rebucket_on_drift and bool(ts.need_rebucket):  # one host read
        ts = rebucket(ts, grid, tc)
    new_q, need = _transfer(ts, model, bcs, time, grid, tc, dt, group,
                            grid_reduce, grid_exchange)
    return dataclasses.replace(ts, q=new_q, need_rebucket=need)


def _transfer(ts: TiledState, model: MPMModel, bcs, time, grid: GridConfig,
              tc: TileConfig, dt: float, group=None, grid_reduce=None,
              grid_exchange=None):
    """A substep's device work on an already bucketed ts: particle phase
    -> P2G (K1) -> grid phase -> G2P (K2).  Returns (new q, drift flag)."""
    from gsmpm_tpu_torch.sim.cuda_mpm import g2p_tiled, p2g_tiled

    ts, sig = particle_phase(ts, model, bcs, time, dt)
    windows = p2g_tiled(ts, sig, grid, tc, dt)
    win_in = grid_phase(windows, model, bcs, time, grid, tc, dt, group,
                        grid_reduce, grid_exchange)
    new_q = g2p_tiled(ts, win_in, grid, tc, dt)
    return new_q, torch.max(new_q[RDRIFT]) > 0


@functools.lru_cache(maxsize=4)
def _blocked_coords(nt: int, device: str) -> torch.Tensor:
    """Core-cell coordinates (M, 3) of every blocked (T,T,T,8,64) cell:
    x = 8*tx + row, y = 8*ty + lane//8, z = 8*tz + lane%8, each minus
    PAD_LO (pad cells get out-of-range coords; they carry zero velocity and
    the transfer clamp never reads them back)."""
    T = nt + 1
    sh = (T, T, T, T_TILE, T_TILE * T_TILE)
    it = dict(dtype=torch.int64, device=device)
    lane = torch.arange(T_TILE * T_TILE, **it).expand(sh)
    li = [torch.arange(T_TILE, **it)[:, None].expand(sh),
          lane // T_TILE, lane % T_TILE]
    tcoord = [torch.arange(T, **it).reshape(
        [T if d == e else 1 for e in range(3)] + [1, 1]).expand(sh)
        for d in range(3)]
    return torch.stack([
        (tcoord[d] * T_TILE + li[d] - PAD_LO).to(torch.float32)
        for d in range(3)], dim=-1).reshape(-1, 3)


def _apply_grid_bcs_blocked(grid_v, bcs, time, dt, grid: GridConfig,
                            tc: TileConfig):
    """Grid-phase BCs/colliders on the blocked (T,T,T,8,64) velocity planes."""
    sh = grid_v[0].shape
    coords = _blocked_coords(tc.nt, str(grid_v[0].device))
    gv_aos = torch.stack(grid_v, dim=-1).reshape(-1, 3)
    for op in bcs.grid_ops:
        gv_aos = op.apply_grid(gv_aos, coords, time, dt, grid.dx)
    return tuple(gv_aos[:, r].reshape(sh) for r in range(3))


def _advance(time: float, dt: float) -> float:
    """time + dt rounded as the JAX engine's float32 clock."""
    return float(np.float32(np.float32(time) + np.float32(dt)))


def _substep_body(ts: TiledState, model: MPMModel, bcs,
                  clock: torch.Tensor, grid: GridConfig, tc: TileConfig,
                  dt: float, group=None) -> None:
    """The captured part of a substep, in place on static buffers: the
    device work of ``substep_tiled`` at the 0-d float32 ``clock`` (with a
    process ``group``, the folded grid's all-reduce among it), its results
    copied into ts.q and ts.need_rebucket, then clock += dt (the float32
    sum gsmpm_tpu's scan carries, ``_advance``'s value)."""
    new_q, need = _transfer(ts, model, bcs, clock, grid, tc, dt, group)
    ts.q.copy_(new_q)
    ts.need_rebucket.copy_(need)
    clock.add_(dt)


def _tensors(ts: TiledState):
    return [getattr(ts, f.name) for f in dataclasses.fields(ts)]


class _StaticState:
    """The static buffers a captured graph reads and writes: a tiled state
    ``ts`` and a 0-d float32 ``clock``."""

    def __init__(self, ts: TiledState):
        self.ts = TiledState(*[t.clone() for t in _tensors(ts)])
        self.clock = torch.zeros((), dtype=torch.float32, device=ts.q.device)

    def _assign(self, ts: TiledState) -> None:
        for dst, src in zip(_tensors(self.ts), _tensors(ts)):
            dst.copy_(src)

    def load(self, ts: TiledState, time: float) -> None:
        self._assign(ts)
        self.clock.fill_(time)

    def state(self) -> TiledState:
        """A TiledState that owns its tensors (later replays leave it)."""
        return TiledState(*[t.clone() for t in _tensors(self.ts)])


class _SubstepGraph(_StaticState):
    """Static buffers of a tiled state and a clock, and the substep over
    them: on CUDA replayed from one CUDA graph, captured after the first
    substep ran eagerly (``_Captured``); on the CPU the same body run
    eagerly.

    A substep reads the drift flag on the host once (gsmpm_tpu's
    ``lax.cond``); on drift it rebuckets eagerly and copies the new tables
    into the same buffers, so the graph stays valid.  With a process
    ``group`` (parallel/tiled_sharded.py: ts holds this rank's chunks) the
    graph holds the grid's all-reduce among the group, and the rebucket
    is the caller's: a substep reads nothing on the host.  The graph bakes
    in the addresses of the buffers and of ``model``'s and ``bcs``'
    tensors.
    """

    def __init__(self, ts: TiledState, model: MPMModel, bcs,
                 grid: GridConfig, tc: TileConfig, dt: float, group=None,
                 refs=()):
        super().__init__(ts)
        self.refs = refs  # what its cache key names by identity
        self.model, self.bcs, self.grid, self.tc, self.dt = (
            model, bcs, grid, tc, dt)
        self.group = group
        self.substep = _Captured(ts.q.device, frame_tiled)

    def _body(self) -> None:
        _substep_body(self.ts, self.model, self.bcs, self.clock, self.grid,
                      self.tc, self.dt, self.group)

    def release(self) -> None:
        self.substep.release()

    def step(self) -> None:
        if self.group is None:
            frame_tiled.host_reads += 1
            if bool(self.ts.need_rebucket):
                self._assign(rebucket(self.ts, self.grid, self.tc))
                frame_tiled.rebuckets += 1
        self.substep(self._body)


# captured substeps, least recently used first
_GRAPHS: "collections.OrderedDict[tuple, _SubstepGraph]" = _register(4)


def _substep_graph(ts: TiledState, model: MPMModel, bcs, grid: GridConfig,
                   tc: TileConfig, dt: float, group=None) -> _SubstepGraph:
    """The cached substep graph of (tc, grid, dt, the device, model's and
    bcs' tensors, the process group): a new model, BC set or group
    captures anew."""
    refs: list = []
    key = (tc, grid, dt, ts.q.device, _identity(model, refs),
           _identity(bcs, refs), _identity(group, refs))
    return _cached(_GRAPHS, key, lambda: _SubstepGraph(
        ts, model, bcs, grid, tc, dt, group, refs))


def frame_tiled(
    ts: TiledState,
    soa_template: SoAState,
    model: MPMModel,
    bcs,
    time: float,
    n_substeps: int,
    grid: GridConfig,
    tc: TileConfig,
    dt: float,
):
    """One frame of substeps with a PERSISTENT tiled state.

    Returns (ts, soa, time); ts.ok False means the occupied-tile cap
    overflowed during the frame.  On CUDA the substeps replay one captured
    CUDA graph (``_SubstepGraph``; one capture per model, BC set, tile
    config and dt) on a device clock that equals the returned host clock;
    ``frame_tiled.captures`` / ``replays`` / ``host_reads`` /
    ``rebuckets`` count its work.  On the CPU each substep is
    ``substep_tiled``.
    """
    if ts.q.device.type == "cuda":
        graph = _substep_graph(ts, model, bcs, grid, tc, dt)
        graph.load(ts, time)
        for _ in range(n_substeps):
            graph.step()
            time = _advance(time, dt)
        ts = graph.state()
    else:
        for _ in range(n_substeps):
            ts = substep_tiled(ts, model, bcs, time, grid, tc, dt)
            time = _advance(time, dt)
    q = to_original_order(ts, tc.n_particles)
    return ts, unpack_q(q, soa_template), time


frame_tiled.captures = frame_tiled.replays = 0
frame_tiled.host_reads = frame_tiled.rebuckets = 0


def _fitting_transfer(q, aux, ct, cf, cl, model: MPMModel, bcs, time: float,
                      grid: GridConfig, tc: TileConfig, dt: float,
                      group=None):
    """The differentiable body of a fitting substep on an already bucketed
    q: Green StVK stress on F -> P2G -> grid phase -> G2P -> F := F_trial.
    The transfers are the hand-written VJPs of sim/transfer_vjp.py; with a
    process ``group`` the folded grid is summed over its ranks (each
    holding a particle shard) in the grid phase."""
    from gsmpm_tpu_torch.sim.transfer_vjp import g2p_fit, p2g_fit

    F = tuple(q[RF + i] for i in range(9))
    stress = cauchy_stress_stvk_green_soa(F, aux[AMU], aux[ALAM])
    sig = torch.cat([
        torch.stack(stress),
        torch.zeros((16 - 9, q.shape[1]), dtype=q.dtype, device=q.device),
    ])
    windows = p2g_fit(q, sig, ct, cf, cl, grid, tc, dt)
    win_in = grid_phase(windows, model, bcs, time, grid, tc, dt, group)
    new_q = g2p_fit(q, win_in, ct, cf, cl, grid, tc, dt)
    # the fitting path advances F directly, no return map
    return torch.cat([new_q[:RF], new_q[RFT:RFT + 9], new_q[RF + 9:]])


def _drift_rebucket(ts: TiledState, grid: GridConfig, tc: TileConfig):
    """The host part of a fitting substep: the drift flag read on the host
    (one device->host read), and on drift the rebucket, whose ``ok`` is
    sticky (a later successful rebucket must not mask an overflow).
    Returns (ts, the permutation (src_c, has_src) or None)."""
    if not bool(ts.need_rebucket):
        return ts, None
    s2, src_c, has_src = _rebucket(ts, grid, tc)
    return dataclasses.replace(s2, ok=s2.ok & ts.ok), (src_c, has_src)


def substep_tiled_fitting(
    ts: TiledState,
    model: MPMModel,
    bcs,
    time: float,
    grid: GridConfig,
    tc: TileConfig,
    dt: float,
    *,
    group=None,
) -> TiledState:
    """One differentiable fitting substep in the tiled layout.

    Fitting semantics: Green-strain StVK stress on F, no particle BCs, F
    advanced to F_trial by G2P.  A rebucket, when the previous substep
    flagged drift, runs first: a permutation whose gathers carry the
    gradient.  The decision is read on the host from the flag the first
    forward pass computed and is never recomputed: while autograd records,
    only ``_fitting_transfer`` is checkpointed (recomputed in the backward
    pass), whose float atomics may round differently the second time.

    ``group``: particle-sharded fitting (parallel/sharded.py) -- ts buckets
    this rank's own particles over the whole grid, the folded grid is
    all-reduced over the group inside the checkpointed transfer (the
    recompute repeats the collective, in the same order on every rank) and
    each rank rebuckets its shard on its own drift flag (no collective).
    """
    ts, _ = _drift_rebucket(ts, grid, tc)
    args = (ts.q, ts.aux, ts.chunk_tile, ts.chunk_first, ts.chunk_live,
            model, bcs, time, grid, tc, dt, group)
    if torch.is_grad_enabled():
        new_q = torch.utils.checkpoint.checkpoint(
            _fitting_transfer, *args, use_reentrant=False)
    else:
        new_q = _fitting_transfer(*args)
    need = torch.max(new_q[RDRIFT].detach()) > 0
    return dataclasses.replace(ts, q=new_q, need_rebucket=need)


class _Gravity(NamedTuple):
    """What a fitting substep reads of its MPMModel besides ts.aux (the
    per-slot mu, lam): the grid phase's gravity."""

    gravity: torch.Tensor


class _FittingGraphs(_StaticState):
    """The fitting window's two graphs over shared static buffers (a tiled
    state, a clock, the cotangents dq / daux): the forward substep and its
    adjoint, each a ``_Captured`` (on CUDA one capture, then replays; on
    the CPU its body run eagerly).

    The learned parameters reach a fitting substep only through ts.aux, a
    buffer, so a new logE / y replays the same graphs; the graphs own
    copies of the gravity and the BC set they were captured with.  With a
    process ``group`` (parallel/sharded.py: ts buckets this rank's
    particle shard) both graphs hold the grid's all-reduces among it: the
    forward's, and in the adjoint the recompute's and its VJP's.
    """

    def __init__(self, ts: TiledState, model: MPMModel, bcs,
                 grid: GridConfig, tc: TileConfig, dt: float, group=None):
        super().__init__(ts)
        self.dq = torch.zeros_like(ts.q)
        self.daux = torch.zeros_like(ts.aux)
        self.model = _Gravity(model.gravity.detach().clone())
        self.bcs = _owned(bcs)
        self.grid, self.tc, self.dt, self.group = grid, tc, dt, group
        self.forward = _Captured(ts.q.device, run_substeps_tiled_fitting)
        self.adjoint = _Captured(ts.q.device, run_substeps_tiled_fitting)

    def prepare(self):
        """A substep's host part on the buffers (``_drift_rebucket``, the
        new rows and tables copied in).  Returns the rebucketed state,
        whose tensors are its own, and its permutation, or (None, None)."""
        run_substeps_tiled_fitting.host_reads += 1
        ts, perm = _drift_rebucket(self.ts, self.grid, self.tc)
        if perm is None:
            return None, None
        self._assign(ts)
        run_substeps_tiled_fitting.rebuckets += 1
        return ts, perm

    def _transfer(self, q, aux):
        ts = self.ts
        return _fitting_transfer(q, aux, ts.chunk_tile, ts.chunk_first,
                                 ts.chunk_live, self.model, self.bcs,
                                 self.clock, self.grid, self.tc, self.dt,
                                 self.group)

    def _forward_body(self) -> None:
        """The forward graph's body, in place: the device work of
        ``substep_tiled_fitting`` on the bucketed buffers at the clock, its
        rows and drift flag copied into ts.q and ts.need_rebucket, then
        clock += dt (``_advance``'s value)."""
        new_q = self._transfer(self.ts.q, self.ts.aux)
        self.ts.q.copy_(new_q)
        self.ts.need_rebucket.copy_(torch.max(new_q[RDRIFT]) > 0)
        self.clock.add_(self.dt)

    def _adjoint_body(self) -> None:
        """The adjoint graph's body, in place: the transfer recomputed from
        the input rows ts.q (ts.aux, the tables, the clock) with autograd
        on, its VJP against dq, the cotangent of its output rows; then dq
        := the cotangent of its input rows and daux += that of ts.aux.  The
        leaves are made here, and ``autograd.grad`` writes no ``.grad``."""
        q = self.ts.q.detach().requires_grad_(True)
        aux = self.ts.aux.detach().requires_grad_(True)
        with torch.enable_grad():
            dq, daux = torch.autograd.grad(self._transfer(q, aux), (q, aux),
                                           self.dq)
        self.dq.copy_(dq)
        self.daux.add_(daux)

    def release(self) -> None:
        self.forward.release()
        self.adjoint.release()

    def step(self) -> None:
        """One forward substep (replay, or warm-up and capture)."""
        self.forward(self._forward_body)

    def adjoint_step(self) -> None:
        """One adjoint substep on the loaded rows, clock and dq."""
        self.adjoint(self._adjoint_body)


class _Segment(NamedTuple):
    """The substeps from ``start`` to the next rebucket: their tables and
    aux, and the permutation of the rebucket before ``start`` (None for
    the window's first segment)."""

    start: int
    tables: tuple  # chunk_tile, chunk_first, chunk_live
    aux: torch.Tensor
    perm: Optional[tuple]


class _FittingWindow(torch.autograd.Function):
    """N fitting substeps as one autograd node: the port's counterpart of
    ``jax.checkpoint`` + ``lax.scan`` + ``jax.jit``.

    Forward: per substep the host part (``_FittingGraphs.prepare``), the
    input rows q_k kept in a stack (the scan's carries, the checkpoint
    path's memory), then the forward graph.  Backward: for k = N-1 ... 0
    the adjoint graph on q_k, the segment's tables and aux and the clock
    t_k; after the first substep of a segment that a rebucket began, the
    rebucket's VJP (``_unpermute``) on dq and daux, eager.  The decision to
    rebucket is the forward's, never recomputed.  Inputs (q, aux, ts,
    graphs, time, n_substeps), ts.q and ts.aux being q and aux; outputs
    the final TiledState's fields, q and aux differentiable.
    """

    @staticmethod
    def forward(ctx, q, aux, ts, graphs, time, n_substeps):
        g = graphs
        g.load(ts, time)
        stack = q.new_empty((n_substeps,) + tuple(q.shape))
        segments = [_Segment(0, (ts.chunk_tile, ts.chunk_first,
                                 ts.chunk_live), aux.detach(), None)]
        times = []
        for k in range(n_substeps):
            s2, perm = g.prepare()
            if perm is not None:
                segments.append(_Segment(k, (s2.chunk_tile, s2.chunk_first,
                                             s2.chunk_live), s2.aux, perm))
            stack[k].copy_(g.ts.q)
            times.append(time)
            g.step()
            time = _advance(time, g.dt)
        ctx.graphs, ctx.stack, ctx.segments, ctx.times = (
            g, stack, segments, times)
        out = _tensors(g.state())
        ctx.mark_non_differentiable(*out[2:])
        return tuple(out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dq, daux, *_):
        g, segments = ctx.graphs, ctx.segments
        g.dq.copy_(dq)
        g.daux.copy_(daux)

        def load(seg):
            for dst, src in zip((g.ts.chunk_tile, g.ts.chunk_first,
                                 g.ts.chunk_live), seg.tables):
                dst.copy_(src)
            g.ts.aux.copy_(seg.aux)

        i = len(segments) - 1
        load(segments[i])
        for k in reversed(range(len(ctx.times))):
            g.ts.q.copy_(ctx.stack[k])
            g.clock.fill_(ctx.times[k])
            g.adjoint_step()
            while i > 0 and segments[i].start == k:
                src_c, has_src = segments[i].perm
                g.dq.copy_(_unpermute(g.dq, src_c, has_src))
                g.daux.copy_(_unpermute(g.daux, src_c, has_src))
                i -= 1
                load(segments[i])
        return g.dq.clone(), g.daux.clone(), None, None, None, None


# the fitting window's graphs, least recently used first: their own cache,
# so a fit does not evict the simulate graphs of _GRAPHS.  Four pairs: a
# mesh step's (its shard, its group) and a tile-cap overflow's beside the
# single-device fit's, so that neither evicts it
_FIT_GRAPHS: "collections.OrderedDict[tuple, _FittingGraphs]" = (
    _register(4))


def _fitting_graphs(ts: TiledState, model: MPMModel, bcs, grid: GridConfig,
                    tc: TileConfig, dt: float, group=None) -> _FittingGraphs:
    """The cached fitting graphs of (tc, grid, dt, the device, gravity and
    the BC set by value, the process group by identity): a new logE / y
    (any other field of model) or a new BC set with the same values
    captures nothing, a new group captures anew (the graphs keep it
    alive, so no later group takes its id)."""
    key = (tc, grid, dt, ts.q.device, _values(model.gravity), _values(bcs),
           _identity(group, []))
    return _cached(_FIT_GRAPHS, key, lambda: _FittingGraphs(
        ts, model, bcs, grid, tc, dt, group))


def _fitting_window(ts: TiledState, model: MPMModel, bcs, time: float,
                    n_substeps: int, grid: GridConfig, tc: TileConfig,
                    dt: float, group=None) -> TiledState:
    """n_substeps fitting substeps from a bucketed ts through
    ``_FittingWindow`` (graphs from ``_fitting_graphs``); differentiable in
    ts.q and ts.aux.  ``group``: ts buckets this rank's particle shard and
    the grid is summed over the group's ranks, as in
    ``substep_tiled_fitting``; ts.ok is this rank's."""
    graphs = _fitting_graphs(ts, model, bcs, grid, tc, dt, group)
    return TiledState(*_FittingWindow.apply(ts.q, ts.aux, ts, graphs, time,
                                            n_substeps))


def run_substeps_tiled_fitting(
    soa: SoAState,
    model: MPMModel,
    bcs,
    time: float,
    n_substeps: int,
    grid: GridConfig,
    dt: float,
    tc: Optional[TileConfig] = None,
    *,
    group=None,
):
    """Differentiable fitting window in the tiled layout.

    Returns (soa', time', ok): ok is False when the occupied-tile cap
    overflowed at bootstrap or at a rebucket; the caller then redoes the
    frame on the golden engine (sim/solver.py:run_substeps).  While
    autograd records, only the particle rows are kept between substeps and
    the grid is recomputed in the backward pass, the JAX package's memory
    policy: on CUDA the window is one ``_FittingWindow`` (a forward and an
    adjoint CUDA graph, captured once per tile config, grid, dt, gravity,
    BC set and process group; ``run_substeps_tiled_fitting.captures`` /
    ``replays`` / ``host_reads`` / ``rebuckets`` count their work),
    elsewhere each substep is checkpointed (``substep_tiled_fitting``).
    ``group``: soa is this rank's particle shard and the grid is summed
    over the group's ranks, the all-reduces inside the graphs on CUDA; ok
    is this rank's, the caller reduces it.
    """
    n = soa.mass.shape[0]
    if tc is None:
        tc = default_tile_config(grid.n_grid, n)
    ts = bootstrap(soa, model, grid, tc)
    if ts.q.device.type == "cuda" and torch.is_grad_enabled():
        ts = _fitting_window(ts, model, bcs, time, n_substeps, grid, tc, dt,
                             group)
        for _ in range(n_substeps):
            time = _advance(time, dt)
    else:
        for _ in range(n_substeps):
            ts = substep_tiled_fitting(ts, model, bcs, time, grid, tc, dt,
                                       group=group)
            time = _advance(time, dt)
    q = to_original_order(ts, n)
    return unpack_q(q, soa), time, ts.ok


run_substeps_tiled_fitting.captures = run_substeps_tiled_fitting.replays = 0
run_substeps_tiled_fitting.host_reads = 0
run_substeps_tiled_fitting.rebuckets = 0


def run_substeps_tiled(
    soa: SoAState,
    model: MPMModel,
    bcs,
    time: float,
    n_substeps: int,
    grid: GridConfig,
    dt: float,
    *,
    tc: Optional[TileConfig] = None,
):
    """n_substeps in tiled layout; converts SoA <-> tiled at the ends.

    Returns (soa, time, ok).
    """
    n = soa.mass.shape[0]
    if tc is None:
        tc = default_tile_config(grid.n_grid, n)
    ts = bootstrap(soa, model, grid, tc)
    for _ in range(n_substeps):
        ts = substep_tiled(ts, model, bcs, time, grid, tc, dt)
        time = _advance(time, dt)
    q = to_original_order(ts, n)
    return unpack_q(q, soa), time, ts.ok
