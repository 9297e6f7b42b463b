"""Wrappers of the tiled MPM transfer kernels (csrc/mpm_transfer.cu,
csrc/mpm_sored.cu).

Counterpart of gsmpm_tpu/sim/pallas_mpm.py: ``p2g_tiled`` replaces
``p2g_tiled_pallas`` (kernel K1, ``_p2g_kernel``), ``g2p_tiled`` replaces
``g2p_tiled_pallas`` (kernel K2, ``_g2p_kernel``) and ``sored_tiled``
replaces ``sored_tiled_pallas`` (kernel K6, ``_sored_kernel``).  A wrapper
given CPU tensors returns its plain twin (``p2g_tiled_ref`` /
``g2p_tiled_ref`` from sim/tiles.py, ``sored_tiled_ref`` from
sim/transfer_vjp.py); given CUDA tensors it launches the kernel on the
current stream or raises.  Each wrapper counts its launches in
``<wrapper>.launches``.  A launch recorded into a CUDA graph capture counts
in ``<wrapper>.captured`` instead: the graph's replays add what it holds
to ``launches`` (sim/tiles.py's substep graph and the fit window's
forward and adjoint graphs).
"""

from __future__ import annotations

import ctypes

import torch

from gsmpm_tpu_torch.sim.state import GridConfig
from gsmpm_tpu_torch.sim.tiles import (
    QROWS,
    T_TILE,
    TileConfig,
    TiledState,
    g2p_tiled_ref,
    p2g_tiled_ref,
)
from gsmpm_tpu_torch.utils import build

__all__ = ["p2g_tiled", "g2p_tiled", "g2p_blocks", "sored_tiled",
           "sored_launch_info", "p2g_tiled_ref", "g2p_tiled_ref"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    lib = build.load("mpm_transfer")
    lib.gsmpm_p2g_tiled.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _F, _F, _F, _VP]
    lib.gsmpm_p2g_tiled.restype = ctypes.c_int
    lib.gsmpm_g2p_tiled.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _F, _VP]
    lib.gsmpm_g2p_tiled.restype = ctypes.c_int
    lib.gsmpm_g2p_blocks.argtypes = [_I]
    lib.gsmpm_g2p_blocks.restype = ctypes.c_int
    return lib


def _need(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tables(ts: TiledState, tc: TileConfig):
    """(nchunk, NP) of ts: all of tc's chunks, or a rank's slice of them
    under a mesh (parallel/tiled_sharded.py)."""
    dev = ts.q.device
    if dev.type != "cuda":
        raise RuntimeError(f"no CUDA kernel for tensors on {dev}")
    nchunk = ts.chunk_tile.shape[0]
    _need(ts.q, "q", (QROWS, nchunk * tc.S), torch.float32, dev)
    for name in ("chunk_tile", "chunk_live"):
        _need(getattr(ts, name), name, (nchunk,), torch.int32, dev)
    return nchunk, nchunk * tc.S


def _count(wrapper) -> None:
    """One launch of wrapper's kernel: run now, or recorded into the
    capture of a CUDA graph, which runs it at each replay."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def p2g_tiled(ts: TiledState, sig: torch.Tensor, grid: GridConfig,
              tc: TileConfig, dt: float) -> torch.Tensor:
    """q (QROWS,NP) + stress (16,NP) -> octant windows (ntiles, 256, 64)."""
    if ts.q.device.type == "cpu":
        return p2g_tiled_ref(ts, sig, grid, tc, dt)
    nchunk, np_rows = _check_tables(ts, tc)
    _need(sig, "sig", (16, np_rows), torch.float32, ts.q.device)
    out = torch.empty((tc.ntiles, 8 * 4 * T_TILE, T_TILE * T_TILE),
                      dtype=torch.float32, device=ts.q.device)
    lib = _lib()
    err = lib.gsmpm_p2g_tiled(
        ts.q.data_ptr(), sig.data_ptr(), ts.chunk_tile.data_ptr(),
        ts.chunk_live.data_ptr(), out.data_ptr(), np_rows, nchunk,
        tc.ntiles, tc.nt, tc.S, tc.n_grid, grid.dx, grid.inv_dx, dt,
        torch.cuda.current_stream(ts.q.device).cuda_stream,
    )
    build.check(lib, err, "p2g_tiled")
    _count(p2g_tiled)
    return out


def g2p_tiled(ts: TiledState, ext: torch.Tensor, grid: GridConfig,
              tc: TileConfig, dt: float) -> torch.Tensor:
    """q (QROWS,NP) + octant grid (ntiles, 192, 64) -> new q (QROWS,NP)."""
    if ts.q.device.type == "cpu":
        return g2p_tiled_ref(ts, ext, grid, tc, dt)
    nchunk, np_rows = _check_tables(ts, tc)
    _need(ext, "ext", (tc.ntiles, 8 * 3 * T_TILE, T_TILE * T_TILE),
          torch.float32, ts.q.device)
    out = torch.empty_like(ts.q)
    lib = _lib()
    err = lib.gsmpm_g2p_tiled(
        ts.q.data_ptr(), ext.data_ptr(), ts.chunk_tile.data_ptr(),
        ts.chunk_live.data_ptr(), out.data_ptr(), np_rows, nchunk,
        tc.nt, tc.S, tc.n_grid, grid.inv_dx, dt,
        torch.cuda.current_stream(ts.q.device).cuda_stream,
    )
    build.check(lib, err, "g2p_tiled")
    _count(g2p_tiled)
    return out


def g2p_blocks(nchunk: int) -> int:
    """CUDA blocks of one K2 launch over nchunk chunks, as the launch
    computes them (two chunks a block)."""
    return _lib().gsmpm_g2p_blocks(nchunk)


def _sored_lib():
    lib = build.load("mpm_sored")
    lib.gsmpm_sored_tiled.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP]
    lib.gsmpm_sored_tiled.restype = ctypes.c_int
    lib.gsmpm_sored_info.argtypes = [_I, ctypes.POINTER(_I)]
    lib.gsmpm_sored_info.restype = ctypes.c_int
    return lib


_SORED_INFO = ("ctas", "threads", "smem_bytes", "registers", "local_bytes",
               "ctas_per_sm", "sms")


def sored_launch_info(nchunk: int) -> dict:
    """K6's launch over nchunk chunks on the current device, as the CUDA
    runtime reports it: its persistent grid (CTAs, CTAs per SM, SMs), the
    threads and dynamic shared memory of a CTA, and the kernel's registers
    and local (spill) bytes per thread."""
    lib = _sored_lib()
    info = (_I * len(_SORED_INFO))()
    build.check(lib, lib.gsmpm_sored_info(nchunk, info), "sored_launch_info")
    return dict(zip(_SORED_INFO, info))


def sored_tiled(q: torch.Tensor, win_planes: torch.Tensor,
                chunk_tile: torch.Tensor, chunk_live: torch.Tensor,
                grid: GridConfig, tc: TileConfig) -> torch.Tensor:
    """Second-order basis reductions of the transfer VJPs: q (QROWS, NP)
    and the 3 window components' planes (ntiles, 48, 256) -> (64, NP) rows
    (layout in transfer_vjp.sored_tiled_ref, its plain twin)."""
    if q.device.type == "cpu":
        from gsmpm_tpu_torch.sim.transfer_vjp import sored_tiled_ref

        return sored_tiled_ref(q, win_planes, chunk_tile, chunk_live, grid,
                               tc)
    dev = q.device
    if dev.type != "cuda":
        raise RuntimeError(f"no CUDA kernel for tensors on {dev}")
    _need(q, "q", (QROWS, tc.np_rows), torch.float32, dev)
    _need(win_planes, "win_planes", (tc.ntiles, 48, 256),
          torch.float32, dev)
    if win_planes.data_ptr() % 16:
        raise ValueError("win_planes must start on 16 bytes (bulk copies)")
    for name, t in (("chunk_tile", chunk_tile), ("chunk_live", chunk_live)):
        _need(t, name, (tc.nchunk,), torch.int32, dev)
    out = torch.empty((64, tc.np_rows), dtype=torch.float32, device=dev)
    lib = _sored_lib()
    err = lib.gsmpm_sored_tiled(
        q.data_ptr(), win_planes.data_ptr(), chunk_tile.data_ptr(),
        chunk_live.data_ptr(), out.data_ptr(), tc.np_rows, tc.nchunk, tc.nt,
        tc.S, tc.n_grid, grid.inv_dx,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "sored_tiled")
    _count(sored_tiled)
    return out


p2g_tiled.launches = g2p_tiled.launches = sored_tiled.launches = 0
p2g_tiled.captured = g2p_tiled.captured = sored_tiled.captured = 0
