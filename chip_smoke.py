#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gsmpm_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Requires CUDA; prints ``nvidia-smi`` name and power limit.
2. Builds every kernel from gsmpm_tpu_torch/csrc/ (one nvcc per source)
   and the host C++ IO tier (g++), all started together, and times the
   build.
3. Simulation path (slice 1): holds K1, K2 and K3 against their plain
   PyTorch twins at the simulate path's shapes (245,760-gaussian box scene,
   n_grid 50, 800x800; the transfers on a state given seeded motion, the
   blend on frame 0), runs the port on the GPU and on the CPU at a small
   size, drives ``apps.simulate.simulate`` for 4 frames x 100 substeps and
   profiles 2 more frames.  K1's block count and K3's cull share of
   (slot, pixel group) pairs are printed.
4. Identification path (slice 2): ``apps.identify.identify`` at the bench
   configuration (245,760-gaussian blob, 512x512, 30 substeps per frame,
   E 1e4 -> 3e3; frame-0 appearance step, ground truth, 2 fit frames),
   then a timed steady-state loop of fit frames whose launches per frame
   are asserted exactly, a profile of one fit frame, K4 / K5 against their
   twins on the fit frame's real candidates (tier 1 and tier 2), K6 on the
   fit state, K1 and K2 on the fit state (the blob's dense tiles), and one
   small fit frame on the GPU and on the CPU.
5. Stream-rendered fit (slice 3, path A): a SystemIdentifier on the same
   blob with ``RasterConfig(stream=True)`` (ground truth at E 3e3, 2 fit
   frames, then steady fit frames with exact launches, one profiled), K7
   against its twin on the steady frame's real stream (K3 too, with its
   cull share), and one small
   stream fit frame on the GPU and on the CPU.
6. Packed windowed render (slice 3, path B): the steady stream-fit frame's
   geometry rendered with ``RasterConfig(packed=True)`` at drop-free caps,
   and its backward, held against the padded path (K4 / K5); K8 and K9
   against their twins on those inputs.
7. Slice 4, at the main path's width: apps.simulate's golden route
   (incremental_cov; a tile cap below the boot occupancy; a cap at it with
   the box pushed into new tiles, which overflows inside frame 1), a
   checkpoint and a resumed run against an uninterrupted one, and
   parallel/ on a one-rank NCCL group built in this process
   (MeshSimEngine's tiled and psum frames against the single-device
   frames, the tile-sharded render against the stream render, K1 / K2 /
   K4 against their twins on that path's inputs).  The sharded fit steps
   (slice 5) run on a one-rank group of their own after the
   identification path.
8. Slice 6, the halo engines, on a one-rank NCCL group of their own at
   the bench's secondary shape (the 245,760-gaussian box on the 100^3
   grid, 100 substeps): auto-selection picks tiled (ROADMAP C); one
   MeshSimEngine frame each of halo, halo_tiled and halo_tiled2d (1 x 1)
   with no fallback, exact K1 / K2 launches (100 each for the tiled pair,
   0 for halo), 0 bytes through the neighbour exchange, within 1e-4 of
   the single-device tiled (or golden) frame; K1 / K2 against their twins
   on the halo_tiled path's inputs; substeps/s of each.
9. Slice 7, at the main path's width: ``sim.MPMSolver`` for 2 frames of
   100 substeps against ``tiles.frame_tiled`` driven directly from the
   same state (K1 / K2 200 launches each, within 1e-4 of each field's
   max; substeps/s), its ``postprocess`` bit-equal to
   ``sim/solver.postprocess``, a tile cap below the boot occupancy taking
   the golden route (no K1 / K2 launch, within 1e-4 of ``run_substeps``);
   the native IO tier loaded (``io/_native.status()``), a
   245,760-gaussian 62-property PLY read and written by the native and
   the numpy codecs (bit-equal, both timed), and the main path's video
   plus an ``encode_avi`` of its frames checked chunk by chunk (RIFF,
   ``movi``, ``idx1``, one JPEG ``00dc`` chunk a frame).
10. Slice 8, at the bench fit's width: an observed dataset of identify's
   scene (2 ring cameras x 3 frames at 512^2) written by
   scripts/torch_observed_dataset.py, each PNG re-encoded with a seeded
   filter per row (all five types), decoded by the native row unfilter
   and by its numpy twin (byte-equal; both times printed), then
   ``apps.identify --data_path`` for 2 fit frames (finite losses, E moving,
   no drops, the tiled-VJP engine, K1 / K2 / K4 / K5 / K6 launched and
   K3 / K7 / K8 / K9 not); gsmpm_tpu's interface on the card: a
   RasterConfig with every TPU-only knob set renders the main path's
   frame 0 bit-equal to the default (windowed and stream),
   ``drop_low_opacity`` feeds one MPMSolver frame (K1 / K2 100 each),
   tied ``MPMModel.E()`` / ``nu()`` equal ``optimized_E`` / ``nu``.
11. The culled walks (K4 and K5 per tier, K7, K8, K9) also print their
   CUDA blocks, the culled share of (slot, 16 x 8 pixel group) pairs, the
   walk depth and a rerun bit-equality check (K8 also against K4 and K9
   against K5 on the same windows); their bounds charge the gate to the
   walked pairs inside the cull box, with the all-walked bound beside
   them.
12. Slice 9, at the main path's width: ``tiles.frame_tiled`` replaying
   its captured substep (a CUDA graph of the particle phase, K1, the grid
   phase, K2, the drift flag and the float32 clock) against the eager
   ``substep_tiled`` loop in turns (eager, graph, eager, graph; 2 frames
   of 100 substeps each) from one state: substeps/s, exact K1 / K2
   launches, captures, replays and host reads, the graph's pool bytes,
   each field within 1e-4 of its max of the eager loop, the device clock's
   bits, the device busy share of one profiled frame of each; then one
   frame of the pushed box, which rebuckets without re-capture.  The
   simulate path and the solver phase run the same graph.
13. Slice 10, at the bench fit's width: fit frames whose window runs
   ``tiles._FittingWindow`` (a forward CUDA graph of one fitting substep
   replayed 30 times, an adjoint graph that recomputes a substep and takes
   its VJP replayed 30 times backwards) against frames whose window runs
   the checkpointed ``substep_tiled_fitting`` loop, in turns (eager,
   graph, eager, graph; 2 frames each) from one state: frame seconds,
   exact K1 / K2 / K6 launches (90 / 150 / 60), captures / replays / host
   reads, both graphs' pool bytes, peak memory, g_logE / g_y against the
   eager frame's, one profiled frame of each (busy share, and the host ms
   and launches of window forward, render + loss forward, their backward
   and the window backward), the replays back to back.  identify, the
   steady fits (windowed and stream), camera-DP and ``--data_path`` run
   the same graphs.
14. Slice 11, the mesh paths as one program, on the one-rank NCCL groups
   of 7. and of the mesh fit: the tiled engine's frame (segments of the
   captured substep, the grid's NCCL all-reduce inside the graph, the
   gathered rebucket and the hard-drift flag eager between segments)
   against its eager ``substep_tiled(group=)`` segment loop in turns
   (eager, graph, eager, graph; 2 frames each) from one state:
   substeps/s, exact K1 / K2 launches, captures / replays / host reads,
   each field within 1e-4 of its max, the device clock's bits, the busy
   share of one profiled frame of each; and the 1 x 1 sharded fit step
   with the fitting window's graphs (the all-reduces of the forward, the
   recompute and its VJP inside) against the same step on the
   checkpointed ``substep_tiled_fitting(group=)`` loop in turns (2 steps
   each): step seconds, exact K1 / K2 / K6 launches, replays and host
   reads, g_logE / g_y within 1e-3 of the eager step's largest.  Each
   group's cached graphs are freed before the group is destroyed.
15. Slice 12, the golden engine as one program: at simulate's width with
   incremental_cov, ``sim/solver.run_substeps`` replaying its captured
   golden substep against chip_smoke's own eager ``kernels.substep_soa``
   loop in turns (eager, graph, eager, graph; one frame of 100 substeps
   each) from one state: substeps/s, captures / replays, the pool bytes,
   each field within 1e-4 of its max, the device clock's bits, the busy
   share of one profiled graph frame and of 10 profiled eager substeps
   (their launches a substep); and at the bench fit's width with the fit
   forced onto the golden engine, fit frames whose window runs
   ``_GoldenFittingWindow`` (a forward and an adjoint CUDA graph) against
   frames on the checkpointed ``substep_soa`` loop, in turns (one frame
   each): frame seconds, g_logE / g_y within 1e-3 of the largest, both
   pools, peak memory.  The golden route, the solver's golden frame, the
   ground truth, the psum mesh frame and the mesh fit's overflow redo
   each assert that the golden graph counters moved.
16. Every path is driven with every launch counter set to 0 just before it
   and read just after; each kernel of a path must have launched there.
17. Prints each path's numbers as JSON, the ``nvidia-smi`` name and power
   limit line, one JSON line with every kernel's numbers (error, kernel /
   twin / bound time and launches on its path), and a last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero without the last line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# fp32 operations of a reverse blend walk (K5, K7, K9) per (slot, pixel)
# pair: the gate (5 mul and 6 add of the power, exp, min, three compares)
# for every pair it evaluates, and for a pair that passes the gate at or
# before the pixel's last contributor >= 33 more (1 - alpha, the division,
# w, c . g, dA, dpower, the suffix update, 9 accumulating multiply-adds)
GATE_OPS, BWD_CONTRIB_OPS = 16, 33

MAIN_N = 245_760
MAIN_RES = 800
MAIN_FRAMES = 4
PROFILE_FRAMES = 2
PROFILE_TOP = 12
# slice 9's graph phase: frames per turn of eager and graph runs
GRAPH_FRAMES = 2
# the identification path: bench.py's fit configuration
FIT_RES = 512
FIT_FRAMES = 3          # frame 0 (appearance) + 2 fit frames
FIT_E_INIT, FIT_E_TRUE = 1e4, 3e3
STEADY_FRAMES = 2
FIT_SUBSTEPS = 30
# launches per fit frame: per substep K1 3 (forward, the recompute of the
# adjoint graph or the checkpoint, the fake P2G of G2P's backward), K2 5
# (forward, recompute, three fake G2Ps) and K6 2 (one per transfer
# backward), replays counting what their graph holds; the render's kernels
# once per frame and direction (K4 / K5 once per tier, or K3 / K7), never
# recomputed
PER_SUBSTEP = {"p2g_tiled": 3, "g2p_tiled": 5, "sored_tiled": 2}
OUT_DIR = Path(__file__).resolve().parent / "outputs" / "chip_smoke"
# slice 7's MPMSolver phase: frames of 100 substeps, the golden route's
# substeps, and the solver against frame_tiled driven directly, relative to
# each field's max (at least 1): K1's float atomics sum in another order in
# each run (the halo phase's tolerance for the same engine's frames)
SOLVER_FRAMES = 2
SOLVER_GOLDEN_STEPS = 10
SOLVER_RTOL = 1e-4
# the golden-route phase's push along +y (m/s after 5 substeps)
PUSH_SPEED = 10.0
# the golden route's redone frame against golden from the start, relative
# to each field's max (at least 1): the CPU tests' tolerance for two
# engines' float sums in other orders (C, the velocity moments scaled by
# 4 / dx^2, 1e-4)
GOLDEN_RTOL = dict(x=1e-5, v=1e-5, F=1e-5, F_trial=1e-5, C=1e-4)
# a mesh fit step against a single-device fit frame, beside twice the
# spread of two single-device runs: K1's float atomics move the state by
# ~1e-6 of its scale and flip depth ties in the render, so two runs of the
# bench fit frame on an H100 differ by up to ~2e-3 of the loss and by
# 0.27-0.38 at single pixels (the image's largest difference is printed,
# not held), and the sharded step's rows render (exact depth order) sits
# up to ~4e-3 of the loss from the two-tier render (quantized depth).  Of
# each value: the loss 2e-2, the tied gradients 1e-3 (the CPU tests'
# gradient tolerance), the updated pair 1e-6 (~8 float32 ulps of logE ~ 4)
MESH_FIT_REL = dict(loss=2e-2, g_logE=1e-3, g_y=1e-3, logE=1e-6, y=1e-6)
# a kernel row's numbers beyond the required keys, copied into the kernels
# line: the share of the bound, K1 and K2 at the fit's shapes and their
# blocks, K3's cull, K4/K5 per tier, the culled walks' blocks, cull,
# all-walked bound, depth and rerun; K6's timed batches, its and its
# float32 twin's error against the twin in float64, its registers, the
# time of zero_ on its output's shape
ROW_EXTRAS = ("per_tier", "blocks", "rel_err", "share", "fit_ms",
              "fit_plain_ms", "fit_bound_ms", "fit_bound_by", "fit_share",
              "fit_max_abs_err", "fit_rel_err", "fit_blocks",
              "culled_share", "bound_all_walked_ms", "kept_pairs",
              "bit_equal", "depth_max", "depth_mean", "mesh_rel_err",
              "mesh_max_abs_err", "mesh_ms", "mesh_K",
              "mesh_fit_max_abs_err", "mesh_fit_rel_err", "mesh_fit_ms",
              "mesh_fit_K", "halo_rel_err", "ms_batches", "f64_rel_err",
              "twin_f64_rel_err", "registers", "store_floor_ms")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn over reps back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def batch_ms(fn, batches: int = 9, reps: int = 20):
    """cuda_ms of fn over `batches` batches of `reps` calls: (the median,
    every batch's ms)."""
    ms = [cuda_ms(fn, reps, 2 if i == 0 else 0) for i in range(batches)]
    return float(np.median(ms)), ms


def card_state() -> str:
    """nvidia-smi's SM and memory clocks, power draw and temperature."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bench_config(n_grid: int = 50, substep_dt: float = 1e-4,
                 frame_dt: float = 1e-2, output_path: str = ""):
    """The bench cell's simulation config (bench.py's build_problem): jelly,
    E 2e5, nu 0.3, density 200, grid extent 2; 100 substeps per frame at
    the defaults."""
    from gsmpm_tpu_torch.config import MPMConfig, RenderConfig, SimConfig

    return SimConfig(
        mpm=MPMConfig(E=2e5, nu=0.3, material="jelly", n_grid=n_grid,
                      grid_extent=2.0, substep_dt=substep_dt,
                      frame_dt=frame_dt, density=200.0),
        render=RenderConfig(output_path=output_path),
    )


def seeded_motion(ts):
    """ts with seeded velocity, APIC C and F_trial perturbations on its real
    slots.  The scene's first state has v = 0, C = 0 and F_trial = I, where
    the momentum, APIC and stress terms of the transfers all vanish."""
    from gsmpm_tpu_torch.sim import tiles

    rng = np.random.default_rng(0)
    q = ts.q.clone()
    live = (q[tiles.RMASS] > 0).to(q.dtype)
    for r0, n, std in ((tiles.RV, 3, 2.0), (tiles.RC, 9, 10.0),
                       (tiles.RFT, 9, 0.02)):
        noise = rng.normal(size=(n, q.shape[1])).astype(np.float32)
        q[r0:r0 + n] += std * torch.from_numpy(noise).to(q.device) * live
    return dataclasses.replace(ts, q=q)


def window_components(win):
    """(ntiles, 256, 64) P2G windows -> (4, -1): mass, momentum x, y, z
    (window row oct*32 + comp*8 + xl)."""
    return win.reshape(-1, 8, 4, 8, 64).transpose(0, 2).reshape(4, -1)


def p2g_phase(ts, sig, grid, tc, dt, label):
    """K1 against its twin on one tiled state, its time and its bound.
    Returns (K1's windows, its kernels-table row)."""
    from gsmpm_tpu_torch.sim import cuda_mpm, tiles

    win_k = cuda_mpm.p2g_tiled(ts, sig, grid, tc, dt)
    win_r = cuda_mpm.p2g_tiled_ref(ts, sig, grid, tc, dt)
    torch.cuda.synchronize()
    comp_scale = window_components(win_r).abs().amax(dim=1)
    comp_err = window_components(win_k - win_r).abs().amax(dim=1)
    rel1 = comp_err / comp_scale
    # how far the stress and the APIC term each move the momentum rows: a
    # kernel that got either wrong would miss by about that much
    no_stress = cuda_mpm.p2g_tiled_ref(ts, torch.zeros_like(sig), grid, tc, dt)
    q_no_c = ts.q.clone()
    q_no_c[tiles.RC:tiles.RC + 9] = 0.0
    no_apic = cuda_mpm.p2g_tiled_ref(dataclasses.replace(ts, q=q_no_c), sig,
                                     grid, tc, dt)
    share = {k: (window_components(win_r - w).abs().amax(dim=1)
                 / comp_scale)[1:]
             for k, w in (("stress", no_stress), ("APIC", no_apic))}
    print(f"K1 p2g ({label}): relative err mass / momentum x, y, z "
          + " / ".join(f"{float(e):.3g}" for e in rel1)
          + "; momentum scale " + " ".join(f"{float(c):.4g}"
                                           for c in comp_scale[1:])
          + "; share of momentum moved by "
          + ", ".join(f"{k} {float(v.min()):.3g}" for k, v in share.items()),
          flush=True)
    check(bool((comp_scale > 0).all()), f"K1 inputs: zero rows {comp_scale}")
    for k, v in share.items():
        check(float(v.min()) >= 1e-3, f"K1 inputs: {k} term too small {v}")
    err1 = float(comp_err.max())
    rel1 = float(rel1.max())
    # float atomics add in a run-dependent order: 1e-5 of each component's
    # largest entry (mass and each momentum component on its own)
    check(rel1 <= 1e-5, f"K1 p2g ({label}): relative err {rel1}")

    live = ts.chunk_live == 1
    per_tile = torch.bincount(ts.chunk_tile[live].to(torch.int64),
                              minlength=tc.ntiles)
    ms1 = cuda_ms(lambda: cuda_mpm.p2g_tiled(ts, sig, grid, tc, dt), 20)
    pms1 = cuda_ms(lambda: cuda_mpm.p2g_tiled_ref(ts, sig, grid, tc, dt), 3, 1)
    n_live = int(live.sum()) * tc.S
    n_real = int((ts.q[tiles.RMASS] > 0).sum())
    # must read x, v, C, mass, vol (17 rows) and 9 stress rows of the live
    # slots, write the windows; ~1260 flops per real particle
    b1 = bound_ms(n_live * 26 * 4 + win_k.numel() * 4, n_real * 1260.0)
    # one block per chunk: the live chunks' blocks work, the dead return
    print(f"K1 p2g ({label}): {n_real} particles in {int(live.sum())} live "
          f"chunks of {int((per_tile > 0).sum())} tiles (densest "
          f"{int(per_tile.max())} chunks); {int(live.sum())} working blocks "
          f"of {tc.nchunk} launched, 1 chunk each: {ms1:.4f} ms "
          f"(plain {pms1:.3f}, bound {b1[0]:.4f} {b1[1]})", flush=True)
    return win_k, dict(
        name="p2g_tiled", route="cuda",
        source="gsmpm_tpu_torch/csrc/mpm_transfer.cu",
        replaces="gsmpm_tpu/sim/pallas_mpm.py:160",
        max_abs_err=err1, rel_err=rel1, tol="1e-5 x max per component",
        ms=ms1, plain_ms=pms1, bound_ms=b1[0], bound_by=b1[1],
        library_ms=None, wrapper=cuda_mpm.p2g_tiled,
        blocks=int(live.sum()))


def g2p_phase(ts, ext, grid, tc, dt, label):
    """K2 against its twin on one tiled state and its velocity blocks, its
    time and its bound.  Returns (its kernels-table row, drift flags
    differing)."""
    from gsmpm_tpu_torch.sim import cuda_mpm, tiles

    dev = ts.q.device
    n_real = int((ts.q[tiles.RMASS] > 0).sum())
    q_k = cuda_mpm.g2p_tiled(ts, ext, grid, tc, dt)
    q_r = cuda_mpm.g2p_tiled_ref(ts, ext, grid, tc, dt)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(q_k).all()), "K2 g2p: non-finite output")
    # error scale per row group: the twin's largest entry in the group
    groups = {"x": (tiles.RX, 3), "v": (tiles.RV, 3), "C": (tiles.RC, 9),
              "F_trial": (tiles.RFT, 9)}
    scale = torch.ones(tiles.QROWS, dtype=torch.float64, device=dev)
    for r0, n in groups.values():
        scale[r0:r0 + n] = float(q_r[r0:r0 + n].abs().max())
    cont = [r for r in range(tiles.QROWS) if r != tiles.RDRIFT]
    diff = (q_k - q_r).abs().to(torch.float64)
    err2 = float(diff[cont].max())
    rel_rows = diff.amax(dim=1) / scale
    rel2 = float(rel_rows[cont].max())
    # dt grad(v) F: how far a wrong velocity gradient would move F_trial
    step = float((q_r[tiles.RFT:tiles.RFT + 9]
                  - q_r[tiles.RF:tiles.RF + 9]).abs().max())
    f_scale = float(scale[tiles.RFT])
    print(f"K2 g2p ({label}): relative err by group "
          + ", ".join(f"{k} {float(rel_rows[r0:r0 + n].max()):.3g}"
                      for k, (r0, n) in groups.items())
          + "; scales " + ", ".join(f"{k} {float(scale[r0]):.4g}"
                                    for k, (r0, n) in groups.items())
          + f"; max |F_trial - F| {step:.3g}"
          + f"; copied rows max abs {float(diff[tiles.RF:tiles.RF + 9].max())}"
          f" / {float(diff[tiles.RMASS:tiles.RDRIFT].max())}", flush=True)
    check(step >= 5e-4 * f_scale,
          f"K2 inputs: velocity gradient too small ({step} vs |F| {f_scale})")
    drift_mismatch = int((q_k[tiles.RDRIFT] != q_r[tiles.RDRIFT]).sum())
    # gathers summed in another order than the twin's bmm: 1e-5 of each
    # group's largest entry; drift flags may flip only for positions
    # exactly on a cell boundary
    check(rel2 <= 1e-5, f"K2 g2p ({label}): relative err {rel2}")
    check(drift_mismatch <= 8,
          f"K2 g2p ({label}): {drift_mismatch} drift flags differ")
    ms2 = cuda_ms(lambda: cuda_mpm.g2p_tiled(ts, ext, grid, tc, dt), 20)
    pms2 = cuda_ms(lambda: cuda_mpm.g2p_tiled_ref(ts, ext, grid, tc, dt), 3, 1)
    occupied = int(torch.unique(ts.chunk_tile[ts.chunk_live == 1]).numel())
    # must read x, F, mass and the copied rows (18 rows) of every slot and
    # the occupied tiles' velocity blocks, write all 40 rows; ~1900 flops
    # per real particle
    b2 = bound_ms(tc.np_rows * (18 + 40) * 4 + occupied * 192 * 64 * 4,
                  n_real * 1900.0)
    live = ts.chunk_live == 1
    per_tile = torch.bincount(ts.chunk_tile[live].to(torch.int64),
                              minlength=tc.ntiles)
    blocks = cuda_mpm.g2p_blocks(tc.nchunk)
    print(f"K2 g2p ({label}): {n_real} particles in {int(live.sum())} live "
          f"chunks of {occupied} tiles (densest {int(per_tile.max())} "
          f"chunks), {tc.nchunk} chunks in {blocks} CUDA blocks: "
          f"{ms2:.4f} ms (plain {pms2:.3f}, "
          f"bound {b2[0]:.4f} {b2[1]}, share {b2[0] / ms2:.3f}); drift flags "
          f"differing {drift_mismatch}", flush=True)
    return dict(
        name="g2p_tiled", route="cuda",
        source="gsmpm_tpu_torch/csrc/mpm_transfer.cu",
        replaces="gsmpm_tpu/sim/pallas_mpm.py:293",
        max_abs_err=err2, rel_err=rel2, tol="1e-5 x max per row group",
        ms=ms2, plain_ms=pms2, bound_ms=b2[0], bound_by=b2[1],
        library_ms=None, wrapper=cuda_mpm.g2p_tiled, occupied=occupied,
        blocks=blocks), drift_mismatch


def kernel_phases(dev):
    """K1, K2 on a moved main-path state and K3 on frame 0, each against
    its plain twin."""
    from gsmpm_tpu_torch.apps.simulate import prepare
    from gsmpm_tpu_torch.render.renderer import RasterConfig, preprocess
    from gsmpm_tpu_torch.render import stream_raster as sr
    from gsmpm_tpu_torch.sim import cuda_mpm, tiles
    from gsmpm_tpu_torch.sim.kernels import soa_from_state

    cfg = bench_config(output_path=str(OUT_DIR / "phases"))
    dt = cfg.mpm.substep_dt
    su = prepare(cfg, synthetic=MAIN_N, synthetic_res=MAIN_RES,
                 device=str(dev), quiet=True)
    grid, tc = su.grid, su.tc
    ts = seeded_motion(tiles.bootstrap(soa_from_state(su.state), su.model,
                                       grid, tc))
    ts, sig = tiles.particle_phase(ts, su.model, su.bcs, 0.0, dt)
    rows = []
    n_live = int(ts.chunk_live.sum()) * tc.S
    n_real = int((ts.q[tiles.RMASS] > 0).sum())

    # ---- K1 P2G
    win_k, row = p2g_phase(ts, sig, grid, tc, dt, "simulate")
    rows.append(row)

    # ---- K2 G2P (input: this substep's grid velocities)
    ext = tiles.grid_phase(win_k, su.model, su.bcs, 0.0, grid, tc, dt)
    row, drift_mismatch = g2p_phase(ts, ext, grid, tc, dt, "simulate")
    rows.append(row)
    occupied = row["occupied"]

    # ---- K3 stream forward (input: frame 0 of the main path)
    rcfg = RasterConfig(stream=True)
    w_xyz, w_cov = su.world(su.state.x, su.state.cov)
    pre = preprocess(w_xyz, w_cov, su.opacity, su.features, su.camera,
                     su.scene.sh_degree, rcfg)
    splanes, bounds, nd, lv = sr.stream_inputs(pre, su.camera, rcfg)
    check(int(nd) == 0, f"K3 inputs: n_dropped {int(nd)}")
    args = (splanes, bounds, lv.nbx, rcfg.block, rcfg.t_min, rcfg.alpha_min)
    out_k = sr.stream_blend(*args)
    out_r = sr.stream_blend_ref(*args)
    torch.cuda.synchronize()
    err3 = float((out_k[:, 0:4] - out_r[:, 0:4]).abs().max())
    done_mismatch = float((out_k[:, 4] != out_r[:, 4]).float().mean())
    # sequential vs chunked transmittance products round differently; the
    # JAX package's own stream-vs-XLA tolerance (2e-3), and at most 1e-4 of
    # the pixels may change their done flag
    check(err3 <= 2e-3, f"K3 stream: max err {err3}")
    check(done_mismatch <= 1e-4, f"K3 stream: done flags differ {done_mismatch}")
    ms3 = cuda_ms(lambda: sr.stream_blend(*args), 20)
    pms3 = cuda_ms(lambda: sr.stream_blend_ref(*args), 1, 1)
    cull = k3_cull(splanes, bounds, out_k, lv.nbx, rcfg.block,
                   rcfg.alpha_min)
    b3 = k3_bound(splanes, bounds, out_k, cull)
    print(f"K3 stream (simulate): {cull['culled_share']:.4f} of the (slot, "
          f"16x8 pixel group) pairs culled; walked pairs {cull['pairs']:.4g}"
          f", kept by the cull {cull['kept_pairs']:.4g}; {ms3:.4f} ms, bound "
          f"{b3[0]:.4f} {b3[1]}", flush=True)
    rows.append(dict(
        name="stream_blend", route="cuda",
        source="gsmpm_tpu_torch/csrc/stream_raster.cu",
        replaces="gsmpm_tpu/render/stream_raster.py:315",
        max_abs_err=err3, rel_err=err3, tol="2e-3 abs on rgb/T",
        ms=ms3, plain_ms=pms3, bound_ms=b3[0], bound_by=b3[1],
        library_ms=None, wrapper=sr.stream_blend, L=int(splanes.shape[1]),
        **cull))
    for r in rows:
        print(f"{r['name']}: max_abs_err {r['max_abs_err']:.3g} rel "
              f"{r['rel_err']:.3g} (tol {r['tol']}) kernel {r['ms']:.4f} ms "
              f"plain {r['plain_ms']:.3f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    print(f"main-path shapes: NP {tc.np_rows}, nchunk {tc.nchunk}, live "
          f"chunks {n_live // tc.S}, occupied tiles {occupied}, real "
          f"particles {n_real}, stream slots {splanes.shape[1]}, "
          f"pairs {cull['pairs']:.4g}, K2 drift flags differing "
          f"{drift_mismatch}, "
          f"K3 done flags differing {done_mismatch:.3g}", flush=True)
    return rows


def k3_cull(splanes, bounds, out, nbx, B, alpha_min, chunk=2048):
    """K3's walk on this data: the share of the (slot in a segment, 16 x 8
    pixel group of its block) pairs that the cull (stream_raster.
    cull_boxes) skips, the (slot, pixel) pairs of the walk (each pixel up
    to its last contributor when done, else to its segment's end) and the
    ones among them whose pixel lies in the slot's box (the pairs K3
    evaluates)."""
    from gsmpm_tpu_torch.render import stream_raster as sr

    dev = splanes.device
    nf = bounds.numel() - 1
    lo = bounds[:-1].to(torch.int64)
    hi = bounds[1:].to(torch.int64)
    s0, s1 = int(bounds[0]), int(bounds[-1])
    last = out[:, 5].to(torch.int64)
    end = torch.where(out[:, 4] > 0, torch.maximum(last, lo[:, None]),
                      hi[:, None])
    blk_all = torch.repeat_interleave(torch.arange(nf, device=dev), hi - lo)
    px, py = sr._pixel_coords(B, dev)[:2]
    gxn = B // 16
    r = torch.arange(gxn * (B // 8), device=dev)
    rx = ((r % gxn) * 16).float()
    ry = ((r // gxn) * 8).float()
    hits = kept = 0
    for c0 in range(s0, s1, chunk):
        ids = torch.arange(c0, min(c0 + chunk, s1), device=dev)
        blk = blk_all[ids - s0]
        p = splanes[:, ids]
        xl, xh, yl, yh = sr.cull_boxes(p[0] - ((blk % nbx) * B).float(),
                                       p[1] - ((blk // nbx) * B).float(), p,
                                       alpha_min)
        hits += int(((xl[:, None] <= rx + 15) & (xh[:, None] >= rx)
                     & (yl[:, None] <= ry + 7) & (yh[:, None] >= ry)).sum())
        inside = ((xl[:, None] <= px) & (px <= xh[:, None])
                  & (yl[:, None] <= py) & (py <= yh[:, None]))
        kept += int((inside & (ids[:, None] < end[blk])).sum())
    n = (s1 - s0) * r.numel()
    return dict(culled_share=1.0 - hits / max(n, 1),
                pairs=float((end - lo[:, None]).sum()),
                kept_pairs=float(kept))


def k3_bound(splanes, bounds, out, cull):
    """K3's bound: >= 20 fp32 operations per (slot, pixel) pair that the
    box test keeps (6 mul + 6 add for the power term, exp, clamp, two
    compares, the transmittance and three color updates); the bytes of the
    stream, the bounds and the blend state."""
    return bound_ms(splanes.numel() * 4 + bounds.numel() * 4
                    + out.numel() * 4, cull["kept_pairs"] * 20.0)


def _group_rects(B, dev):
    """The origins (x, y) of a block's 16 x 8 pixel groups, in the
    kernels' order."""
    gxn = B // 16
    r = torch.arange(gxn * (B // 8), device=dev)
    return ((r % gxn) * 16).float(), ((r // gxn) * 8).float()


def _group_max(v, B):
    """(n, B*B) per-pixel values -> (n, groups) the max of each group."""
    n = v.shape[0]
    return v.reshape(n, B // 8, 8, B // 16, 16).amax(dim=(2, 4)).reshape(
        n, -1)


def _box_hits(xl, xh, yl, yh, rx, ry, px, py):
    """Boxes (n,) against the groups (G,) and the pixels (P,): (meets
    (n, G), inside (n, P))."""
    meets = ((xl[:, None] <= rx + 15) & (xh[:, None] >= rx)
             & (yl[:, None] <= ry + 7) & (yh[:, None] >= ry))
    inside = ((xl[:, None] <= px) & (px <= xh[:, None])
              & (yl[:, None] <= py) & (py <= yh[:, None]))
    return meets, inside


def window_cull(F, out, meta, chunk=64):
    """The reverse walk of windows F (nblocks, 16, K) with blend state out
    (K5 / K9) on this data: the share of the walked (candidate, 16 x 8
    pixel group) pairs that no warp lists (the candidate's box,
    cuda_blend.window_boxes, misses the group, or the candidate lies past
    the group's last contributor), the (candidate, pixel) pairs of the
    unculled walk (each pixel back from its last contributor) and the ones
    among them whose pixel lies in the box (the pairs the kernel
    evaluates)."""
    from gsmpm_tpu_torch.render import cuda_blend as cb

    dev, B = F.device, meta.B
    last = out[:, 5]
    top = last.amax(dim=1)
    gtop = _group_max(last, B)
    rx, ry = _group_rects(B, dev)
    pix = torch.arange(B * B, device=dev)
    px, py = (pix % B).float(), (pix // B).float()
    walked = listed = kept = 0
    for c0 in range(0, int(top.max()), chunk):
        Fc = F[:, :, c0:c0 + chunk]
        nb, c = Fc.shape[0], Fc.shape[2]
        box = [v.reshape(-1) for v in cb.window_boxes(Fc, B, meta.alpha_min)]
        meets, inside = _box_hits(*box, rx, ry, px, py)
        idx1 = torch.arange(c0 + 1, c0 + 1 + c, device=dev).float()
        walked += int((idx1[None, :] <= top[:, None]).sum()) * rx.numel()
        listed += int((meets.reshape(nb, c, -1)
                       & (idx1[None, :, None] <= gtop[:, None, :])).sum())
        kept += int((inside.reshape(nb, c, -1)
                     & (idx1[None, :, None] <= last[:, None, :])).sum())
    return dict(culled_share=1.0 - listed / max(walked, 1),
                pairs=float(last.to(torch.float64).sum()),
                kept_pairs=float(kept), depth_max=float(top.max()),
                depth_mean=float(top.mean()))


def fwd_window_cull(F, counts, out, meta, chunk=256):
    """The forward walk of windows F (nblocks, 16, K) with blend state out
    (K4 / K8) on this data.  A pixel's stop is its last contributor when
    it is done, else its window's count; a 16 x 8 group's the largest of
    its pixels', a window's (its walk depth) the largest of its groups'.
    Returns the share of the walked (candidate, group) pairs (candidates
    before the group's stop) whose box (cuda_blend.window_boxes) misses
    the group, the (candidate, pixel) pairs of the unculled walk (before
    the pixel's stop) and the ones among them whose pixel lies in the box
    (the pairs the kernel evaluates), the walk depth's max and mean over
    the windows and the live candidates before each window's depth."""
    from gsmpm_tpu_torch.render import cuda_blend as cb

    dev, B = F.device, meta.B
    cnt = torch.minimum(counts.to(torch.int64),
                        torch.tensor(F.shape[2], device=dev))
    stop = torch.where(out[:, 4] > 0, out[:, 5],
                       cnt.to(torch.float32)[:, None])
    gstop = _group_max(stop, B)
    depth = stop.amax(dim=1)
    rx, ry = _group_rects(B, dev)
    pix = torch.arange(B * B, device=dev)
    px, py = (pix % B).float(), (pix // B).float()
    listed = kept = 0
    for c0 in range(0, int(depth.max()), chunk):
        Fc = F[:, :, c0:c0 + chunk]
        nb, c = Fc.shape[0], Fc.shape[2]
        box = [v.reshape(-1) for v in cb.window_boxes(Fc, B, meta.alpha_min)]
        meets, inside = _box_hits(*box, rx, ry, px, py)
        idx = torch.arange(c0, c0 + c, device=dev).float()
        listed += int((meets.reshape(nb, c, -1)
                       & (idx[None, :, None] < gstop[:, None, :])).sum())
        kept += int((inside.reshape(nb, c, -1)
                     & (idx[None, :, None] < stop[:, None, :])).sum())
    walked = float(gstop.to(torch.float64).sum())
    return dict(culled_share=1.0 - listed / max(walked, 1.0),
                pairs=float(stop.to(torch.float64).sum()),
                kept_pairs=float(kept), depth_max=float(depth.max()),
                depth_mean=float(depth.mean()),
                read_cols=float(depth.to(torch.float64).sum()))


def k7_cull(splanes, bounds, out, nbx, B, alpha_min, chunk=2048):
    """K7's reverse walk on this data: the share of the walked (slot, 16 x
    8 pixel group) pairs that no warp lists (the slot's box,
    stream_raster.cull_boxes, misses the group, or the slot lies past the
    group's last contributor), the (slot, pixel) pairs of the unculled
    walk (each pixel back from its last contributor to its segment's
    start) and the ones among them whose pixel lies in the box."""
    from gsmpm_tpu_torch.render import stream_raster as sr

    dev = splanes.device
    nf = bounds.numel() - 1
    lo = bounds[:-1].to(torch.int64)
    hi = bounds[1:].to(torch.int64)
    last = out[:, 5]
    top = torch.minimum(last.amax(dim=1).to(torch.int64), hi)
    gtop = _group_max(last, B)
    s0, s1 = int(bounds[0]), int(bounds[-1])
    blk_all = torch.repeat_interleave(torch.arange(nf, device=dev), hi - lo)
    px, py = sr._pixel_coords(B, dev)[:2]
    rx, ry = _group_rects(B, dev)
    walked = listed = kept = 0
    for c0 in range(s0, s1, chunk):
        ids = torch.arange(c0, min(c0 + chunk, s1), device=dev)
        blk = blk_all[ids - s0]
        w = ids < top[blk]
        ids, blk = ids[w], blk[w]
        if ids.numel() == 0:
            continue
        p = splanes[:, ids]
        box = sr.cull_boxes(p[0] - ((blk % nbx) * B).float(),
                            p[1] - ((blk // nbx) * B).float(), p, alpha_min)
        meets, inside = _box_hits(*box, rx, ry, px, py)
        idx1 = (ids + 1).float()[:, None]
        walked += ids.numel() * rx.numel()
        listed += int((meets & (idx1 <= gtop[blk])).sum())
        kept += int((inside & (idx1 <= last[blk])).sum())
    depth = (top - lo).clamp_min(0).to(torch.float64)
    return dict(culled_share=1.0 - listed / max(walked, 1),
                pairs=float((last.to(torch.float64) - lo[:, None])
                            .clamp_min(0).sum()),
                kept_pairs=float(kept), depth_max=float(depth.max()),
                depth_mean=float(depth.mean()))


def small_parity(dev):
    """The whole port on the GPU vs on the CPU (plain twins) at a small
    size: 512 gaussians, n_grid 16, 2 frames x 10 substeps, 64x64."""
    from gsmpm_tpu_torch.apps.simulate import simulate

    frames = {}
    for d in (str(dev), "cpu"):
        cfg = bench_config(16, 1e-3, 1e-2, str(OUT_DIR / f"small_{d}"))
        frames[d] = simulate(cfg, synthetic=512, frames=2, quiet=True,
                             synthetic_res=64, device=d)
    err = max(float(np.abs(a - b).max())
              for a, b in zip(frames[str(dev)], frames["cpu"]))
    # float-atomic sum order on the GPU over 20 substeps, then the render
    check(err <= 1e-3, f"small GPU-vs-CPU frame err {err}")
    print(f"small GPU-vs-CPU parity: max frame err {err:.3g} (tol 1e-3)",
          flush=True)
    return err


def main_path(dev, wrappers):
    from gsmpm_tpu_torch.apps.simulate import simulate

    cfg = bench_config(output_path=str(OUT_DIR / "main"))
    stats = {}
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    frames = simulate(cfg, synthetic=MAIN_N, frames=MAIN_FRAMES, quiet=True,
                      synthetic_res=MAIN_RES, device=str(dev), stats=stats)
    wall = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in wrappers}
    check(len(frames) == MAIN_FRAMES + 1, "frame count")
    for f in frames:
        check(f.shape == (MAIN_RES, MAIN_RES, 3), f"frame shape {f.shape}")
        check(bool(np.isfinite(f).all()), "non-finite frame")
    check(all(n == 0 for n in stats["n_dropped"]),
          f"n_dropped {stats['n_dropped']}")
    motion = float(np.abs(frames[-1] - frames[0]).max())
    check(motion > 1e-3, f"no motion between first and last frame ({motion})")
    steps = MAIN_FRAMES * stats["substeps_per_frame"]
    check(counts["p2g_tiled"] == steps and counts["g2p_tiled"] == steps,
          f"transfer launches {counts}, expected {steps} each")
    check(counts["stream_blend"] >= MAIN_FRAMES + 1,
          f"stream launches {counts['stream_blend']}")
    sps = steps / sum(stats["sim_s"])
    render_ms = 1e3 * float(np.mean(stats["render_s"]))
    print(f"main path: {MAIN_N} gaussians, n_grid 50, {MAIN_RES}^2, "
          f"{MAIN_FRAMES} frames x {stats['substeps_per_frame']} substeps: "
          f"{sps:.2f} substeps/s, render {render_ms:.2f} ms/frame "
          f"(per frame sim {['%.3f' % s for s in stats['sim_s']]} s, render "
          f"{['%.1f' % (1e3 * s) for s in stats['render_s']]} ms), motion "
          f"{motion:.3g}, wall {wall:.1f} s, launches {counts}", flush=True)
    print(f"main path: video {stats['video']} ({stats['video_writer']}); "
          f"native IO tier: {stats['native_io']}", flush=True)
    return counts, dict(substeps_per_s=sps, render_ms_per_frame=render_ms,
                        sim_s=stats["sim_s"], render_s=stats["render_s"],
                        motion=motion, video=stats["video"],
                        video_writer=stats["video_writer"])


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_phase(dev, main):
    """Where the main path's time goes: ``simulate`` for PROFILE_FRAMES
    frames under torch.profiler (run after the main path, so nothing is
    built or first-called inside it).  Prints the device time by kernel and
    the device's busy share of the unprofiled frame loop's wall time (the
    main path's per-frame times for the same frames; setup is left out)."""
    from gsmpm_tpu_torch.apps.simulate import simulate

    cfg = bench_config(output_path=str(OUT_DIR / "profile"))
    stats = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        simulate(cfg, synthetic=MAIN_N, frames=PROFILE_FRAMES, quiet=True,
                 synthetic_res=MAIN_RES, device=str(dev), stats=stats)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type != torch.autograd.DeviceType.CPU]
    kernels.sort(key=_device_us, reverse=True)
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    check(busy_ms > 0, "profile: no device time recorded")
    loop_ms = 1e3 * (PROFILE_FRAMES * float(np.mean(main["sim_s"]))
                     + (PROFILE_FRAMES + 1) * float(np.mean(main["render_s"])))
    sim_ms = [round(1e3 * t, 1) for t in stats["sim_s"]]
    render_ms = [round(1e3 * t, 1) for t in stats["render_s"]]
    print(f"profile: simulate({PROFILE_FRAMES} frames) under torch.profiler: "
          f"wall {wall * 1e3:.1f} ms (sim {sim_ms} ms, render {render_ms} ms); "
          f"device busy {busy_ms:.1f} ms in {launches} kernel launches "
          f"({launches / (PROFILE_FRAMES * stats['substeps_per_frame']):.0f} "
          f"per substep); unprofiled frame loop {loop_ms:.1f} ms -> device "
          f"busy {100 * busy_ms / loop_ms:.1f}%", flush=True)
    for e in kernels[:PROFILE_TOP]:
        us = _device_us(e)
        print(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
              f"x{e.count:<6d} {e.key[:80]}", flush=True)
    return dict(busy_ms=busy_ms, launches=launches, loop_ms=loop_ms,
                profiled_wall_ms=wall * 1e3)

def _graph_pool_bytes(graph) -> int:
    """Bytes of a CUDA graph's private memory pool: its segments in the
    caching allocator's snapshot."""
    pool = graph.pool()
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg.get("segment_pool_id") == pool)


def _profiled_busy_ms(fn):
    """Device time (ms) of the kernels torch.profiler records while fn runs,
    and their count."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type != torch.autograd.DeviceType.CPU]
    return (sum(_device_us(e) for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def graph_phase(dev, wrappers):
    """Slice 9 on the main path's scene (196,730 particles, n_grid 50, the
    ground collider): tiles.frame_tiled replaying its captured substep
    against the eager substep_tiled loop (the same frame work: the
    substeps, then the original-order view), in turns from one state
    (eager, graph, eager, graph; GRAPH_FRAMES frames each, after one short
    graph frame that captures).  Per turn: substeps/s, K1 / K2 launches
    per frame, captures, replays and host reads per frame; the graph's
    pool bytes; each field's max abs and relative difference to the eager
    loop (SOLVER_RTOL of the field's max: K1's float atomics); the device
    busy share of one eager and one graph frame (torch.profiler, and the
    graph's back-to-back replay time from CUDA events); then one frame of
    the box pushed at ~PUSH_SPEED m/s, which rebuckets inside the frame
    without overflowing the cap, against the eager loop."""
    from gsmpm_tpu_torch.apps.simulate import prepare
    from gsmpm_tpu_torch.sim import tiles
    from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa

    su = prepare_main(dev)
    mpm = bench_config().mpm
    steps, dt = mpm.steps_per_frame, mpm.substep_dt
    f = tiles.frame_tiled

    def graph_counts():
        return dict(captures=f.captures, replays=f.replays,
                    host_reads=f.host_reads, rebuckets=f.rebuckets)

    def eager(ts, soa, model, bcs, n_frames):
        t = 0.0
        for _ in range(n_frames):
            for _ in range(steps):
                ts = tiles.substep_tiled(ts, model, bcs, t, su.grid, su.tc,
                                         dt)
                t = tiles._advance(t, dt)
            q = tiles.to_original_order(ts, su.tc.n_particles)
            soa = tiles.unpack_q(q, soa)
        return ts, soa, t

    def graph(ts, soa, model, bcs, n_frames, n=steps):
        t = 0.0
        for _ in range(n_frames):
            ts, soa, t = tiles.frame_tiled(ts, soa, model, bcs, t, n,
                                           su.grid, su.tc, dt)
        return ts, soa, t

    def timed(run, *args):
        torch.cuda.synchronize()
        _zero(wrappers)
        g0 = graph_counts()
        t0 = time.perf_counter()
        out = run(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts(wrappers)
        g = {k: v - g0[k] for k, v in graph_counts().items()}
        return out, secs, counts, g

    soa0 = soa_from_state(su.state)
    ts0 = tiles.bootstrap(soa0, su.model, su.grid, su.tc)
    args = (ts0, soa0, su.model, su.bcs, GRAPH_FRAMES)
    # the capture: one short frame (its first substep is the warm-up)
    _, capture_s, _, g = timed(graph, ts0, soa0, su.model, su.bcs, 1, 2)
    check(g["captures"] == 1 and g["replays"] == 1,
          f"graph: capture frame {g}")
    entry = next(reversed(tiles._GRAPHS.values()))
    pool_bytes = _graph_pool_bytes(entry.substep.graph)
    turns, results, total = [], {}, {}
    for name in ("eager", "graph", "eager", "graph"):
        (ts, soa, t), secs, counts, g = timed(
            eager if name == "eager" else graph, *args)
        want_k = GRAPH_FRAMES * steps
        check(counts["p2g_tiled"] == counts["g2p_tiled"] == want_k,
              f"graph phase {name}: launches {counts}, expected {want_k}")
        if name == "graph":
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            check(g["captures"] == 0 and g["replays"] == want_k
                  and g["host_reads"] == want_k,
                  f"graph phase: replays {g}, expected {want_k}")
            check(entry.clock.cpu().numpy().view(np.uint32)
                  == np.float32(t).view(np.uint32),
                  f"graph: device clock {float(entry.clock)} vs host {t}")
        else:
            check(g == dict(captures=0, replays=0, host_reads=0,
                            rebuckets=0), f"graph phase eager: {g}")
        turns.append(dict(run=name, substeps_per_s=want_k / secs, secs=secs,
                          k1=counts["p2g_tiled"], k2=counts["g2p_tiled"],
                          **g))
        results.setdefault(name, (ts, soa, t))
    (ts_e, soa_e, t_e), (ts_g, soa_g, t_g) = results["eager"], \
        results["graph"]
    check(t_e == t_g and bool(ts_g.ok), f"graph: clocks {t_e} vs {t_g}")
    st_g, st_e = state_from_soa(soa_g), state_from_soa(soa_e)
    rel = _rel_errs(st_g, st_e)
    abs_err = {k: float((getattr(st_g, k) - getattr(st_e, k)).abs().max())
               for k in rel}
    check(max(rel.values()) <= SOLVER_RTOL,
          f"graph vs eager: {rel} (tol {SOLVER_RTOL})")

    # busy shares: one frame of each under torch.profiler, beside the
    # turns' unprofiled frame times; the graph's replays back to back
    eager_busy, eager_n = _profiled_busy_ms(
        lambda: eager(ts0, soa0, su.model, su.bcs, 1))
    graph_busy, graph_n = _profiled_busy_ms(
        lambda: graph(ts0, soa0, su.model, su.bcs, 1))
    frame_ms = {n: 1e3 * float(np.mean([x["secs"] for x in turns
                                        if x["run"] == n])) / GRAPH_FRAMES
                for n in ("eager", "graph")}
    entry.load(ts0, 0.0)
    replay_ms = cuda_ms(entry.substep.graph.replay, reps=steps)
    sps = {n: [round(x["substeps_per_s"], 2) for x in turns if x["run"] == n]
           for n in ("eager", "graph")}

    # the pushed box: rebuckets inside its first frame, within the cap
    pcfg = pushed_config(dev, str(OUT_DIR / "graph_pushed"))[0]
    psu = prepare(pcfg, synthetic=MAIN_N, synthetic_res=MAIN_RES,
                  device=str(dev), quiet=True)
    check(len(psu.bcs.particle_ops) == 1, "graph: the push is missing")
    psoa = soa_from_state(psu.state)
    pts0 = tiles.bootstrap(psoa, psu.model, psu.grid, psu.tc)
    (pts_e, psoa_e, _), push_eager_s, _, _ = timed(
        eager, pts0, psoa, psu.model, psu.bcs, 1)
    (pts_g, psoa_g, _), push_graph_s, push_counts, pg = timed(
        graph, pts0, psoa, psu.model, psu.bcs, 1)
    push_rel = _rel_errs(state_from_soa(psoa_g), state_from_soa(psoa_e))
    check(pg["rebuckets"] >= 1 and pg["captures"] == 1 and bool(pts_g.ok)
          and bool(pts_e.ok), f"graph pushed frame: {pg}, ok {pts_g.ok}")
    check(push_counts["p2g_tiled"] == push_counts["g2p_tiled"] == steps,
          f"graph pushed frame: launches {push_counts}")
    check(max(push_rel.values()) <= SOLVER_RTOL,
          f"graph pushed frame vs eager: {push_rel} (tol {SOLVER_RTOL})")

    def listed(e):
        return ", ".join(f"{k} {v:.3g}" for k, v in e.items())

    busy = {"eager": 100 * eager_busy / frame_ms["eager"],
            "graph": 100 * graph_busy / frame_ms["graph"]}
    replay_share = 100 * steps * replay_ms / frame_ms["graph"]
    print(f"graph phase: {su.tc.n_particles} particles, n_grid "
          f"{mpm.n_grid}, turns of {GRAPH_FRAMES} frames x {steps} "
          f"substeps: eager {sps['eager']} substeps/s, graph "
          f"{sps['graph']}; capture frame (2 substeps) {capture_s:.3f} s, "
          f"pool {pool_bytes} bytes; per graph frame {steps} host reads, "
          f"{steps} replays, K1/K2 {steps}/{steps}; graph vs eager: abs "
          f"{listed(abs_err)}, rel {listed(rel)} (tol {SOLVER_RTOL})",
          flush=True)
    print(f"graph phase: device busy (torch.profiler, one frame) eager "
          f"{eager_busy:.1f} ms in {eager_n} kernels = {busy['eager']:.1f}% "
          f"of {frame_ms['eager']:.1f} ms, graph {graph_busy:.1f} ms in "
          f"{graph_n} kernels = {busy['graph']:.1f}% of "
          f"{frame_ms['graph']:.1f} ms; graph replay back to back "
          f"{replay_ms:.4f} ms a substep (CUDA events) = {replay_share:.1f}% "
          f"of the graph frame", flush=True)
    print(f"graph phase: pushed box, 1 frame: {pg['rebuckets']} rebucket(s), "
          f"{pg['captures']} capture, eager {push_eager_s:.3f} s, graph "
          f"{push_graph_s:.3f} s; vs eager rel {listed(push_rel)}", flush=True)
    return total, dict(
        turns=turns, substeps_per_s=sps, capture_frame_s=capture_s,
        pool_bytes=pool_bytes, frame_ms=frame_ms,
        host_reads_per_frame=steps, abs_err=abs_err, rel_err=rel,
        busy_ms=dict(eager=eager_busy, graph=graph_busy),
        busy_kernels=dict(eager=eager_n, graph=graph_n), busy_pct=busy,
        replay_ms=replay_ms, replay_share_pct=replay_share,
        pushed=dict(rebuckets=pg["rebuckets"], eager_s=push_eager_s,
                    graph_s=push_graph_s, rel_err=push_rel))


# ---------------------------------------------------------------------------
# the identification path (slice 2)
# ---------------------------------------------------------------------------

def identify_args(dev, output_path: str, **over):
    """apps.identify's arguments for the bench fit configuration."""
    from gsmpm_tpu_torch.apps.identify import build_parser

    a = dict(synthetic=MAIN_N, resolution=FIT_RES, iters=1,
             frames=FIT_FRAMES, E_init=FIT_E_INIT, E_true=FIT_E_TRUE,
             output_path=output_path, device=str(dev))
    a.update(over)
    return build_parser().parse_args([f"--{k}={v}" for k, v in a.items()])


def identify_path(dev, wrappers):
    """apps.identify end to end at the bench configuration, every launch
    counter set to 0 just before and read just after."""
    from gsmpm_tpu_torch.apps.identify import identify

    args = identify_args(dev, str(OUT_DIR / "identify"))
    stats = {}
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    ident = identify(args, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in wrappers}
    fits = [r for r in stats["frames"] if r["frame"] > 0]
    check(len(fits) == FIT_FRAMES - 1, f"fit frames {fits}")
    check(all(np.isfinite(r["loss"]) for r in stats["frames"]),
          f"losses {stats['frames']}")
    check(ident.n_dropped_last == 0 and all(r["n_dropped"] == 0
                                            for r in fits),
          f"n_dropped {[r['n_dropped'] for r in fits]}")
    check(ident.sim_engine == "tiled_vjp", f"engine {ident.sim_engine}")
    E = ident.optimized_E
    check(np.isfinite(E) and abs(E / FIT_E_INIT - 1.0) > 1e-6,
          f"E did not move from {FIT_E_INIT} ({E})")
    for name in ("p2g_tiled", "g2p_tiled", "sored_tiled", "blend_fwd",
                 "blend_bwd"):
        check(counts[name] > 0, f"identify path: {name} never launched")
    for name in ("stream_blend", "stream_blend_bwd", "blend_packed_fwd",
                 "blend_packed_bwd"):
        check(counts[name] == 0, f"identify path ran {name}")
    # at least the launches of the fit frames themselves (re-runs after a
    # cap resize add forward launches)
    for name, k in PER_SUBSTEP.items():
        need = (FIT_FRAMES - 1) * FIT_SUBSTEPS * k
        check(counts[name] >= need, f"{name}: {counts[name]} < {need}")
    rc = ident.raster_cfg
    print(f"identify path: {MAIN_N} gaussians, n_grid 50, {FIT_RES}^2, "
          f"{FIT_FRAMES} frames x {FIT_SUBSTEPS} substeps: frame seconds "
          f"{[round(r['s'], 3) for r in stats['frames']]}, losses "
          f"{[round(r['loss'], 6) for r in stats['frames']]}, E "
          f"{FIT_E_INIT:g} -> {E:.6g}, nu {ident.optimized_nu:.5f}, caps "
          f"k_tile {rc.k_tile} k_dense {rc.k_dense} n_dense {rc.n_dense}, "
          f"cap rebuilds {ident._total_rebuilds}, wall {wall:.1f} s, "
          f"launches {counts}", flush=True)
    return ident, counts, dict(
        frame_s=[r["s"] for r in stats["frames"]],
        losses=[r["loss"] for r in stats["frames"]], E=E,
        nu=ident.optimized_nu, k_dense=rc.k_dense, n_dense=rc.n_dense,
        cap_rebuilds=ident._total_rebuilds, wall_s=wall)


def steady_fit(dev, ident, wrappers):
    """Fit frames after the caps settled: ground truth regenerated for the
    refined scene, then STEADY_FRAMES fit frames from the reset state, each
    timed (host clock, ended by a synchronize) with its launches asserted
    exactly.  Returns the numbers, the state the first frame rendered, its
    camera and target."""
    from gsmpm_tpu_torch.apps.identify import make_ring_cameras

    cams = make_ring_cameras(ident.scene, FIT_RES)
    g0 = _golden_graph_counts()
    gt = ident.generate_ground_truth(FIT_E_TRUE, 0.3, cams, FIT_FRAMES)
    # the ground truth's frames replay the golden graph of its model
    # (slice 12): one capture, every pass (a resize regenerates) whole
    g = _golden_graph_delta(g0)
    per_pass = (FIT_FRAMES - 1) * FIT_SUBSTEPS
    check(g["captures"] == 1 and g["replays"] > 0
          and (g["captures"] + g["replays"]) % per_pass == 0,
          f"ground truth: golden graph counters {g}")
    rebuilds = ident._total_rebuilds
    state, t = ident.reset_state(), 0.0
    times, per_frame, first = [], [], None
    for k in range(STEADY_FRAMES):
        fid = 1 + k % (FIT_FRAMES - 1)
        if fid == 1:
            state, t = ident.reset_state(), 0.0
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, state2, t2, _ = ident.fit_frame(state, t, cams[fid], gt[fid])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_frame.append({w.__name__: w.launches for w in wrappers})
        check(np.isfinite(float(loss)), f"steady loss {float(loss)}")
        if first is None:
            first = (state2, cams[fid], gt[fid], float(loss))
        state, t = state2, t2
    check(ident._total_rebuilds == rebuilds, "caps resized in steady state")
    check(ident.sim_engine == "tiled_vjp", f"engine {ident.sim_engine}")
    tiers = 2 if ident.raster_cfg.k_dense > 0 else 1
    stream = int(ident.raster_cfg.stream)
    want = {k: v * FIT_SUBSTEPS for k, v in PER_SUBSTEP.items()}
    want.update(blend_fwd=(1 - stream) * tiers, blend_bwd=(1 - stream) * tiers,
                stream_blend=stream, stream_blend_bwd=stream,
                blend_packed_fwd=0, blend_packed_bwd=0)
    for got in per_frame:
        check(got == want, f"launches per fit frame {got}, expected {want}")
    print(f"steady fit: {STEADY_FRAMES} frames {[round(x, 4) for x in times]}"
          f" s (mean {np.mean(times):.4f} s), launches per frame {want}; "
          f"ground truth golden graph {g}", flush=True)
    return (dict(frame_s=times, launches_per_frame=want,
                 ground_truth_graph=g), first, gt, cams)


def fit_profile(dev, ident, first, steady):
    """One fit frame under torch.profiler: device time by kernel and the
    device's busy share of the unprofiled steady frame time."""
    state, cam, gt, _ = first
    ident_state = ident.reset_state()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ident.fit_frame(ident_state, 0.0, cam, gt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type != torch.autograd.DeviceType.CPU]
    kernels.sort(key=_device_us, reverse=True)
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    check(busy_ms > 0, "fit profile: no device time recorded")
    frame_ms = 1e3 * float(np.mean(steady["frame_s"]))
    print(f"fit profile: one fit frame under torch.profiler: wall "
          f"{wall * 1e3:.1f} ms; device busy {busy_ms:.1f} ms in {launches} "
          f"kernel launches ({launches / FIT_SUBSTEPS:.0f} per substep); "
          f"unprofiled fit frame {frame_ms:.1f} ms -> device busy "
          f"{100 * busy_ms / frame_ms:.1f}%", flush=True)
    top = []
    # the largest entries, then the port's own kernels further down
    ours = ("p2g_kernel", "g2p_kernel", "sored_kernel", "blend_fwd_kernel",
            "blend_bwd_kernel", "stream_fwd_kernel", "stream_bwd_kernel")
    for i, e in enumerate(kernels):
        if i >= PROFILE_TOP and not any(k in e.key for k in ours):
            continue
        us = _device_us(e)
        top.append((e.key[:80], us / 1e3, e.count))
        print(f"  {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
              f"x{e.count:<6d} {e.key[:80]}", flush=True)
    return dict(busy_ms=busy_ms, launches=launches, frame_ms=frame_ms,
                profiled_wall_ms=wall * 1e3, top=top)


# slice 10's fit_graph phase: frames per turn, and the gradient of a graph
# frame against the eager frame's from one state, relative to the eager
# gradient's largest magnitude (K1's float atomics, forward and recompute:
# the CUDA tests' 1e-3)
FIT_GRAPH_FRAMES = 2
FIT_GRAPH_GRAD_REL = 1e-3
# the four ranges of a fit frame that the phase split times
FIT_RANGES = ("window forward", "render+loss forward",
              "render+loss backward", "window backward")


def _fit_frame_parts(ident, state, cam, gt, graph: bool):
    """One fit frame as SystemIdentifier.fit_frame computes it (without
    the SGD step), in four torch.profiler.record_function ranges: the
    window forward (on CUDA the graphs, or the checkpointed
    substep_tiled_fitting loop), the render and loss forward, their
    backward to the window's rows, the window's backward to (logE, y).
    Returns (loss, g_logE, g_y, n_dropped)."""
    from torch.profiler import record_function

    from gsmpm_tpu_torch.ops.losses import photometric_loss
    from gsmpm_tpu_torch.render.renderer import render_with_aux
    from gsmpm_tpu_torch.sim import tiles
    from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa
    from gsmpm_tpu_torch.sim.state import mu_lam_from_logE_y

    fcfg = ident.fit_cfg
    n_sub = fcfg.substeps_per_frame
    dt = fcfg.frame_dt / n_sub
    logE = ident.model.logE.detach().requires_grad_(True)
    y = ident.model.y.detach().requires_grad_(True)
    with torch.enable_grad():
        with record_function(FIT_RANGES[0]):
            mu, lam = mu_lam_from_logE_y(logE, y)
            model = dataclasses.replace(ident.model, logE=logE, y=y, mu=mu,
                                        lam=lam)
            soa = soa_from_state(state)
            if graph:
                soa2, _, ok = tiles.run_substeps_tiled_fitting(
                    soa, model, ident.bcs, 0.0, n_sub, ident.grid, dt)
            else:
                n = state.x.shape[0]
                tc = tiles.default_tile_config(ident.grid.n_grid, n)
                ts = tiles.bootstrap(soa, model, ident.grid, tc)
                for _ in range(n_sub):
                    ts = tiles.substep_tiled_fitting(
                        ts, model, ident.bcs, 0.0, ident.grid, tc, dt)
                soa2, ok = tiles.unpack_q(tiles.to_original_order(ts, n),
                                          soa), ts.ok
            state2 = state_from_soa(soa2)
        with record_function(FIT_RANGES[1]):
            xyz_w, cov_w = ident._world_geometry(state2)
            opacity, features = ident._appearance()
            img, nd = render_with_aux(xyz_w, cov_w, opacity, features, cam,
                                      ident.bg, ident.scene.sh_degree,
                                      ident.raster_cfg)
            loss = photometric_loss(img, gt)
    with record_function(FIT_RANGES[2]):
        d_state = torch.autograd.grad(loss, (state2.x, state2.F))
    with record_function(FIT_RANGES[3]):
        g_logE, g_y = torch.autograd.grad((state2.x, state2.F), (logE, y),
                                          d_state)
    check(bool(ok), "fit_graph: tile-cap overflow")
    return loss.detach(), g_logE, g_y, int(nd)


def _range_split(prof):
    """Per record_function range of FIT_RANGES: host ms (the range's
    span), kernel launch calls and graph launch calls made in it (the CUDA
    runtime events inside its span), as torch.profiler recorded them."""
    events = list(prof.events())
    out = {}
    for name in FIT_RANGES:
        spans = [e.time_range for e in events if e.name == name
                 and e.device_type == torch.autograd.DeviceType.CPU]
        check(len(spans) >= 1, f"fit_graph: no range {name!r}")
        lo, hi = spans[0].start, spans[0].end
        inside = [e for e in events if lo <= e.time_range.start <= hi]
        out[name] = dict(
            host_ms=(hi - lo) / 1e3,
            launches=sum("LaunchKernel" in e.name for e in inside),
            graph_launches=sum("GraphLaunch" in e.name for e in inside))
    return out


def fit_graph_phase(dev, ident, gt, cams, wrappers):
    """Slice 10 at the bench fit (245,760 gaussians, 512^2, 30 substeps,
    the caps settled): fit frames whose window runs the two CUDA graphs of
    tiles._FittingWindow against frames whose window runs the checkpointed
    substep_tiled_fitting loop, from one state (identify's reset state,
    frame 1's camera and target) and one (logE, y), in turns (eager,
    graph, eager, graph; FIT_GRAPH_FRAMES frames each).  Per turn: frame
    seconds, exact K1 / K2 / K6 launches a frame (90 / 150 / 60), the
    graphs' captures, replays and host reads, peak device memory.  Then
    both graphs' pool bytes; g_logE / g_y of a graph frame against an
    eager frame's (FIT_GRAPH_GRAD_REL); one profiled frame of each
    (device busy share of the turns' mean frame, and the launches and
    host ms of the four ranges of _fit_frame_parts)."""
    from gsmpm_tpu_torch.sim import cuda_mpm, tiles

    f = tiles.run_substeps_tiled_fitting
    state, cam, target = ident.reset_state(), cams[1], gt[1]
    window = {w: FIT_SUBSTEPS * k for w, k in PER_SUBSTEP.items()}

    def graph_counts():
        return dict(captures=f.captures, replays=f.replays,
                    host_reads=f.host_reads, rebuckets=f.rebuckets)

    def frame(graph):
        torch.cuda.synchronize()
        _zero(wrappers)
        g0 = graph_counts()
        t0 = time.perf_counter()
        loss, g_logE, g_y, nd = _fit_frame_parts(ident, state, cam, target,
                                                 graph)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts(wrappers)
        g = {k: v - g0[k] for k, v in graph_counts().items()}
        check(nd == 0, f"fit_graph: n_dropped {nd}")
        check(np.isfinite(float(loss)), f"fit_graph: loss {float(loss)}")
        got = {w: counts[w] for w in window}
        check(got == window, f"fit_graph {'graph' if graph else 'eager'}: "
              f"launches {got}, expected {window}")
        if graph:
            check(g["captures"] == 0 and g["replays"] == 2 * FIT_SUBSTEPS
                  and g["host_reads"] == FIT_SUBSTEPS,
                  f"fit_graph: graph frame {g}")
        else:
            check(g == dict(captures=0, replays=0, host_reads=0,
                            rebuckets=0), f"fit_graph eager frame: {g}")
        return secs, counts, g, (float(loss), g_logE, g_y)

    captures0 = f.captures
    # the identify path and steady_fit captured the graphs of this key
    frame(True)
    check(f.captures == captures0, "fit_graph: the graphs were re-captured")
    entry = next(reversed(tiles._FIT_GRAPHS.values()))
    pools = dict(forward=_graph_pool_bytes(entry.forward.graph),
                 adjoint=_graph_pool_bytes(entry.adjoint.graph))
    turns, results, total = [], {}, {}
    for name in ("eager", "graph", "eager", "graph"):
        torch.cuda.reset_peak_memory_stats()
        for _ in range(FIT_GRAPH_FRAMES):
            secs, counts, g, res = frame(name == "graph")
            if name == "graph":
                total = {k: total.get(k, 0) + v for k, v in counts.items()}
            turns.append(dict(run=name, secs=secs, **g))
            results.setdefault(name, res)
        turns[-1]["peak_bytes"] = torch.cuda.max_memory_allocated()
    (loss_e, ge_logE, ge_y), (loss_g, gg_logE, gg_y) = (
        results["eager"], results["graph"])
    diffs = {}
    for key, a, b in (("g_logE", gg_logE, ge_logE), ("g_y", gg_y, ge_y)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        diffs[key] = dict(max_abs=err, scale=scale, rel=err / scale)
        check(scale > 0 and err <= FIT_GRAPH_GRAD_REL * scale,
              f"fit_graph: {key} graph vs eager {err} (scale {scale}, rel "
              f"tol {FIT_GRAPH_GRAD_REL})")
    frame_s = {n: [x["secs"] for x in turns if x["run"] == n]
               for n in ("eager", "graph")}
    peak = {n: [x["peak_bytes"] for x in turns
                if x["run"] == n and "peak_bytes" in x]
            for n in ("eager", "graph")}

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof_out = {}
    for name in ("eager", "graph"):
        with torch.profiler.profile(activities=acts) as prof:
            _fit_frame_parts(ident, state, cam, target, name == "graph")
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if _device_us(e) > 0
                   and e.device_type != torch.autograd.DeviceType.CPU]
        busy_ms = sum(_device_us(e) for e in kernels) / 1e3
        n_kernels = sum(e.count for e in kernels)
        check(busy_ms > 0, f"fit_graph {name} profile: no device time")
        mean_ms = 1e3 * float(np.mean(frame_s[name]))
        prof_out[name] = dict(busy_ms=busy_ms, kernels=n_kernels,
                              busy_pct=100 * busy_ms / mean_ms,
                              split=_range_split(prof))
    # the graphs' replays back to back (CUDA events): their device time
    fwd_ms = cuda_ms(entry.forward.graph.replay, reps=FIT_SUBSTEPS)
    adj_ms = cuda_ms(entry.adjoint.graph.replay, reps=FIT_SUBSTEPS)

    def split_line(sp):
        return "; ".join(f"{k} {v['host_ms']:.1f} ms host, {v['launches']} "
                         f"launches + {v['graph_launches']} graph launches"
                         for k, v in sp.items())

    print(f"fit_graph phase: {MAIN_N} gaussians, {FIT_RES}^2, "
          f"{FIT_SUBSTEPS} substeps, turns of {FIT_GRAPH_FRAMES} frames: "
          f"eager {[round(x, 4) for x in frame_s['eager']]} s, graph "
          f"{[round(x, 4) for x in frame_s['graph']]} s; per graph frame "
          f"{FIT_SUBSTEPS} host reads, {2 * FIT_SUBSTEPS} replays, 0 "
          f"captures (the run's captures so far {f.captures}), K1/K2/K6 "
          f"{window['p2g_tiled']}/{window['g2p_tiled']}/"
          f"{window['sored_tiled']} in both; pools forward "
          f"{pools['forward']} bytes, adjoint {pools['adjoint']} bytes; "
          f"peak memory eager {peak['eager']} graph {peak['graph']} bytes",
          flush=True)
    print(f"fit_graph phase: graph vs eager loss {loss_g:.7g} / "
          f"{loss_e:.7g}, g_logE max abs {diffs['g_logE']['max_abs']:.3g} "
          f"(rel {diffs['g_logE']['rel']:.3g}), g_y max abs "
          f"{diffs['g_y']['max_abs']:.3g} (rel {diffs['g_y']['rel']:.3g}); "
          f"tol rel {FIT_GRAPH_GRAD_REL}", flush=True)
    for name in ("eager", "graph"):
        p = prof_out[name]
        print(f"fit_graph phase: {name} frame profiled: device busy "
              f"{p['busy_ms']:.1f} ms in {p['kernels']} kernels = "
              f"{p['busy_pct']:.1f}% of the turns' mean "
              f"{1e3 * np.mean(frame_s[name]):.1f} ms; "
              f"{split_line(p['split'])}", flush=True)
    print(f"fit_graph phase: replays back to back (CUDA events): forward "
          f"{fwd_ms:.4f} ms, adjoint {adj_ms:.4f} ms a substep", flush=True)
    check(total["p2g_tiled"] > 0 and total["sored_tiled"] > 0,
          "fit_graph: no launch")
    return total, dict(
        turns=turns, frame_s=frame_s, pool_bytes=pools, peak_bytes=peak,
        grad_diff=diffs, loss=dict(eager=loss_e, graph=loss_g),
        profile=prof_out, replay_ms=dict(forward=fwd_ms, adjoint=adj_ms),
        captures_so_far=f.captures)


# slice 12's golden_graph phase: frames per turn (of 100 substeps), the
# substeps profiled of each loop (a golden substep is ~5,200 kernels: on
# an H100 a profiled 100-substep graph frame recorded 525,610 kernel
# events and took most of the phase's 86.8 s), each field of a graph
# frame against the eager frame from one state relative to the field's
# largest magnitude, at least 1 (cov: its own, ~1e-4; index_add_'s float
# atomics over 100 substeps: the falling box's C, the velocity's stencil
# moments, is ~1e-6 of noise around 0), and the golden fit's gradients
# of a graph frame against the checkpointed loop's (FIT_GRAPH_GRAD_REL)
GOLDEN_GRAPH_FRAMES = 1
GOLDEN_PROFILE_STEPS = 10
GOLDEN_GRAPH_RTOL = 1e-4


def golden_graph_phase(dev, wrappers):
    """Slice 12 on simulate's scene with incremental_cov (196,730
    particles, n_grid 50, the ground collider; the golden engine for every
    frame): sim/solver.run_substeps replaying its captured golden substep
    against chip_smoke's own eager loop over kernels.substep_soa, in turns
    from one state (eager, graph, eager, graph; GOLDEN_GRAPH_FRAMES frames
    of 100 substeps each, after a 2-substep frame that captures).  Per
    turn substeps/s, captures and replays, no kernel launch of K1-K9 (the
    golden engine is plain torch); the graph's pool bytes; each field's
    relative difference (GOLDEN_GRAPH_RTOL); the device clock's bits; the
    launches a substep and busy share of GOLDEN_PROFILE_STEPS eager
    substeps and of a graph frame of as many substeps under
    torch.profiler; the replays back to back (CUDA events)."""
    from gsmpm_tpu_torch.apps.simulate import prepare
    from gsmpm_tpu_torch.sim import solver, tiles
    from gsmpm_tpu_torch.sim.kernels import (
        soa_from_state, state_from_soa, substep_soa,
    )

    cfg = bench_config()
    cfg.mpm.incremental_cov = True
    su = prepare(cfg, synthetic=MAIN_N, synthetic_res=MAIN_RES,
                 device=str(dev), quiet=True)
    steps, dt = cfg.mpm.steps_per_frame, cfg.mpm.substep_dt

    def eager(n=steps):
        with torch.no_grad():
            soa, t = soa_from_state(su.state), 0.0
            for _ in range(n):
                soa = substep_soa(soa, su.model, su.bcs, t, su.grid, dt,
                                  incremental_cov=True)
                t = tiles._advance(t, dt)
            return state_from_soa(soa), t

    def graph(n=steps):
        with torch.no_grad():
            return solver.run_substeps(su.state, su.model, su.bcs, 0.0, n,
                                       su.grid, dt, incremental_cov=True,
                                       checkpoint_policy=None)

    def timed(run, *args):
        torch.cuda.synchronize()
        _zero(wrappers)
        g0 = _golden_graph_counts()
        t0 = time.perf_counter()
        out = run(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return out, secs, _counts(wrappers), _golden_graph_delta(g0)

    _, capture_s, counts, g = timed(graph, 2)
    check(g == dict(captures=1, replays=1), f"golden_graph: capture {g}")
    entry = next(reversed(solver._GOLDEN_GRAPHS.values()))
    pool_bytes = _graph_pool_bytes(entry.substep.graph)
    turns, results, total = [], {}, {}
    want = GOLDEN_GRAPH_FRAMES * steps
    for name in ("eager", "graph", "eager", "graph"):
        (st, t), secs, counts, g = timed(
            eager if name == "eager" else graph, want)
        check(not any(counts.values()),
              f"golden_graph {name}: kernel launches {counts}")
        if name == "graph":
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            check(g == dict(captures=0, replays=want),
                  f"golden_graph: graph turn {g}")
            check(entry.clock.cpu().numpy().view(np.uint32)
                  == np.float32(t).view(np.uint32),
                  f"golden_graph: device clock {float(entry.clock)} vs "
                  f"host {t}")
        else:
            check(g == dict(captures=0, replays=0),
                  f"golden_graph: eager turn {g}")
        turns.append(dict(run=name, secs=secs, substeps_per_s=want / secs,
                          **g))
        results.setdefault(name, (st, t))
    (st_e, t_e), (st_g, t_g) = results["eager"], results["graph"]
    check(t_e == t_g, f"golden_graph: clocks {t_e} vs {t_g}")
    rel = _rel_errs(st_g, st_e)
    rel["cov"] = (float((st_g.cov - st_e.cov).abs().max())
                  / float(st_e.cov.abs().max()))
    abs_err = {f: float((getattr(st_g, f) - getattr(st_e, f)).abs().max())
               for f in rel}
    check(max(rel.values()) <= GOLDEN_GRAPH_RTOL,
          f"golden_graph vs eager: {rel} (tol {GOLDEN_GRAPH_RTOL})")
    moved = float((st_g.cov - su.state.cov).abs().max())
    check(moved > 0, "golden_graph: incremental_cov left cov")
    sps = {n: [x["substeps_per_s"] for x in turns if x["run"] == n]
           for n in ("eager", "graph")}
    frame_ms = {n: 1e3 * float(np.mean([x["secs"] for x in turns
                                        if x["run"] == n]))
                / GOLDEN_GRAPH_FRAMES for n in ("eager", "graph")}
    # the eager loop's launches and busy share, over a few substeps only
    eager_busy, eager_n = _profiled_busy_ms(
        lambda: eager(GOLDEN_PROFILE_STEPS))
    eager_ms = frame_ms["eager"] * GOLDEN_PROFILE_STEPS / steps
    graph_busy, graph_n = _profiled_busy_ms(
        lambda: graph(GOLDEN_PROFILE_STEPS))
    graph_ms = frame_ms["graph"] * GOLDEN_PROFILE_STEPS / steps
    busy = {"eager": 100 * eager_busy / eager_ms,
            "graph": 100 * graph_busy / graph_ms}
    entry.load(su.state, 0.0)
    replay_ms = cuda_ms(entry.substep.graph.replay, reps=steps)
    ratio = float(np.mean(sps["graph"]) / np.mean(sps["eager"]))
    print(f"golden_graph phase: {su.state.x.shape[0]} particles, n_grid "
          f"{cfg.mpm.n_grid}, incremental_cov, turns of "
          f"{GOLDEN_GRAPH_FRAMES} frame(s) x {steps} substeps: eager "
          f"{[round(x, 2) for x in sps['eager']]} substeps/s, graph "
          f"{[round(x, 2) for x in sps['graph']]} ({ratio:.1f}x); capture "
          f"frame (2 substeps) {capture_s:.3f} s, pool {pool_bytes} bytes; "
          f"per graph frame {want} replays, 0 captures, no K1-K9 launch; "
          f"graph vs eager abs "
          + ", ".join(f"{k} {v:.3g}" for k, v in abs_err.items())
          + ", rel " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
          + f" (tol {GOLDEN_GRAPH_RTOL}); device clock bits "
          f"{int(entry.clock.cpu().numpy().view(np.uint32))} = host "
          f"{t_g!r}", flush=True)
    print(f"golden_graph phase: device busy (torch.profiler) eager "
          f"{GOLDEN_PROFILE_STEPS} substeps {eager_busy:.1f} ms in {eager_n} "
          f"kernels ({eager_n / GOLDEN_PROFILE_STEPS:.0f} a substep) = "
          f"{busy['eager']:.1f}% of their unprofiled {eager_ms:.1f} ms; "
          f"graph frame of {GOLDEN_PROFILE_STEPS} substeps {graph_busy:.1f} "
          f"ms in {graph_n} kernels = {busy['graph']:.1f}% of their "
          f"unprofiled {graph_ms:.1f} ms; replay back "
          f"to back {replay_ms:.4f} ms a substep (CUDA events)", flush=True)
    return total, dict(
        turns=turns, substeps_per_s=sps, speedup=ratio,
        capture_frame_s=capture_s, pool_bytes=pool_bytes, frame_ms=frame_ms,
        rel_err=rel, abs_err=abs_err,
        busy_ms=dict(eager=eager_busy, graph=graph_busy),
        busy_kernels=dict(eager=eager_n, graph=graph_n), busy_pct=busy,
        eager_launches_per_substep=eager_n / GOLDEN_PROFILE_STEPS,
        replay_ms=replay_ms, particles=int(su.state.x.shape[0]))


def _eager_golden_substeps(engine, state, model, bcs, t, n_sub, grid, dt,
                           group=None):
    """sim/fitting.fit_substeps on golden as the checkpointed substep_soa
    loop: the golden fit's window as it ran before it replayed the graphs
    (chip_smoke puts it in sim/fitting.py's namespace for the eager
    turns)."""
    import torch.utils.checkpoint

    from gsmpm_tpu_torch.sim import tiles
    from gsmpm_tpu_torch.sim.kernels import (
        soa_from_state, state_from_soa, substep_soa,
    )

    check(engine == "golden", f"eager golden substeps: engine {engine}")
    soa = soa_from_state(state)
    for _ in range(n_sub):
        soa = torch.utils.checkpoint.checkpoint(
            substep_soa, soa, model, bcs, t, grid, dt, group=group,
            fitting=True, use_reentrant=False)
        t = tiles._advance(t, dt)
    return state_from_soa(soa), t, True


def golden_fit_graph_phase(dev, ident, gt, cams, wrappers):
    """Slice 12 at the bench fit (245,760 gaussians, 512^2, 30 substeps,
    the caps settled) with the fit forced onto the golden engine (the
    engine after a tile-cap overflow): SystemIdentifier.fit_frame whose
    window runs sim/solver.py's _GoldenFittingWindow (a forward and an
    adjoint CUDA graph) against fit_frame whose window runs the
    checkpointed substep_soa loop, from one state and (logE, y), in turns
    (eager, graph, eager, graph; one frame each, after a frame that
    captures).  Per turn: frame seconds, no K1 / K2 / K6 launch, the
    render's K4 / K5 once per tier, the golden graphs' captures and
    replays, peak device memory; both graphs' pool bytes; g_logE / g_y of
    a graph frame against an eager frame's (FIT_GRAPH_GRAD_REL).  ident's
    engine and parameters are restored."""
    from gsmpm_tpu_torch.sim import fitting, solver

    state, cam, target = ident.reset_state(), cams[1], gt[1]
    logE0, y0 = ident.model.logE.clone(), ident.model.y.clone()
    tiers = 2 if ident.raster_cfg.k_dense > 0 else 1
    real, engine0 = fitting.fit_substeps, ident._sim_engine

    def frame(graph):
        ident._set_params(logE0.clone(), y0.clone())
        if not graph:
            fitting.fit_substeps = _eager_golden_substeps
        try:
            torch.cuda.synchronize()
            _zero(wrappers)
            g0 = _golden_graph_counts()
            t0 = time.perf_counter()
            loss, _, _, _ = ident.fit_frame(state, 0.0, cam, target)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            fitting.fit_substeps = real
        counts, g = _counts(wrappers), _golden_graph_delta(g0)
        what = "graph" if graph else "eager"
        check(ident.sim_engine == "golden" and ident.n_dropped_last == 0,
              f"golden fit {what}: engine {ident.sim_engine}, dropped "
              f"{ident.n_dropped_last}")
        check(np.isfinite(float(loss)), f"golden fit {what}: loss {loss}")
        check(counts["p2g_tiled"] == counts["g2p_tiled"]
              == counts["sored_tiled"] == 0
              and counts["blend_fwd"] == counts["blend_bwd"] == tiers,
              f"golden fit {what}: launches {counts}")
        return secs, counts, g, (float(loss), *(x.detach().clone()
                                                for x in ident.last_grads))

    ident._sim_engine = "golden"
    try:
        capture_s, _, g, _ = frame(True)
        check(g["captures"] + g["replays"] == 2 * FIT_SUBSTEPS,
              f"golden fit: capture frame {g}")
        entry = next(reversed(solver._GOLDEN_FIT_GRAPHS.values()))
        pools = dict(forward=_graph_pool_bytes(entry.forward.graph),
                     adjoint=_graph_pool_bytes(entry.adjoint.graph))
        turns, results, total = [], {}, {}
        for name in ("eager", "graph", "eager", "graph"):
            torch.cuda.reset_peak_memory_stats()
            secs, counts, g, res = frame(name == "graph")
            if name == "graph":
                check(g == dict(captures=0, replays=2 * FIT_SUBSTEPS),
                      f"golden fit graph frame: {g}")
                total = {k: total.get(k, 0) + v for k, v in counts.items()}
            else:
                check(g == dict(captures=0, replays=0),
                      f"golden fit eager frame: {g}")
            turns.append(dict(run=name, secs=secs,
                              peak_bytes=torch.cuda.max_memory_allocated(),
                              **g))
            results.setdefault(name, res)
    finally:
        ident._sim_engine = engine0
        ident._set_params(logE0, y0)
    (loss_e, ge_logE, ge_y), (loss_g, gg_logE, gg_y) = (
        results["eager"], results["graph"])
    diffs = {}
    for key, a, b in (("g_logE", gg_logE, ge_logE), ("g_y", gg_y, ge_y)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        diffs[key] = dict(max_abs=err, scale=scale, rel=err / scale)
        check(scale > 0 and err <= FIT_GRAPH_GRAD_REL * scale,
              f"golden fit: {key} graph vs eager {err} (scale {scale}, rel "
              f"tol {FIT_GRAPH_GRAD_REL})")
    frame_s = {n: [x["secs"] for x in turns if x["run"] == n]
               for n in ("eager", "graph")}
    peak = {n: [x["peak_bytes"] for x in turns if x["run"] == n]
            for n in ("eager", "graph")}
    print(f"golden_graph phase (fit): {MAIN_N} gaussians, {FIT_RES}^2, "
          f"{FIT_SUBSTEPS} substeps on the golden engine, turns of one "
          f"frame: eager (checkpointed loop) "
          f"{[round(x, 4) for x in frame_s['eager']]} s, graph "
          f"{[round(x, 4) for x in frame_s['graph']]} s; capture frame "
          f"{capture_s:.3f} s; per graph frame {2 * FIT_SUBSTEPS} replays, "
          f"0 captures, K1/K2/K6 0, K4/K5 {tiers}/{tiers}; pools forward "
          f"{pools['forward']} bytes, adjoint {pools['adjoint']} bytes; "
          f"peak memory eager {peak['eager']} graph {peak['graph']} bytes; "
          f"graph vs eager loss {loss_g:.7g} / {loss_e:.7g}, g_logE rel "
          f"{diffs['g_logE']['rel']:.3g}, g_y rel {diffs['g_y']['rel']:.3g} "
          f"(tol {FIT_GRAPH_GRAD_REL})", flush=True)
    return total, dict(turns=turns, frame_s=frame_s, capture_frame_s=capture_s,
                       pool_bytes=pools, peak_bytes=peak, grad_diff=diffs,
                       loss=dict(eager=loss_e, graph=loss_g))


def _contrib_pairs_windows(F, out, meta) -> float:
    """(candidate, pixel) pairs of windows F (nblocks, 16, K) that pass the
    forward's gates (power <= log opacity, alpha >= alpha_min) at or before
    the pixel's last contributor (row 5 of the blend state ``out``)."""
    from gsmpm_tpu_torch.render import cuda_blend as cb

    mono = cb._monomials(meta.B, F.device)
    last = out[:, 5]
    n = torch.zeros((), dtype=torch.int64, device=F.device)
    for c0 in range(0, int(last.max()), meta.C):
        Fc = F[:, :, c0:c0 + meta.C]
        power = cb._power(Fc, mono)
        alpha = torch.clamp_max(torch.exp(power), 0.99)
        idx1 = torch.arange(c0 + 1, c0 + 1 + Fc.shape[2], device=F.device,
                            dtype=torch.float32)
        n += ((power <= Fc[:, 6, :, None]) & (alpha >= meta.alpha_min)
              & (idx1[None, :, None] <= last[:, None, :])).sum()
    return float(n)


def _contrib_pairs_stream(splanes, bounds, out, nbx, B, alpha_min) -> float:
    """(slot, pixel) pairs of the sorted stream that pass the forward's
    gates at or before the pixel's last contributor (row 5 of ``out``)."""
    from gsmpm_tpu_torch.render import stream_raster as sr

    dev, L = splanes.device, splanes.shape[1]
    C = sr._TWIN_CHUNK
    lo = bounds[:-1].to(torch.int64)
    hi = bounds[1:].to(torch.int64)
    bid = torch.arange(lo.shape[0], device=dev)
    x0 = ((bid % nbx) * B).to(torch.float32)
    y0 = ((bid // nbx) * B).to(torch.float32)
    pix = sr._pixel_coords(B, dev)
    last = out[:, 5]
    depth = int((last.amax(dim=1).to(torch.int64) - lo).clamp_min(0).max())
    ar = torch.arange(C, device=dev)
    n = torch.zeros((), dtype=torch.int64, device=dev)
    for j0 in range(0, depth, C):
        ids = lo[:, None] + j0 + ar
        p = splanes[:, ids.clamp(max=L - 1)]
        gate = sr._chunk_power(p, x0, y0, ids < hi[:, None], pix,
                               alpha_min)[5]
        n += (gate & ((ids + 1).to(torch.float32)[..., None]
                      <= last[:, None, :])).sum()
    return float(n)


def _fit_candidates(ident, state, cam):
    """The fit frame's windowed render inputs: (pre, tier-1 window
    (cand, counts, origins), tier-2 window (cand, counts, origins))."""
    from gsmpm_tpu_torch.render import renderer as rr

    cfg = ident.raster_cfg
    xyz, cov = ident._world_geometry(state)
    opacity, features = ident._appearance()
    pre = rr.preprocess(xyz, cov, opacity, features, cam,
                        ident.scene.sh_degree, cfg)
    gidx, counts, origins, _, itl = rr._select_candidates_dupsort_v2(
        pre, cam, cfg, return_internals=True)
    tier1 = (rr._gather_candidates(pre, gidx, counts), counts, origins)
    dtiles, gidx_d, counts_d, dropped = rr._dense_selection(
        itl, pre.pix_x.shape[0], cfg)
    check(int(dropped) == 0, f"fit render dropped {int(dropped)}")
    tier2 = (rr._gather_candidates(pre, gidx_d, counts_d), counts_d,
             origins[dtiles])
    return tier1, tier2


def blend_phases(dev, ident, first):
    """K4 and K5 against their twins on the fit frame's real candidates,
    tier 1 (K = k_tile + k_coarse + k_global) and tier 2 (K = k_dense +
    k_coarse + k_global), with a seeded image cotangent for K5."""
    from gsmpm_tpu_torch.render import cuda_blend as cb

    state, cam, _, _ = first
    cfg = ident.raster_cfg
    rng = np.random.default_rng(1)
    tiers = {}
    for tier, (cand, counts, origins) in zip(
            ("tier1", "tier2"), _fit_candidates(ident, state, cam)):
        F, counts, meta = cb.blend_inputs(cand, counts, origins, cfg)
        nb, K, P = F.shape[0], F.shape[2], meta.P
        out_k = cb.blend_fwd(counts, F, meta)
        out_r = cb.blend_core_ref(counts, F, meta)
        torch.cuda.synchronize()
        err4 = float((out_k[:, 0:4] - out_r[:, 0:4]).abs().max())
        done_diff = float((out_k[:, 4] != out_r[:, 4]).float().mean())
        last_diff = float((out_k[:, 5] != out_r[:, 5]).float().mean())
        g = torch.zeros_like(out_k)
        g[:, 0:4] = torch.from_numpy(rng.normal(size=(nb, 4, P)).astype(
            np.float32)).to(dev)
        dF_k = cb.blend_bwd(F, out_k, g, meta)
        dF_r = cb.blend_core_bwd_ref(F, out_k, g, meta)
        # the sums run in a fixed order: a second launch gives the bits
        bits5 = torch.equal(dF_k, cb.blend_bwd(F, out_k, g, meta))
        torch.cuda.synchronize()
        rel5 = {}
        for gname, rows in (("quad", slice(0, 6)), ("logo", slice(6, 7)),
                            ("rgb", slice(8, 11))):
            scale = float(dF_r[:, rows].abs().max())
            rel5[gname] = float((dF_k[:, rows] - dF_r[:, rows]).abs().max()
                                ) / max(scale, 1e-30)
        pad_rows = float(dF_k[:, 11:].abs().max()) + float(
            dF_k[:, 7].abs().max())
        # sequential vs chunked transmittance products round differently
        # and may flip a pixel's stop decision at t_min (2e-3 abs is the
        # JAX package's own pallas-vs-XLA tolerance); K5 recovers T by
        # division in another order: 1e-4 of each row group's largest entry
        check(err4 <= 2e-3, f"K4 {tier}: max err {err4}")
        check(done_diff <= 1e-4, f"K4 {tier}: done flags differ {done_diff}")
        check(last_diff <= 1e-4, f"K4 {tier}: last index differs {last_diff}")
        check(max(rel5.values()) <= 1e-4, f"K5 {tier}: rel err {rel5}")
        check(pad_rows == 0.0, f"K5 {tier}: unused dF rows {pad_rows}")
        check(bits5, f"K5 {tier}: two launches differ")
        # the culled walk's bits do not depend on the run
        bits4 = torch.equal(out_k, cb.blend_fwd(counts, F, meta))
        check(bits4, f"K4 {tier}: two launches differ")
        ms4 = cuda_ms(lambda: cb.blend_fwd(counts, F, meta), 20)
        cull4 = fwd_window_cull(F, counts, out_k, meta)
        pms4 = cuda_ms(lambda: cb.blend_core_ref(counts, F, meta), 1, 1)
        ms5 = cuda_ms(lambda: cb.blend_bwd(F, out_k, g, meta), 20)
        pms5 = cuda_ms(lambda: cb.blend_core_bwd_ref(F, out_k, g, meta), 1,
                       1)
        cull5 = window_cull(F, out_k, meta)
        # (candidate, pixel) pairs this data needs: forward, each pixel up
        # to its stop (its last contributor when done, else its block's
        # count); backward, each pixel back from its last contributor
        cnt = counts.to(torch.float64)[:, None]
        last = out_k[:, 5].to(torch.float64)
        pairs4 = float(torch.where(out_k[:, 4] > 0, last, cnt).sum())
        pairs5 = float(last.sum())
        contrib5 = _contrib_pairs_windows(F, out_k, meta)
        live_cols = float(counts.sum())
        # bytes: the 10 used F rows of the live candidates, the outputs
        # (K4) / the state and cotangent rows read (T, last, rgb, T) and dF
        # (K5); >= 20 fp32 operations per forward pair, the backward's as
        # GATE_OPS / BWD_CONTRIB_OPS say, the gate charged to the walked
        # pairs inside the box (the all-walked bound charges it to every
        # walked pair)
        # K4 bytes: the 10 used F rows of the candidates before each
        # window's depth and the outputs; operations: >= 20 per walked
        # pair whose pixel lies in the box (the all-walked bound: per
        # walked pair)
        bytes4 = cull4["read_cols"] * 10 * 4 + out_k.numel() * 4
        b4 = bound_ms(bytes4, cull4["kept_pairs"] * 20.0)
        b4_all = bound_ms(bytes4, pairs4 * 20.0)
        bytes5 = live_cols * (10 + 16) * 4 + nb * 6 * P * 4
        b5 = bound_ms(bytes5, cull5["kept_pairs"] * GATE_OPS
                      + contrib5 * BWD_CONTRIB_OPS)
        b5_all = bound_ms(bytes5, pairs5 * GATE_OPS
                          + contrib5 * BWD_CONTRIB_OPS)
        tiers[tier] = dict(nblocks=nb, K=K, live=live_cols, err4=err4,
                           done_diff=done_diff, last_diff=last_diff,
                           rel5=rel5, ms4=ms4, pms4=pms4, ms5=ms5, pms5=pms5,
                           b4=b4, b5=b5, b5_all=b5_all, pairs4=pairs4,
                           pairs5=pairs5, contrib5=contrib5,
                           blocks5=cb.blend_bwd_blocks(nb, meta.B),
                           bits5=bits5, blocks4=cb.blend_fwd_blocks(
                               nb, meta.B), bits4=bits4, b4_all=b4_all,
                           cull4=cull4, **cull5)
        print(f"K4/K5 {tier}: {nb} blocks x K {K} ({live_cols:.0f} live "
              f"candidates): K4 max err {err4:.3g}, done differ "
              f"{done_diff:.3g}, last differ {last_diff:.3g}, "
              f"{ms4:.4f} ms (plain {pms4:.2f}, bound {b4[0]:.4f} {b4[1]}, "
              f"all-walked bound {b4_all[0]:.4f}; {pairs4:.4g} pairs, "
              f"{cull4['kept_pairs']:.4g} in the box; "
              f"{tiers[tier]['blocks4']} CUDA blocks, "
              f"{cull4['culled_share']:.4f} of the (candidate, group) pairs "
              f"culled, forward walk depth max {cull4['depth_max']:.0f} mean "
              f"{cull4['depth_mean']:.0f}, rerun bit-equal {bits4}); K5 rel "
              "err "
              + ", ".join(f"{k} {v:.3g}" for k, v in rel5.items())
              + f", {ms5:.4f} ms (plain {pms5:.2f}, bound {b5[0]:.4f} "
              f"{b5[1]}, all-walked bound {b5_all[0]:.4f}; {pairs5:.4g} "
              f"pairs, {cull5['kept_pairs']:.4g} in the box, {contrib5:.4g} "
              f"contributing; {tiers[tier]['blocks5']} CUDA blocks, "
              f"{cull5['culled_share']:.4f} of the (candidate, group) pairs "
              f"culled, walk depth max {cull5['depth_max']:.0f} mean "
              f"{cull5['depth_mean']:.0f}, rerun bit-equal {bits5})",
              flush=True)

    def row(name, wrapper, err, ms, pms, b, pairs, replaces, tol,
            extra=()):
        bound = sum(tiers[t][b][0] for t in tiers)
        by = max(tiers.values(), key=lambda v: v[b][0])[b][1]
        return dict(
            name=name, route="cuda",
            source="gsmpm_tpu_torch/csrc/tile_blend.cu", replaces=replaces,
            max_abs_err=err, tol=tol, wrapper=wrapper, library_ms=None,
            # one fit frame's pair of launches: tier 1 + tier 2
            ms=sum(tiers[t][ms] for t in tiers),
            plain_ms=sum(tiers[t][pms] for t in tiers),
            bound_ms=bound, bound_by=by,
            per_tier={t: dict(K=v["K"], nblocks=v["nblocks"], ms=v[ms],
                              plain_ms=v[pms], bound_ms=v[b][0],
                              bound_by=v[b][1], pairs=v[pairs],
                              **{k: v[k] for k in extra})
                      for t, v in tiers.items()})

    r4 = row("blend_fwd", cb.blend_fwd,
             max(v["err4"] for v in tiers.values()), "ms4", "pms4", "b4",
             "pairs4", "gsmpm_tpu/render/pallas_blend.py:136",
             "2e-3 abs on rgb/T",
             extra=("blocks4", "cull4", "b4_all", "bits4"))
    r4.update(blocks=sum(v["blocks4"] for v in tiers.values()),
              bound_all_walked_ms=sum(v["b4_all"][0] for v in tiers.values()),
              bit_equal=all(v["bits4"] for v in tiers.values()),
              depth_max=max(v["cull4"]["depth_max"] for v in tiers.values()))
    r5 = row("blend_bwd", cb.blend_bwd,
             max(max(v["rel5"].values()) for v in tiers.values()), "ms5",
             "pms5", "b5", "pairs5", "gsmpm_tpu/render/pallas_blend.py:212",
             "1e-4 x max per dF row group",
             extra=("blocks5", "culled_share", "kept_pairs", "b5_all",
                    "bits5", "depth_max"))
    r5.update(blocks=sum(v["blocks5"] for v in tiers.values()),
              bound_all_walked_ms=sum(v["b5_all"][0] for v in tiers.values()),
              bit_equal=all(v["bits5"] for v in tiers.values()))
    return [r4, r5], tiers


def sored_phase(dev, ident, first):
    """K6 against its twin (the chunk form of transfer_vjp._sored_all) on
    the fit state, with seeded window cotangents: the twin's tolerance, row
    63 and the dead chunks 0, a rerun's bits; K6's and the float32 twin's
    error against the twin in float64 (printed, not held); K6's time as
    the median of 9 batches of 20 launches; its build and launch
    geometry."""
    from gsmpm_tpu_torch.sim import cuda_mpm, tiles
    from gsmpm_tpu_torch.sim import transfer_vjp as tv
    from gsmpm_tpu_torch.sim.kernels import soa_from_state
    from gsmpm_tpu_torch.utils import build

    state = first[0]
    n = state.x.shape[0]
    grid = ident.grid
    tc = tiles.default_tile_config(grid.n_grid, n)
    ts = tiles.bootstrap(soa_from_state(state), ident.model, grid, tc)
    rng = np.random.default_rng(2)
    planes = torch.from_numpy(rng.normal(size=(tc.ntiles, 48, 256)).astype(
        np.float32)).to(dev)
    args = (ts.q, planes, ts.chunk_tile, ts.chunk_live, grid, tc)
    got = cuda_mpm.sored_tiled(*args)
    again = cuda_mpm.sored_tiled(*args)
    # timed before the twins: after their float32 and float64
    # contractions this phase read K6 slower while zero_ did not move
    # (PERF.md); the clocks are sampled before and after the batches
    clk = [card_state()]
    ms6, batches = batch_ms(lambda: cuda_mpm.sored_tiled(*args))
    # the store stream alone: PyTorch's zero_ of a tensor of K6's output
    # shape (the same bytes written, no arithmetic), a yardstick only
    zms6 = batch_ms(torch.empty_like(got).zero_)[0]
    clk.append(card_state())
    want = tv.sored_tiled_ref(*args)
    want64 = tv.sored_tiled_ref(ts.q.double(), planes.double(),
                                *args[2:])
    torch.cuda.synchronize()
    # float64: the real slots whose stencil base floor(x inv_dx - 0.5) is
    # the same in both precisions (a padding slot sits at a cell's centre,
    # where float32 may round to the base below)
    x = ts.q[tiles.RX:tiles.RX + 3]
    same = torch.all(torch.floor(x * grid.inv_dx - 0.5).double()
                     == torch.floor(x.double() * grid.inv_dx - 0.5), dim=0)
    keep = (ts.q[tiles.RMASS] > 0) & same
    rel, rel64, twin64 = {}, {}, {}
    for c in range(3):
        for gname, lo, hi in (("dW", 0, 3), ("dU", 3, 12), ("dD", 12, 21)):
            rows = slice(21 * c + lo, 21 * c + hi)
            scale = float(want[rows].abs().max())
            rel[f"{gname}{c}"] = float((got[rows] - want[rows]).abs().max()
                                       ) / max(scale, 1e-30)
            ref = want64[rows][:, keep]
            s64 = max(float(ref.abs().max()), 1e-300)
            rel64[f"{gname}{c}"] = float(
                (got[rows][:, keep].double() - ref).abs().max()) / s64
            twin64[f"{gname}{c}"] = float(
                (want[rows][:, keep].double() - ref).abs().max()) / s64
    err6 = float((got - want).abs().max())
    live = torch.repeat_interleave(ts.chunk_live == 1, tc.S)
    # fp32 sums over the 27 stencil nodes in another order than the twin's
    # bmm contractions: 1e-4 of each row group's largest entry
    check(max(rel.values()) <= 1e-4, f"K6 sored: rel err {rel}")
    check(float(got[63].abs().max()) == 0.0, "K6 sored: padding row")
    check(float(got[:, ~live].abs().sum()) == 0.0, "K6 sored: dead chunks")
    check(torch.equal(got, again), "K6 sored: a rerun's bits differ")
    pms6 = cuda_ms(lambda: tv.sored_tiled_ref(*args), 1, 1)
    n_live = int(ts.chunk_live.sum()) * tc.S
    n_real = int((ts.q[tiles.RMASS] > 0).sum())
    occupied = int(torch.unique(ts.chunk_tile[ts.chunk_live == 1]).numel())
    # bytes: 3 position rows of the live slots, the occupied tiles' planes,
    # the 64 output rows of every slot; operations: per real particle and
    # component 27 nodes x (2 + 12 pair updates, 28 flops) plus 3 x 21
    # multiply-adds, ~2,800 flops
    b6 = bound_ms(n_live * 3 * 4 + occupied * 48 * 256 * 4
                  + 64 * tc.np_rows * 4, n_real * 2808.0)
    info = cuda_mpm.sored_launch_info(tc.nchunk)
    log = build.BUILD_DIR / "mpm_sored.log"
    ptxas = [ln.strip() for ln in (log.read_text().splitlines()
                                   if log.exists() else [])
             if "registers" in ln or "spill" in ln or "smem" in ln]
    print(f"K6 sored: NP {tc.np_rows}, live slots {n_live}, occupied tiles "
          f"{occupied}: rel err " + ", ".join(f"{k} {v:.3g}"
                                              for k, v in rel.items())
          + f"; {ms6:.4f} ms median of 9 x 20 launches (spread "
          f"{min(batches):.4f}-{max(batches):.4f}; plain {pms6:.2f} ms, "
          f"bound {b6[0]:.4f} {b6[1]}, share {b6[0] / ms6:.3f}; zero_ of "
          f"the output's shape {zms6:.4f} ms; SM, memory clocks, power, "
          f"temperature before / after: {' / '.join(clk)}); rerun "
          f"bit-equal, row 63 and {tc.nchunk - n_live // tc.S} dead chunks "
          f"0", flush=True)
    print(f"K6 vs the twin in float64 ({int(keep.sum())} real slots, "
          f"{int((~same).sum())} slots whose base differs left out): K6 "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel64.items())
          + "; float32 twin " + ", ".join(f"{k} {v:.3g}"
                                           for k, v in twin64.items()),
          flush=True)
    print(f"K6 build: {'; '.join(ptxas) or 'no build log (built earlier)'}"
          f"; launch {info}", flush=True)
    return dict(
        name="sored_tiled", route="cuda",
        source="gsmpm_tpu_torch/csrc/mpm_sored.cu",
        replaces="gsmpm_tpu/sim/pallas_mpm.py:443", max_abs_err=err6,
        tol="1e-4 x max per row group", ms=ms6, plain_ms=pms6,
        bound_ms=b6[0], bound_by=b6[1], library_ms=None,
        rel_err=rel, ms_batches=batches, f64_rel_err=rel64,
        twin_f64_rel_err=twin64, registers=info["registers"],
        store_floor_ms=zms6,
        blocks=info["ctas"], bit_equal=True,
        wrapper=cuda_mpm.sored_tiled)


def fit_tiled_state(dev, ident, first):
    """The transfers' inputs at the fit's shapes: the steady identify
    frame's state bucketed as a fitting substep buckets it (the blob's ~21
    dense tiles), given seeded motion and strain, with the fit's Green
    StVK stress and substep dt: (ts, sig, grid, tc, dt)."""
    from gsmpm_tpu_torch.ops.constitutive import cauchy_stress_stvk_green_soa
    from gsmpm_tpu_torch.sim import tiles
    from gsmpm_tpu_torch.sim.kernels import soa_from_state

    state = first[0]
    grid = ident.grid
    tc = tiles.default_tile_config(grid.n_grid, state.x.shape[0])
    ts = seeded_motion(tiles.bootstrap(soa_from_state(state), ident.model,
                                       grid, tc))
    # a seeded strain, as seeded_motion's on F_trial: the fit's first
    # frames barely deform the blob, and its stress would vanish
    rng = np.random.default_rng(5)
    live = (ts.q[tiles.RMASS] > 0).to(ts.q.dtype)
    noise = torch.from_numpy(rng.normal(size=(9, tc.np_rows)).astype(
        np.float32)).to(dev)
    ts.q[tiles.RF:tiles.RF + 9] += 0.02 * noise * live
    F = tuple(ts.q[tiles.RF + i] for i in range(9))
    stress = cauchy_stress_stvk_green_soa(F, ts.aux[tiles.AMU],
                                          ts.aux[tiles.ALAM])
    sig = torch.cat([torch.stack(stress),
                     torch.zeros((7, tc.np_rows), device=dev)])
    dt = ident.fit_cfg.frame_dt / ident.fit_cfg.substeps_per_frame
    return ts, sig, grid, tc, dt


def transfer_fit_phases(dev, ident, first):
    """K1 and K2 at the fit's shapes (fit_tiled_state), K2 on the velocity
    blocks of K1's windows: their kernels-table rows."""
    from gsmpm_tpu_torch.sim import tiles

    ts, sig, grid, tc, dt = fit_tiled_state(dev, ident, first)
    win, row1 = p2g_phase(ts, sig, grid, tc, dt, "fit")
    ext = tiles.grid_phase(win, ident.model, ident.bcs, 0.0, grid, tc, dt)
    row2, _ = g2p_phase(ts, ext, grid, tc, dt, "fit")
    return row1, row2


# ---------------------------------------------------------------------------
# slice 3: the stream-rendered fit (path A) and the packed render (path B)
# ---------------------------------------------------------------------------

def stream_fit_path(dev, wrappers):
    """A SystemIdentifier on the bench fit configuration with the stream
    render, the way gsmpm_tpu reaches the stream fit
    (scripts/probe_stream_fit.py): ground truth at E_true, then fit frames
    1 and 2 (a tier-budget resize re-runs a frame), every launch counter
    set to 0 just before and read just after."""
    from gsmpm_tpu_torch.apps.identify import make_ring_cameras
    from gsmpm_tpu_torch.config import MPMConfig
    from gsmpm_tpu_torch.models.synthetic import synthetic_blob_scene
    from gsmpm_tpu_torch.render.renderer import RasterConfig
    from gsmpm_tpu_torch.sim.fitting import FitConfig, SystemIdentifier

    scene = synthetic_blob_scene(n=MAIN_N, radius=0.4, center=(0.0, 0.8, 0.0),
                                 device=dev)
    init_v = torch.tensor([[0.0, -2.0, 0.0]], device=dev).repeat(MAIN_N, 1)
    mpm_cfg = MPMConfig(material="jelly", E=FIT_E_INIT, nu=0.4, n_grid=50,
                        grid_extent=2.0, gravity=[0.0, -9.81, 0.0],
                        fitting=True)
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    ident = SystemIdentifier(scene, mpm_cfg, init_velocity=init_v,
                             fit_cfg=FitConfig(tie_params=True),
                             raster_cfg=RasterConfig(stream=True),
                             bg=torch.ones(3, device=dev))
    cams = make_ring_cameras(scene, FIT_RES)
    gt = ident.generate_ground_truth(FIT_E_TRUE, 0.3, cams, FIT_FRAMES)
    state, t = ident.reset_state(), 0.0
    frame_s, losses = [], []
    for fid in range(1, FIT_FRAMES):
        t1 = time.perf_counter()
        loss, state, t, _ = ident.fit_frame(state, t, cams[fid], gt[fid])
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t1)
        losses.append(float(loss))
        check(ident.n_dropped_last == 0,
              f"stream fit frame {fid}: n_dropped {ident.n_dropped_last}")
    wall = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in wrappers}
    check(all(np.isfinite(v) for v in losses), f"stream fit losses {losses}")
    check(ident.sim_engine == "tiled_vjp", f"engine {ident.sim_engine}")
    E = ident.optimized_E
    check(np.isfinite(E) and abs(E / FIT_E_INIT - 1.0) > 1e-6,
          f"stream fit: E did not move from {FIT_E_INIT} ({E})")
    for name in ("p2g_tiled", "g2p_tiled", "sored_tiled", "stream_blend",
                 "stream_blend_bwd"):
        check(counts[name] > 0, f"stream fit path: {name} never launched")
    for name in ("blend_fwd", "blend_bwd", "blend_packed_fwd",
                 "blend_packed_bwd"):
        check(counts[name] == 0, f"stream fit path ran {name}")
    check(counts["stream_blend_bwd"] >= FIT_FRAMES - 1,
          f"stream_blend_bwd: {counts['stream_blend_bwd']} launches")
    rc = ident.raster_cfg
    print(f"stream fit path: {MAIN_N} gaussians, n_grid 50, {FIT_RES}^2, "
          f"{FIT_FRAMES - 1} fit frames x {FIT_SUBSTEPS} substeps: frame "
          f"seconds {[round(x, 3) for x in frame_s]}, losses "
          f"{[round(x, 6) for x in losses]}, E {FIT_E_INIT:g} -> {E:.6g}, nu "
          f"{ident.optimized_nu:.5f}, budgets g2/g3/g4 {rc.stream_g2}/"
          f"{rc.stream_g3}/{rc.stream_g4}, budget rebuilds "
          f"{ident._total_rebuilds}, wall {wall:.1f} s (ground truth "
          f"included), launches {counts}", flush=True)
    return ident, counts, dict(frame_s=frame_s, losses=losses, E=E,
                               nu=ident.optimized_nu,
                               budget_rebuilds=ident._total_rebuilds,
                               wall_s=wall)


def _fit_stream(ident, state, cam):
    """The fit frame's stream: (sorted planes, bounds, levels), drop-free."""
    from gsmpm_tpu_torch.render import renderer as rr
    from gsmpm_tpu_torch.render import stream_raster as sr

    cfg = ident.raster_cfg
    with torch.no_grad():
        xyz, cov = ident._world_geometry(state)
        opacity, features = ident._appearance()
        pre = rr.preprocess(xyz, cov, opacity, features, cam,
                            ident.scene.sh_degree, cfg)
        splanes, bounds, nd, lv = sr.stream_inputs(pre, cam, cfg)
    check(int(nd) == 0, f"fit stream dropped {int(nd)}")
    return splanes, bounds, lv


def stream_bwd_phase(dev, ident, first):
    """K7 against its twin on the steady stream-fit frame's real stream and
    blend state, with a seeded cotangent; K3 timed on the same stream."""
    from gsmpm_tpu_torch.render import stream_raster as sr

    state, cam = first[0], first[1]
    cfg = ident.raster_cfg
    splanes, bounds, lv = _fit_stream(ident, state, cam)
    args = (lv.nbx, cfg.block, float(cfg.alpha_min))
    out = sr.stream_blend(splanes, bounds, lv.nbx, cfg.block,
                          float(cfg.t_min), float(cfg.alpha_min))
    rng = np.random.default_rng(3)
    g = torch.zeros_like(out)
    g[:, 0:4] = torch.from_numpy(rng.normal(size=(out.shape[0], 4,
                                                  out.shape[2]))
                                 .astype(np.float32)).to(dev)
    got = sr.stream_blend_bwd(splanes, bounds, out, g, *args)
    want = sr.stream_blend_bwd_ref(splanes, bounds, out, g, *args)
    # the sums run in a fixed order: a second launch gives the bits
    bits7 = torch.equal(got, sr.stream_blend_bwd(splanes, bounds, out, g,
                                                 *args))
    torch.cuda.synchronize()
    rel = {}
    for gname, rows in (("position", slice(0, 2)), ("conic", slice(2, 5)),
                        ("logo", slice(5, 6)), ("rgb", slice(6, 9))):
        scale = float(want[rows].abs().max())
        rel[gname] = float((got[rows] - want[rows]).abs().max()) / max(
            scale, 1e-30)
    err7 = float((got - want).abs().max())
    # the reverse walk recovers T by division, sequentially here and per
    # chunk in the twin: 1e-4 of each row group's largest entry
    check(max(rel.values()) <= 1e-4, f"K7 stream bwd: rel err {rel}")
    check(bits7, "K7 stream bwd: two launches differ")
    ms7 = cuda_ms(lambda: sr.stream_blend_bwd(splanes, bounds, out, g, *args),
                  20)
    pms7 = cuda_ms(lambda: sr.stream_blend_bwd_ref(splanes, bounds, out, g,
                                                   *args), 1, 1)
    ms3 = cuda_ms(lambda: sr.stream_blend(splanes, bounds, lv.nbx, cfg.block,
                                          float(cfg.t_min),
                                          float(cfg.alpha_min)), 20)
    out_r = sr.stream_blend_ref(splanes, bounds, lv.nbx, cfg.block,
                                float(cfg.t_min), float(cfg.alpha_min))
    err3 = float((out[:, 0:4] - out_r[:, 0:4]).abs().max())
    done3 = float((out[:, 4] != out_r[:, 4]).float().mean())
    check(err3 <= 2e-3 and done3 <= 1e-4,
          f"K3 on the fit stream: max err {err3}, done differ {done3}")
    cull = k3_cull(splanes, bounds, out, lv.nbx, cfg.block,
                   float(cfg.alpha_min))
    b3 = k3_bound(splanes, bounds, out, cull)
    print(f"K3 stream (stream fit): max err {err3:.3g}, done differ "
          f"{done3:.3g}; {cull['culled_share']:.4f} of the (slot, group) "
          f"pairs culled; walked pairs {cull['pairs']:.4g}, kept "
          f"{cull['kept_pairs']:.4g}; {ms3:.4f} ms, bound {b3[0]:.4f} "
          f"{b3[1]}", flush=True)
    # (slot, pixel) pairs this data needs: each pixel from its last
    # contributor back to its segment's start, gated where the pixel lies
    # in the slot's box (the all-walked bound: everywhere); the
    # contributing ones among them (GATE_OPS / BWD_CONTRIB_OPS)
    lo = bounds[:-1].to(torch.float64)
    last = out[:, 5].to(torch.float64)
    cull7 = k7_cull(splanes, bounds, out, *args)
    pairs = cull7["pairs"]
    contrib = _contrib_pairs_stream(splanes, bounds, out, *args)
    walked = float((last.amax(dim=1) - lo).clamp_min(0).sum())
    # bytes: the walked slots' 9 planes, the state and cotangent rows read
    # (T, last, rgb, T), d(splanes) written whole
    bytes7 = (walked * 9 * 4 + out.shape[0] * 6 * out.shape[2] * 4
              + splanes.numel() * 4)
    b7 = bound_ms(bytes7, cull7["kept_pairs"] * GATE_OPS
                  + contrib * BWD_CONTRIB_OPS)
    b7_all = bound_ms(bytes7, pairs * GATE_OPS + contrib * BWD_CONTRIB_OPS)
    blocks7 = sr.stream_bwd_blocks(lv.nf, cfg.block)
    print(f"K7 stream bwd: {lv.nf} display blocks in {blocks7} CUDA blocks, "
          f"{splanes.shape[1]} slots ({walked:.0f} walked, {pairs:.4g} "
          f"pairs, {cull7['kept_pairs']:.4g} in the box, {contrib:.4g} "
          f"contributing; {cull7['culled_share']:.4f} of the (slot, group) "
          f"pairs culled, walk depth max {cull7['depth_max']:.0f} mean "
          f"{cull7['depth_mean']:.0f}): rel err "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
          + f"; rerun bit-equal {bits7}; {ms7:.4f} ms (plain {pms7:.2f} ms, "
          f"bound {b7[0]:.4f} {b7[1]}, all-walked bound {b7_all[0]:.4f}); "
          f"K3 on the same stream {ms3:.4f} ms", flush=True)
    return dict(
        name="stream_blend_bwd", route="cuda",
        source="gsmpm_tpu_torch/csrc/stream_raster.cu",
        replaces="gsmpm_tpu/render/stream_raster.py:392", max_abs_err=err7,
        rel_err=max(rel.values()), tol="1e-4 x max per row group", ms=ms7,
        plain_ms=pms7, bound_ms=b7[0], bound_by=b7[1], library_ms=None,
        wrapper=sr.stream_blend_bwd, pairs=pairs, contrib_pairs=contrib,
        walked_slots=walked, blocks=blocks7,
        culled_share=cull7["culled_share"], kept_pairs=cull7["kept_pairs"],
        bound_all_walked_ms=b7_all[0], bit_equal=bits7,
        depth_max=cull7["depth_max"],
        L=int(splanes.shape[1]),
        k3_fit=dict(ms=ms3, max_abs_err=err3, done_differ=done3,
                    bound_ms=b3[0], bound_by=b3[1], **cull))


def packed_phase(dev, ident, first, wrappers):
    """Path B: the steady stream-fit frame's geometry rendered with the
    packed windowed layout at drop-free caps (required_raster_caps; t_cap
    the sum of the blocks' C-aligned counts), and a backward to the means
    and the SH colour features under a seeded cotangent, held against the
    padded path at the same caps; then K8 / K9 against their twins on the
    packed inputs."""
    from gsmpm_tpu_torch.render import cuda_blend as cb
    from gsmpm_tpu_torch.render import renderer as rr

    state, cam = first[0], first[1]
    with torch.no_grad():
        xyz, cov = ident._world_geometry(state)
        opacity, features = ident._appearance()
    base = rr.RasterConfig()
    C = base.chunk
    need = rr.required_raster_caps(xyz, cov, opacity, cam, base)

    def up(k):
        return max(C, -(-k // C) * C)

    cfg = base._replace(k_tile=up(need["k_tile"]),
                        k_coarse=up(need["k_coarse"]),
                        k_global=up(need["k_global"]), packed=True)
    sh = ident.scene.sh_degree
    with torch.no_grad():
        pre = rr.preprocess(xyz, cov, opacity, features, cam, sh, cfg)
        gidx, counts, origins, dropped = rr._select_candidates_dupsort_v2(
            pre, cam, cfg)
    check(int(dropped) == 0, f"packed caps drop {int(dropped)}")
    cfg = cfg._replace(t_cap=int((((counts.to(torch.int64) + C - 1) // C)
                                  * C).sum()))
    rng = np.random.default_rng(4)
    ct = torch.from_numpy(rng.normal(size=(FIT_RES, FIT_RES, 3)).astype(
        np.float32)).to(dev)

    def render(c):
        m = xyz.detach().clone().requires_grad_(True)
        f = features.detach().clone().requires_grad_(True)
        t0 = time.perf_counter()
        img, nd = rr.render_with_aux(m, cov, opacity, f, cam, ident.bg, sh, c)
        torch.sum(img * ct).backward()
        torch.cuda.synchronize()
        return img.detach(), int(nd), m.grad, f.grad, time.perf_counter() - t0

    for w in wrappers:
        w.launches = 0
    img_p, nd_p, gm_p, gf_p, s_p = render(cfg)
    counts_p = {w.__name__: w.launches for w in wrappers}
    img_u, nd_u, gm_u, gf_u, s_u = render(cfg._replace(packed=False))
    check(nd_p == 0 and nd_u == 0, f"packed / padded n_dropped {nd_p} {nd_u}")
    want = {w.__name__: 0 for w in wrappers}
    want.update(blend_packed_fwd=1, blend_packed_bwd=1)
    check(counts_p == want, f"packed path launches {counts_p}")
    img_err = float((img_p - img_u).abs().max())
    g_rel = {k: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
             for k, a, b in (("means", gm_p, gm_u), ("features", gf_p, gf_u))}
    # the same blend on another layout: the image to 1e-6; the gradients
    # sum the per-warp atomics and the gathers' index_add_ in another order
    check(img_err <= 1e-6, f"packed vs padded image err {img_err}")
    check(max(g_rel.values()) <= 1e-5, f"packed vs padded grads {g_rel}")

    # K8 / K9 on the packed render's own inputs
    with torch.no_grad():
        cand, x0, y0, cnt, offs, over = rr._packed_candidates(
            pre, gidx, counts, origins, cfg)
        F, meta = cb.packed_inputs(cand, x0, y0, cfg)
    check(int(over) == 0, f"t_cap dropped {int(over)}")
    nb, P = cnt.shape[0], meta.P
    out_k = cb.blend_packed_fwd(cnt, offs, F, meta)
    out_r = cb.blend_packed_ref(cnt, offs, F, meta)
    torch.cuda.synchronize()
    err8 = float((out_k[:, 0:4] - out_r[:, 0:4]).abs().max())
    done_diff = float((out_k[:, 4] != out_r[:, 4]).float().mean())
    last_diff = float((out_k[:, 5] != out_r[:, 5]).float().mean())
    g = torch.zeros_like(out_k)
    g[:, 0:4] = torch.from_numpy(rng.normal(size=(nb, 4, P)).astype(
        np.float32)).to(dev)
    dF_k = cb.blend_packed_bwd(cnt, offs, F, out_k, g, meta)
    dF_r = cb.blend_packed_bwd_ref(cnt, offs, F, out_k, g, meta)
    # the sums run in a fixed order: a second launch gives the bits, and
    # K5 on the same windows gathered into the padded layout gives them too
    bits9 = torch.equal(dF_k, cb.blend_packed_bwd(cnt, offs, F, out_k, g,
                                                  meta))
    cols, walked_cols = cb._packed_windows(cnt, offs, F.shape[1], meta)
    Fw = F[:, cols].transpose(0, 1).contiguous()
    dF5 = cb.blend_bwd(Fw, out_k, g, meta)
    k9_is_k5 = torch.equal(dF_k[:, cols[walked_cols]],
                           dF5.transpose(0, 1)[:, walked_cols])
    torch.cuda.synchronize()
    rel9 = {}
    for gname, rows in (("quad", slice(0, 6)), ("logo", slice(6, 7)),
                        ("rgb", slice(8, 11))):
        scale = float(dF_r[rows].abs().max())
        rel9[gname] = float((dF_k[rows] - dF_r[rows]).abs().max()) / max(
            scale, 1e-30)
    pad_rows = float(dF_k[11:].abs().max()) + float(dF_k[7].abs().max())
    # K4 / K5's tolerances: sequential vs chunked transmittance products
    check(err8 <= 2e-3, f"K8: max err {err8}")
    check(done_diff <= 1e-4, f"K8: done flags differ {done_diff}")
    check(last_diff <= 1e-4, f"K8: last index differs {last_diff}")
    check(max(rel9.values()) <= 1e-4, f"K9: rel err {rel9}")
    check(pad_rows == 0.0, f"K9: unused dF rows {pad_rows}")
    check(bits9, "K9: two launches differ")
    check(k9_is_k5, "K9: not K5's bits on the same windows")
    # the forward walk's bits: a rerun, and K4 on the same windows
    bits8 = torch.equal(out_k, cb.blend_packed_fwd(cnt, offs, F, meta))
    k8_is_k4 = torch.equal(out_k, cb.blend_fwd(cnt, Fw, meta))
    check(bits8, "K8: two launches differ")
    check(k8_is_k4, "K8: not K4's bits on the same windows")
    ms8 = cuda_ms(lambda: cb.blend_packed_fwd(cnt, offs, F, meta), 20)
    pms8 = cuda_ms(lambda: cb.blend_packed_ref(cnt, offs, F, meta), 1, 1)
    ms9 = cuda_ms(lambda: cb.blend_packed_bwd(cnt, offs, F, out_k, g, meta),
                  20)
    pms9 = cuda_ms(lambda: cb.blend_packed_bwd_ref(cnt, offs, F, out_k, g,
                                                   meta), 1, 1)
    cull9 = window_cull(Fw, out_k, meta)
    # pairs and bytes as K4 / K5's (blend_phases)
    cntf = cnt.to(torch.float64)[:, None]
    last = out_k[:, 5].to(torch.float64)
    pairs8 = float(torch.where(out_k[:, 4] > 0, last, cntf).sum())
    pairs9 = float(last.sum())
    contrib9 = _contrib_pairs_windows(Fw, out_k, meta)
    live_cols = float(cnt.sum())
    cull8 = fwd_window_cull(Fw, cnt, out_k, meta)
    bytes8 = cull8["read_cols"] * 10 * 4 + out_k.numel() * 4
    b8 = bound_ms(bytes8, cull8["kept_pairs"] * 20.0)
    b8_all = bound_ms(bytes8, pairs8 * 20.0)
    blocks8 = cb.blend_fwd_blocks(nb, meta.B)
    bytes9 = live_cols * (10 + 16) * 4 + nb * 6 * P * 4
    b9 = bound_ms(bytes9, cull9["kept_pairs"] * GATE_OPS
                  + contrib9 * BWD_CONTRIB_OPS)
    b9_all = bound_ms(bytes9, pairs9 * GATE_OPS + contrib9 * BWD_CONTRIB_OPS)
    blocks9 = cb.blend_bwd_blocks(nb, meta.B)
    print(f"packed path: caps k_tile {cfg.k_tile} k_coarse {cfg.k_coarse} "
          f"k_global {cfg.k_global}, t_cap {cfg.t_cap} ({live_cols:.0f} live "
          f"candidates in {nb} blocks); render + backward {s_p:.3f} s packed, "
          f"{s_u:.3f} s padded; image err {img_err:.3g}, grad rel err "
          + ", ".join(f"{k} {v:.3g}" for k, v in g_rel.items())
          + f"; launches {counts_p}", flush=True)
    print(f"K8 packed fwd: max err {err8:.3g}, done differ {done_diff:.3g}, "
          f"last differ {last_diff:.3g}, {ms8:.4f} ms (plain {pms8:.2f}, "
          f"bound {b8[0]:.4f} {b8[1]}, all-walked bound {b8_all[0]:.4f}; "
          f"{pairs8:.4g} pairs, {cull8['kept_pairs']:.4g} in the box; "
          f"{blocks8} CUDA blocks, {cull8['culled_share']:.4f} of the "
          f"(candidate, group) pairs culled, forward walk depth max "
          f"{cull8['depth_max']:.0f} mean {cull8['depth_mean']:.0f}; rerun "
          f"bit-equal {bits8}, K4's bits {k8_is_k4}); K9 rel err "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel9.items())
          + f", {ms9:.4f} ms (plain {pms9:.2f}, bound {b9[0]:.4f} {b9[1]}, "
          f"all-walked bound {b9_all[0]:.4f}; {pairs9:.4g} pairs, "
          f"{cull9['kept_pairs']:.4g} in the box, {contrib9:.4g} "
          f"contributing; {blocks9} CUDA blocks, "
          f"{cull9['culled_share']:.4f} of the (candidate, group) pairs "
          f"culled, walk depth max {cull9['depth_max']:.0f}; rerun "
          f"bit-equal {bits9}, K5's bits {k9_is_k5})", flush=True)
    common = dict(route="cuda", source="gsmpm_tpu_torch/csrc/tile_blend.cu",
                  library_ms=None)
    rows = [
        dict(name="blend_packed_fwd", wrapper=cb.blend_packed_fwd,
             replaces="gsmpm_tpu/render/pallas_blend.py:692",
             max_abs_err=err8, tol="2e-3 abs on rgb/T", ms=ms8,
             plain_ms=pms8, bound_ms=b8[0], bound_by=b8[1], pairs=pairs8,
             blocks=blocks8, culled_share=cull8["culled_share"],
             kept_pairs=cull8["kept_pairs"], bound_all_walked_ms=b8_all[0],
             bit_equal=bits8 and k8_is_k4, depth_max=cull8["depth_max"],
             depth_mean=cull8["depth_mean"], **common),
        dict(name="blend_packed_bwd", wrapper=cb.blend_packed_bwd,
             replaces="gsmpm_tpu/render/pallas_blend.py:759",
             max_abs_err=float((dF_k - dF_r).abs().max()),
             tol="1e-4 x max per dF row group", ms=ms9, plain_ms=pms9,
             bound_ms=b9[0], bound_by=b9[1], pairs=pairs9,
             contrib_pairs=contrib9, blocks=blocks9,
             culled_share=cull9["culled_share"],
             kept_pairs=cull9["kept_pairs"], bound_all_walked_ms=b9_all[0],
             bit_equal=bits9 and k9_is_k5, depth_max=cull9["depth_max"],
             **common),
    ]
    return counts_p, dict(
        caps=dict(k_tile=cfg.k_tile, k_coarse=cfg.k_coarse,
                  k_global=cfg.k_global, t_cap=cfg.t_cap),
        live=live_cols, render_bwd_s=s_p, padded_render_bwd_s=s_u,
        image_err=img_err, grad_rel=g_rel, rel9=rel9, err8=err8), rows


def small_fit_parity(dev, stream: bool = False):
    """One fit frame (3 tiled-VJP substeps, the windowed or the stream
    render, backward, SGD) on the GPU kernels and on the CPU twins: 512
    gaussians, n_grid 24, 64x64."""
    from gsmpm_tpu_torch.config import MPMConfig
    from gsmpm_tpu_torch.models.synthetic import synthetic_blob_scene
    from gsmpm_tpu_torch.render.camera import make_camera
    from gsmpm_tpu_torch.render.renderer import RasterConfig
    from gsmpm_tpu_torch.sim.fitting import FitConfig, SystemIdentifier

    res, gt = {}, None
    for d in ("cpu", str(dev)):
        d = torch.device(d)
        n = 512
        ident = SystemIdentifier(
            synthetic_blob_scene(n=n, seed=5, radius=0.4,
                                 center=(0.0, 0.8, 0.0), device=d),
            MPMConfig(material="jelly", E=1e4, nu=0.3, n_grid=24,
                      grid_extent=2.0, gravity=[0.0, -9.81, 0.0],
                      fitting=True),
            init_velocity=torch.tensor([[0.0, -2.0, 0.0]],
                                       device=d).repeat(n, 1),
            fit_cfg=FitConfig(substeps_per_frame=3),
            raster_cfg=RasterConfig(block=32, chunk=32, stream=stream),
            bg=torch.ones(3, device=d))
        ident._sim_engine = "tiled_vjp"
        cam = make_camera(64, 64, 0.7, 0.7, np.eye(3),
                          np.array([0.0, 0.8, -3.0]))
        if gt is None:
            gt = ident.generate_ground_truth(3e3, 0.3, [cam], 2)[1].cpu()
        loss, st, _, img = ident.fit_frame(ident.reset_state(), 0.0, cam,
                                           gt.to(d))
        res[d.type] = (float(loss), img.cpu(), [g.cpu() for g in
                                               ident.last_grads], st.x.cpu())
    (lc, ic, gc, xc), (lg, ig, gg, xg) = res["cpu"], res["cuda"]
    err = dict(loss=abs(lc - lg), image=float((ic - ig).abs().max()),
               x=float((xc - xg).abs().max()),
               g_logE=float((gc[0] - gg[0]).abs().max()
                            / gc[0].abs().max()),
               g_y=float((gc[1] - gg[1]).abs().max() / gc[1].abs().max()))
    # float atomics over 3 substeps, then the render and its reverse walk
    render = "stream" if stream else "windowed"
    check(err["loss"] <= 1e-6 and err["image"] <= 1e-3 and err["x"] <= 1e-4
          and err["g_logE"] <= 1e-3 and err["g_y"] <= 1e-3,
          f"small {render} fit GPU-vs-CPU {err}")
    print(f"small {render} fit GPU-vs-CPU parity: " + ", ".join(
        f"{k} {v:.3g}" for k, v in err.items())
          + " (tol loss 1e-6, image 1e-3, x 1e-4, gradients 1e-3 of max)",
          flush=True)
    return err


# ---------------------------------------------------------------------------
# slice 5: the multi-device fit steps on a one-rank mesh
# ---------------------------------------------------------------------------

def _fit_summary(loss, img, grads, logE, y, secs, counts):
    """A fit step's numbers: loss, image, the tied gradient (the finite
    per-particle gradient summed), the updated scalar pair."""
    def tied(g):
        return float(torch.where(torch.isfinite(g), g, 0.0).sum())

    return dict(loss=float(loss), image=img.detach(), g_logE=tied(grads[0]),
                g_y=tied(grads[1]), logE=float(logE[0]), y=float(y[0]),
                s=secs, launches=counts)


def _fit_diffs(a, b):
    diff = (a["image"] - b["image"]).abs()
    return dict(loss=abs(a["loss"] - b["loss"]), image=float(diff.max()),
                image_mean=float(diff.mean()),
                g_logE=abs(a["g_logE"] - b["g_logE"]),
                g_y=abs(a["g_y"] - b["g_y"]), logE=abs(a["logE"] - b["logE"]),
                y=abs(a["y"] - b["y"]))


def _blend_twins(dev, F, counts, meta):
    """K4 and K5 (a seeded cotangent) against their twins on one window
    set: (K4 max abs err on rgb / T, K5 worst relative err per dF row
    group, K4 ms, K5 ms)."""
    from gsmpm_tpu_torch.render import cuda_blend as cb

    out_k = cb.blend_fwd(counts, F, meta)
    out_r = cb.blend_core_ref(counts, F, meta)
    g = torch.zeros_like(out_k)
    g[:, 0:4] = torch.from_numpy(np.random.default_rng(2).normal(
        size=(F.shape[0], 4, meta.P)).astype(np.float32)).to(dev)
    dF_k = cb.blend_bwd(F, out_k, g, meta)
    dF_r = cb.blend_core_bwd_ref(F, out_k, g, meta)
    torch.cuda.synchronize()
    err4 = float((out_k[:, 0:4] - out_r[:, 0:4]).abs().max())
    rel5 = max(float((dF_k[:, r] - dF_r[:, r]).abs().max())
               / max(float(dF_r[:, r].abs().max()), 1e-30)
               for r in (slice(0, 6), slice(6, 7), slice(8, 11)))
    ms4 = cuda_ms(lambda: cb.blend_fwd(counts, F, meta), 5)
    ms5 = cuda_ms(lambda: cb.blend_bwd(F, out_k, g, meta), 5)
    return err4, rel5, ms4, ms5


def mesh_fit_phase(dev, ident, gt, cams, wrappers):
    """parallel/sharded.py's fit steps on a one-rank NCCL group built in
    this process, at identify's configuration from the steady fit frame's
    start state (frame 1, its camera and target): the sharded step
    (SystemIdentifier(mesh=data 1 x tile 1): K1 / K2 / K6 on the rank's
    shard, the grid all-reduced, the rows render K4 / K5 through the
    differentiable all-gathers), the camera-DP step on one camera (the
    two-tier render) and the sharded step with the occupied-tile cap forced
    below the blob's tiles (sim_ok False, redone on golden).  Each is held
    against two single-device fit_frame runs from the same state and
    parameters (MESH_FIT_REL); the image's largest difference is printed
    beside the two single runs' and beside the rows render against the
    two-tier render of the same state.  Launches per step are exact; K4 /
    K5 are held against their twins on the rows render's windows.  The
    sharded step's window replays the fitting graphs with the group's
    all-reduces inside; slice 11's turns (``_mesh_fit_turns``) hold it
    against the checkpointed loop.  A one-rank group cannot show a
    device-count factor: the CPU tests carry that
    (tests/test_torch_parallel_fit.py)."""
    import os

    import torch.distributed as dist

    from gsmpm_tpu_torch.parallel.mesh import make_mesh
    from gsmpm_tpu_torch.parallel.sharded import (
        make_camera_dp_fit_step, stack_cameras,
    )
    from gsmpm_tpu_torch.render import cuda_blend as cb
    from gsmpm_tpu_torch.render.renderer import (
        block_origins, block_rows_candidates, preprocess,
    )
    from gsmpm_tpu_torch.sim import tiles
    from gsmpm_tpu_torch.sim.fitting import SystemIdentifier

    cam, target = cams[1], gt[1]
    logE0, y0 = ident.model.logE.clone(), ident.model.y.clone()
    state0 = ident.reset_state()
    fcfg = ident.fit_cfg
    per_step = {w.__name__: 0 for w in wrappers}
    per_step.update({k: v * FIT_SUBSTEPS for k, v in PER_SUBSTEP.items()})
    tiers = 2 if ident.raster_cfg.k_dense > 0 else 1

    def timed(fn):
        _zero(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, _counts(wrappers)

    def expect(counts, what, **kw):
        want = dict(per_step, **kw)
        check(counts == want, f"{what}: launches {counts}, expected {want}")

    singles = []
    for _ in range(2):
        ident._set_params(logE0.clone(), y0.clone())
        (loss, _, _, img), secs, counts = timed(
            lambda: ident.fit_frame(state0, 0.0, cam, target))
        expect(counts, "single fit frame", blend_fwd=tiers, blend_bwd=tiers)
        singles.append(_fit_summary(loss, img, ident.last_grads,
                                    ident.model.logE, ident.model.y, secs,
                                    counts))
    ident._set_params(logE0, y0)
    spread = _fit_diffs(*singles)

    def close(got, what):
        d = _fit_diffs(got, singles[0])
        tol = {k: 2 * spread[k] + rel * abs(singles[0][k])
               for k, rel in MESH_FIT_REL.items()}
        bad = {k: (d[k], tol[k]) for k in tol if d[k] > tol[k]}
        check(not bad, f"{what} vs single fit_frame: {bad} (spread "
                       f"{spread})")
        return d

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        out = dict(single=[{k: v for k, v in r.items() if k != "image"}
                           for r in singles], spread=spread)
        mesh = make_mesh((("data", 1), ("tile", 1)), "cuda")
        sid = SystemIdentifier(ident.scene, ident.mpm_cfg,
                               init_velocity=ident.init_velocity,
                               fit_cfg=fcfg, raster_cfg=ident.raster_cfg,
                               bg=ident.bg, mesh=mesh)
        sid.reset_state()  # its BCs and grid transform (ident's)
        # settle the rows render's k_row / k_block caps on this frame
        sid._set_params(logE0.clone(), y0.clone())
        sid.fit_frame(state0, 0.0, cam, target)
        rebuilds = sid._total_rebuilds
        sid._set_params(logE0.clone(), y0.clone())
        (loss, st_s, _, img), secs, counts = timed(
            lambda: sid.fit_frame(state0, 0.0, cam, target))
        check(sid._total_rebuilds == rebuilds and sid.n_dropped_last == 0,
              "sharded step: caps resized or dropped in the measured step")
        check(sid.sim_engine == "tiled_vjp", f"engine {sid.sim_engine}")
        expect(counts, "sharded step", blend_fwd=1, blend_bwd=1)
        sharded = _fit_summary(loss, img, sid.last_grads, sid.model.logE,
                               sid.model.y, secs, counts)
        d_sh = close(sharded, "sharded step")
        graph_turns = _mesh_fit_turns(sid, logE0, y0, state0, cam, target,
                                      wrappers, dict(per_step, blend_fwd=1,
                                                     blend_bwd=1))
        # the routes' own image difference: the two-tier render of the
        # state that the sharded step rendered with its rows render
        with torch.no_grad():
            route_img, _ = ident._render_state(st_s, cam)
        route = float((img - route_img).abs().max())

        mesh_c = make_mesh((("cam", 1),), "cuda")
        opacity, features = ident._appearance()
        step = make_camera_dp_fit_step(
            mesh_c, ident.model, ident.bcs, ident.grid, fcfg.frame_dt,
            fcfg.substeps_per_frame, ident.bg, opacity, features,
            ident.scene.sh_degree, ident.scaling, ident.pos_center,
            ident.mpm_cfg.grid_extent, raster_cfg=ident.raster_cfg,
            lr_logE=fcfg.lr_logE, lr_y=fcfg.lr_y, grad_clip=fcfg.grad_clip,
            tie_params=fcfg.tie_params, sim_engine="tiled_vjp")
        dp, secs, counts = timed(lambda: step(
            logE0, y0, state0, 0.0, stack_cameras([cam]), target[None]))
        check(dp.sim_ok and dp.n_dropped == 0,
              f"camera-DP: sim_ok {dp.sim_ok}, n_dropped {dp.n_dropped}")
        expect(counts, "camera-DP step", blend_fwd=tiers, blend_bwd=tiers)
        camdp = _fit_summary(dp.loss, dp.image, dp.grads, dp.logE, dp.y,
                             secs, counts)
        d_dp = close(camdp, "camera-DP step")

        # K4 / K5 against their twins on the rows render's windows
        xyz, cov = ident._world_geometry(st_s)
        pre = preprocess(xyz, cov, opacity, features, cam,
                         ident.scene.sh_degree, sid.raster_cfg)
        order = torch.sort(torch.where(pre.valid, pre.depth, torch.inf),
                           stable=True).indices
        _, nbx, nby = block_origins(cam, sid.raster_cfg)
        cand, cnts, origins = block_rows_candidates(pre, order, 0.0, nby, nbx,
                                                    sid.raster_cfg)
        F, cnts, meta = cb.blend_inputs(cand, cnts, origins, sid.raster_cfg)
        err4, rel5, ms4, ms5 = _blend_twins(dev, F, cnts, meta)
        check(err4 <= 2e-3, f"mesh fit K4: max err {err4}")
        check(rel5 <= 1e-4, f"mesh fit K5: rel err {rel5}")

        # the occupied-tile cap below the blob's tiles: sim_ok False on the
        # rank, the step redone on golden (no tiled kernel after the failed
        # forward's K1 / K2 per substep)
        real = tiles.default_tile_config
        tiles.default_tile_config = \
            lambda g, n: real(g, n)._replace(n_occ_cap=1)
        try:
            sid._set_params(logE0.clone(), y0.clone())
            g0 = _golden_graph_counts()
            (loss_g, _, _, img_g), secs_g, counts = timed(
                lambda: sid.fit_frame(state0, 0.0, cam, target))
            redo_graph = _golden_graph_delta(g0)
        finally:
            tiles.default_tile_config = real
        check(sid.sim_engine == "golden", f"overflow: engine {sid.sim_engine}")
        # the redo runs the golden window (slice 12): its forward and
        # adjoint graphs, captured on this group, the all-reduces inside
        check(redo_graph["replays"] > 0 and redo_graph["captures"]
              + redo_graph["replays"] == 2 * FIT_SUBSTEPS,
              f"golden redo: graph counters {redo_graph}")
        check(np.isfinite(float(loss_g)) and bool(torch.isfinite(img_g).all()),
              f"golden redo: loss {float(loss_g)}")
        expect(counts, "overflow step", p2g_tiled=FIT_SUBSTEPS,
               g2p_tiled=FIT_SUBSTEPS, sored_tiled=0, blend_fwd=1,
               blend_bwd=1)
        golden = _fit_summary(loss_g, img_g, sid.last_grads, sid.model.logE,
                              sid.model.y, secs_g, counts)
        d_go = _fit_diffs(golden, sharded)
        out.update(
            graph_turns=graph_turns,
            sharded={k: v for k, v in sharded.items() if k != "image"},
            camdp={k: v for k, v in camdp.items() if k != "image"},
            golden_redo={k: v for k, v in golden.items() if k != "image"},
            diff_sharded=d_sh, diff_camdp=d_dp, route_image=route,
            golden_vs_tiled=d_go, golden_redo_graph=redo_graph,
            rows_K=int(F.shape[2]),
            rows_windows=int(F.shape[0]), k4_err=err4, k5_rel=rel5,
            k4_ms=ms4, k5_ms=ms5, k_row=sid.raster_cfg.k_row,
            k_block=sid.raster_cfg.k_block)
        fmt = lambda d: ", ".join(f"{k} {v:.3g}" for k, v in d.items())
        print(f"mesh fit (1 NCCL rank), {MAIN_N} gaussians, {FIT_RES}^2, "
              f"{FIT_SUBSTEPS} substeps, tied: single fit_frame "
              f"{singles[0]['s']:.3f} / {singles[1]['s']:.3f} s, sharded step "
              f"{sharded['s']:.3f} s, camera-DP step {camdp['s']:.3f} s, "
              f"golden redo after the forced overflow {secs_g:.3f} s "
              f"(golden graphs {redo_graph}); "
              f"single-run spread {fmt(spread)}; sharded vs single "
              f"{fmt(d_sh)} (the rows render vs the two-tier render of its "
              f"state: image {route:.3g}); camera-DP vs single {fmt(d_dp)} "
              f"(tol twice the spread plus, of each value, {MESH_FIT_REL}; "
              "the image not held); "
              f"golden redo vs sharded (not gated) {fmt(d_go)}; tied "
              f"gradient single {singles[0]['g_logE']:.6g} / "
              f"{singles[1]['g_logE']:.6g}, sharded {sharded['g_logE']:.6g},"
              f" camera-DP {camdp['g_logE']:.6g}; launches per step "
              f"{ {k: v for k, v in sharded['launches'].items() if v} }; "
              f"K4 / K5 on the rows render's {F.shape[0]} windows x K "
              f"{F.shape[2]} (caps k_row {sid.raster_cfg.k_row} / k_block "
              f"{sid.raster_cfg.k_block}): {ms4:.4f} / {ms5:.4f} ms, K4 max "
              f"err {err4:.3g} (tol 2e-3), K5 rel err {rel5:.3g} (tol "
              "1e-4)", flush=True)
        counts_all = {k: sharded["launches"][k] + camdp["launches"][k]
                      + golden["launches"][k] for k in per_step}
        return counts_all, out
    finally:
        _end_group("mesh fit")


def _eager_fit_substeps(engine, state, model, bcs, t, n_sub, grid, dt,
                        group=None):
    """sim/fitting.fit_substeps on tiled_vjp as the checkpointed
    substep_tiled_fitting(group=) loop: the sharded step's window as it
    ran before it replayed the graphs (chip_smoke puts it in
    parallel/sharded.py's namespace for the eager turns)."""
    from gsmpm_tpu_torch.sim import tiles
    from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa

    check(engine == "tiled_vjp", f"eager fit substeps: engine {engine}")
    soa, n = soa_from_state(state), state.x.shape[0]
    tc = tiles.default_tile_config(grid.n_grid, n)
    ts = tiles.bootstrap(soa, model, grid, tc)
    for _ in range(n_sub):
        ts = tiles.substep_tiled_fitting(ts, model, bcs, t, grid, tc, dt,
                                         group=group)
        t = tiles._advance(t, dt)
    soa = tiles.unpack_q(tiles.to_original_order(ts, n), soa)
    return state_from_soa(soa), t, bool(ts.ok)


def _mesh_fit_turns(sid, logE0, y0, state0, cam, target, wrappers, want):
    """Slice 11: the 1 x 1 sharded step (sid.fit_frame on its mesh) with
    the fitting window's graphs (the data group's all-reduces inside)
    against the same step on the checkpointed loop, in turns from one
    state and (logE, y) (eager, graph, eager, graph; FIT_GRAPH_FRAMES steps
    each): step seconds, exact launches, the graphs' captures / replays /
    host reads, g_logE / g_y of a graph step against an eager step's
    (FIT_GRAPH_GRAD_REL of the largest)."""
    from gsmpm_tpu_torch.parallel import sharded
    from gsmpm_tpu_torch.sim import tiles

    f = tiles.run_substeps_tiled_fitting
    real = sharded.fit_substeps

    def counters():
        return dict(captures=f.captures, replays=f.replays,
                    host_reads=f.host_reads, rebuckets=f.rebuckets)

    def step(graph):
        sid._set_params(logE0.clone(), y0.clone())
        rebuilds = sid._total_rebuilds
        if not graph:
            sharded.fit_substeps = _eager_fit_substeps
        try:
            torch.cuda.synchronize()
            _zero(wrappers)
            g0 = counters()
            t0 = time.perf_counter()
            loss, _, _, _ = sid.fit_frame(state0, 0.0, cam, target)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            sharded.fit_substeps = real
        counts = _counts(wrappers)
        g = {k: v - g0[k] for k, v in counters().items()}
        what = "graph" if graph else "eager"
        check(sid.sim_engine == "tiled_vjp" and sid.n_dropped_last == 0
              and sid._total_rebuilds == rebuilds,
              f"mesh fit {what} step: engine {sid.sim_engine}, dropped "
              f"{sid.n_dropped_last}")
        check(np.isfinite(float(loss)), f"mesh fit {what}: loss {loss}")
        check(counts == want, f"mesh fit {what} step: launches {counts}, "
                              f"expected {want}")
        if graph:
            check(g["captures"] == 0 and g["replays"] == 2 * FIT_SUBSTEPS
                  and g["host_reads"] == FIT_SUBSTEPS,
                  f"mesh fit graph step: {g}")
        else:
            check(g == dict(captures=0, replays=0, host_reads=0,
                            rebuckets=0), f"mesh fit eager step: {g}")
        grads = tuple(x.detach().clone() for x in sid.last_grads)
        return secs, g, float(loss), grads

    turns, first, total = [], {}, {}
    for name in ("eager", "graph", "eager", "graph"):
        for _ in range(FIT_GRAPH_FRAMES):
            secs, g, loss, grads = step(name == "graph")
            turns.append(dict(run=name, secs=secs, loss=loss, **g))
            first.setdefault(name, grads)
            if name == "graph":
                total = {k: total.get(k, 0) + v for k, v in want.items()}
    diffs = {}
    for key, a, b in zip(("g_logE", "g_y"), first["graph"], first["eager"]):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        diffs[key] = dict(max_abs=err, scale=scale, rel=err / scale)
        check(scale > 0 and err <= FIT_GRAPH_GRAD_REL * scale,
              f"mesh fit: {key} graph vs eager {err} (scale {scale}, rel "
              f"tol {FIT_GRAPH_GRAD_REL})")
    step_s = {n: [x["secs"] for x in turns if x["run"] == n]
              for n in ("eager", "graph")}
    # one graph step under torch.profiler: the device's busy share, the
    # largest kernels and the host's largest operators (self time)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sid._set_params(logE0.clone(), y0.clone())
    with torch.profiler.profile(activities=acts) as prof:
        sid.fit_frame(state0, 0.0, cam, target)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sorted((e for e in events if _device_us(e) > 0
                      and e.device_type != torch.autograd.DeviceType.CPU),
                     key=_device_us, reverse=True)
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    check(busy_ms > 0, "mesh fit profile: no device time")
    host = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    profile = dict(
        busy_ms=busy_ms, kernels=sum(e.count for e in kernels),
        busy_pct=100 * busy_ms / (1e3 * float(np.mean(step_s["graph"]))),
        top_kernels=[(e.key[:60], _device_us(e) / 1e3, e.count)
                     for e in kernels[:6]],
        top_host=[(e.key[:60], e.self_cpu_time_total / 1e3, e.count)
                  for e in host[:8]])
    print(f"mesh fit graph step profiled: device busy {busy_ms:.1f} ms in "
          f"{profile['kernels']} kernels = {profile['busy_pct']:.1f}% of the "
          f"turns' mean graph step; top kernels "
          + "; ".join(f"{k} {ms:.1f} ms x{n}"
                      for k, ms, n in profile["top_kernels"])
          + "; top host operators (self ms) "
          + "; ".join(f"{k} {ms:.1f} ms x{n}"
                      for k, ms, n in profile["top_host"]), flush=True)
    print(f"mesh fit graph turns (1 NCCL rank, data 1 x tile 1), "
          f"{MAIN_N} gaussians, {FIT_RES}^2, {FIT_SUBSTEPS} substeps, turns "
          f"of {FIT_GRAPH_FRAMES} steps: eager "
          f"{[round(x, 4) for x in step_s['eager']]} s, graph "
          f"{[round(x, 4) for x in step_s['graph']]} s; per graph step "
          f"{FIT_SUBSTEPS} host reads, {2 * FIT_SUBSTEPS} replays, 0 "
          f"captures; launches per step (both) "
          f"{ {k: v for k, v in want.items() if v} }; graph vs eager "
          f"g_logE rel {diffs['g_logE']['rel']:.3g}, g_y rel "
          f"{diffs['g_y']['rel']:.3g} (tol {FIT_GRAPH_GRAD_REL})",
          flush=True)
    return dict(turns=turns, step_s=step_s, grad_diff=diffs,
                profile=profile, launches=total)


def _end_group(what: str) -> None:
    """The process group's cached graphs freed, then the group destroyed;
    the seconds of each printed."""
    import torch.distributed as dist

    from gsmpm_tpu_torch.sim import tiles

    t0 = time.perf_counter()
    n = tiles._drop_group_graphs()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dist.destroy_process_group()
    t2 = time.perf_counter()
    print(f"{what}: released {n} cached graph set(s) of the process group "
          f"({t1 - t0:.3f} s), then destroyed it ({t2 - t1:.3f} s)",
          flush=True)


# ---------------------------------------------------------------------------
# slice 4: the golden route, checkpoint / resume, the one-rank mesh
# ---------------------------------------------------------------------------

def _zero(wrappers):
    for w in wrappers:
        w.launches = 0


def _counts(wrappers):
    return {w.__name__: w.launches for w in wrappers}


def _golden_graph_counts():
    """sim/solver.run_substeps's captures and replays: the golden engine's
    CUDA graphs (slice 12)."""
    from gsmpm_tpu_torch.sim import solver

    f = solver.run_substeps
    return dict(captures=f.captures, replays=f.replays)


def _golden_graph_delta(before):
    return {k: v - before[k] for k, v in _golden_graph_counts().items()}


def _check_frames(frames, n, stats, what):
    check(len(frames) == n + 1, f"{what}: {len(frames)} frames")
    for f in frames:
        check(f.shape == (MAIN_RES, MAIN_RES, 3), f"{what}: shape {f.shape}")
        check(bool(np.isfinite(f).all()), f"{what}: non-finite frame")
    check(all(d == 0 for d in stats["n_dropped"]),
          f"{what}: n_dropped {stats['n_dropped']}")
    motion = float(np.abs(frames[-1] - frames[0]).max())
    check(motion > 1e-3, f"{what}: no motion ({motion})")
    return motion


def pushed_config(dev, output_path: str):
    """The main path's configuration with an impulse along +y for its first
    5 substeps, sized from the mean particle mass to throw the box at
    ~PUSH_SPEED m/s: its particles drift into tiles that were empty at
    bootstrap within the first frame.  Returns (config, boot occupancy,
    the prepared SimSetup)."""
    from gsmpm_tpu_torch.apps.simulate import prepare
    from gsmpm_tpu_torch.config import BoundaryConditionConfig
    from gsmpm_tpu_torch.sim import tiles
    from gsmpm_tpu_torch.sim.kernels import soa_from_state

    cfg = bench_config(output_path=output_path)
    su = prepare(cfg, synthetic=MAIN_N, synthetic_res=MAIN_RES,
                 device=str(dev), quiet=True)
    ts = tiles.bootstrap(soa_from_state(su.state), su.model, su.grid, su.tc)
    occ = int(torch.unique(ts.chunk_tile[ts.chunk_live == 1]).numel())
    force = float(su.state.mass.mean()) * PUSH_SPEED / (5 * cfg.mpm.substep_dt)
    bc = BoundaryConditionConfig(type="impulse", center=[1.0, 1.0, 1.0],
                                 size=[1.0, 1.0, 1.0], force=[0.0, force, 0.0],
                                 start_time=0.0, num_dt=5)
    cfg.mpm.boundary_conditions = [bc]
    return cfg, occ, su


def golden_route_phase(dev, wrappers):
    """apps.simulate's route to the golden engine at the main path's width:
    incremental_cov (golden for every frame), a tile cap below the
    bootstrap occupancy, and a cap at it with the box pushed into new tiles
    (the overflow comes at a rebucket inside frame 1, whose tiled
    substeps are then redone on the golden engine).  The cap is set by
    replacing the app's default_tile_config for the run.  Every frame
    written, n_dropped 0, motion, the route seen in stats["engine"] and in
    the launches; the redone frame 1's state (its checkpoint) held to the
    one the golden engine reaches from the start, beside a rerun of that
    run (the float atomics' spread)."""
    import shutil

    from gsmpm_tpu_torch.apps import simulate as sim_app
    from gsmpm_tpu_torch.io.checkpoint import restore_checkpoint

    inc = bench_config(output_path=str(OUT_DIR / "golden_inc"))
    inc.mpm.incremental_cov = True
    pushed, occ, su = pushed_config(dev, str(OUT_DIR / "golden_boot"))
    mid = pushed_config(dev, str(OUT_DIR / "golden_mid"))[0]
    again = pushed_config(dev, str(OUT_DIR / "golden_boot_again"))[0]
    cases = (("incremental_cov", inc, None, 1),
             ("boot_overflow", pushed, occ - 1, 1),
             ("boot_overflow_again", again, occ - 1, 1),
             ("mid_frame_overflow", mid, occ, 2))
    default_tc = sim_app.default_tile_config
    out, frames_by, total = {}, {}, {}
    for name, cfg, cap, n in cases:
        shutil.rmtree(cfg.render.output_path, ignore_errors=True)
        if cap is not None:
            sim_app.default_tile_config = (
                lambda g, m, cap=cap: default_tc(g, m)._replace(n_occ_cap=cap))
        stats = {}
        _zero(wrappers)
        g0 = _golden_graph_counts()
        t0 = time.perf_counter()
        try:
            frames = sim_app.simulate(
                cfg, synthetic=MAIN_N, frames=n, quiet=True,
                synthetic_res=MAIN_RES, device=str(dev), stats=stats,
                checkpoint_interval=0 if cap is None else 1)
        finally:
            sim_app.default_tile_config = default_tc
        wall = time.perf_counter() - t0
        counts = _counts(wrappers)
        graph = _golden_graph_delta(g0)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        motion = _check_frames(frames, n, stats, name)
        check(stats["engine"] == ["golden"] * n,
              f"{name}: engines {stats['engine']}")
        k1, k2 = counts["p2g_tiled"], counts["g2p_tiled"]
        steps = stats["substeps_per_frame"]
        if name == "mid_frame_overflow":
            # frame 1 ran its substeps on the tiled engine (whose frame
            # reports the overflow at its end), then again on golden
            check(k1 == k2 == steps, f"{name}: K1/K2 launches {k1}/{k2}")
        else:
            check(k1 == k2 == 0, f"{name}: K1/K2 launches {k1}/{k2}")
        # every golden substep of the run replays the golden graph of its
        # model (slice 12), captured at its first
        check(graph == dict(captures=1, replays=n * steps - 1),
              f"{name}: golden graph counters {graph}")
        check(counts["stream_blend"] >= n + 1,
              f"{name}: K3 launches {counts['stream_blend']}")
        sps = n * steps / sum(stats["sim_s"])
        frames_by[name] = frames
        out[name] = dict(frames=n, wall_s=wall, substeps_per_s=sps,
                         sim_s=stats["sim_s"], render_s=stats["render_s"],
                         engine=stats["engine"], motion=motion,
                         tiled_substeps=k1, cap=cap, golden_graph=graph)
        print(f"golden route ({name}): {n} frame(s) x {steps} substeps, "
              f"engines {stats['engine']}, {sps:.2f} substeps/s (sim "
              f"{['%.3f' % t for t in stats['sim_s']]} s), render "
              f"{['%.1f' % (1e3 * t) for t in stats['render_s']]} ms, "
              f"tiled substeps (abandoned) {k1}, golden graph {graph}, "
              f"motion {motion:.3g}, wall {wall:.1f} s", flush=True)
    # the overflow runs take frame 1 on the golden engine from the same
    # start state: only index_add_'s float atomics differ, whose spread the
    # boot case run twice shows.  The state carries the gate (the CPU
    # tests' tolerance, GOLDEN_RTOL of each field's max); a redo from the
    # abandoned tiled state would be a frame of motion off.  The images
    # are held by their mean: the same state differences move a few pixels
    # by up to a few hundredths.
    s_mid, s_boot, s_again = (
        restore_checkpoint(str(OUT_DIR / d / "checkpoints"),
                           (su.state, su.model, 0.0), step=1)[0]
        for d in ("golden_mid", "golden_boot", "golden_boot_again"))
    check(s_mid[2] == s_boot[2] == s_again[2],
          f"golden route: clocks {s_mid[2]}, {s_boot[2]}, {s_again[2]}")
    err_state = _rel_errs(s_mid[0], s_boot[0])
    spread_state = _rel_errs(s_again[0], s_boot[0])
    boot1 = frames_by["boot_overflow"][1]
    diff = np.abs(frames_by["mid_frame_overflow"][1] - boot1)
    spread = np.abs(frames_by["boot_overflow_again"][1] - boot1)
    redo, redo_mean = float(diff.max()), float(diff.mean())

    def listed(errs):
        return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())

    print(f"golden route: boot occupancy {occ} tiles; frame 1 redone after "
          f"a mid-frame overflow vs golden from the start: state relative "
          f"err {listed(err_state)} (tol {listed(GOLDEN_RTOL)}), image mean "
          f"diff {redo_mean:.3g} (tol 1e-5), max {redo:.3g}, pixels over "
          f"1e-2 {int((diff.max(-1) > 1e-2).sum())}; golden from the start "
          f"run twice: state {listed(spread_state)}, image mean "
          f"{float(spread.mean()):.3g}, max {float(spread.max()):.3g}, "
          f"pixels over 1e-2 {int((spread.max(-1) > 1e-2).sum())}",
          flush=True)
    check(all(err_state[f] <= GOLDEN_RTOL[f] for f in err_state),
          f"golden route: redone frame 1 state differs by {err_state}")
    check(redo_mean <= 1e-5,
          f"golden route: redone frame 1 differs by {redo_mean} (mean)")
    out.update(redo_vs_boot_max_diff=redo, redo_vs_boot_mean_diff=redo_mean,
               redo_vs_boot_state_rel_err=err_state,
               rerun_state_rel_err=spread_state,
               rerun_max_diff=float(spread.max()),
               rerun_mean_diff=float(spread.mean()))
    return total, out


def resume_phase(dev, wrappers):
    """--checkpoint_interval / --resume on the card: 2 frames in one run
    (twice: the float atomics' run-to-run spread) against 1 frame +
    checkpoint, then a resumed run to frame 2.  The resumed run draws
    frame 1 again from the restored state, bit-equal to the frame the
    interrupted run wrote; its frame-2 checkpoint is held to the
    uninterrupted run's at the CPU test's tolerance (1e-5, here relative
    to each field's max), its frame 2 image by the mean (1e-5; the float
    atomics can swap a few tied splats, as in the golden-route phase)."""
    import shutil

    from gsmpm_tpu_torch.apps.simulate import simulate
    from gsmpm_tpu_torch.io.checkpoint import restore_checkpoint

    runs = {}
    for name in ("resume_once", "resume_again", "resume_split"):
        shutil.rmtree(OUT_DIR / name, ignore_errors=True)
        runs[name] = bench_config(output_path=str(OUT_DIR / name))
    once, again = (simulate(runs[name], synthetic=MAIN_N, frames=2,
                            quiet=True, synthetic_res=MAIN_RES,
                            device=str(dev), checkpoint_interval=1)
                   for name in ("resume_once", "resume_again"))
    split = simulate(runs["resume_split"], synthetic=MAIN_N, frames=1,
                     quiet=True, synthetic_res=MAIN_RES, device=str(dev),
                     checkpoint_interval=1)
    stats = {}
    _zero(wrappers)
    t0 = time.perf_counter()
    resumed = simulate(runs["resume_split"], synthetic=MAIN_N, frames=2,
                       quiet=True, synthetic_res=MAIN_RES, device=str(dev),
                       stats=stats, resume=True, checkpoint_interval=1)
    wall = time.perf_counter() - t0
    counts = _counts(wrappers)
    steps = stats["substeps_per_frame"]
    check(len(resumed) == 2, f"resume: {len(resumed)} frames")
    check(stats["engine"] == ["tiled"], f"resume: engines {stats['engine']}")
    check(counts["p2g_tiled"] == counts["g2p_tiled"] == steps,
          f"resume: transfer launches {counts}")
    redraw = bool(np.array_equal(resumed[0], split[1]))
    check(redraw, "resume: frame 1 from the restored state differs")
    su = prepare_main(dev)

    def frame2_state(name):
        (st, _, t), step, _ = restore_checkpoint(
            str(OUT_DIR / name / "checkpoints"), (su.state, su.model, 0.0))
        check(step == 2, f"resume: {name} checkpoint step {step}")
        return st, t

    (s_once, t_once), (s_again, _), (s_res, t_res) = (
        frame2_state(n) for n in ("resume_once", "resume_again",
                                  "resume_split"))
    check(t_res == t_once, f"resume: clock {t_res} vs {t_once}")
    err_state = _rel_errs(s_res, s_once)
    spread_state = _rel_errs(s_again, s_once)
    err = float(np.abs(resumed[1] - once[2]).max())
    err_mean = float(np.abs(resumed[1] - once[2]).mean())
    spread = float(np.abs(again[2] - once[2]).max())
    print(f"resume: frame 1 redrawn from the checkpoint bit-equal "
          f"{redraw}; frame 2 vs the uninterrupted run: state relative err "
          + ", ".join(f"{k} {v:.3g}" for k, v in err_state.items())
          + f" (tol 1e-5), image mean diff {err_mean:.3g} (tol 1e-5), max "
          f"{err:.3g}; a rerun of "
          "the uninterrupted run: state "
          + ", ".join(f"{k} {v:.3g}" for k, v in spread_state.items())
          + f", image {spread:.3g}; {steps / stats['sim_s'][0]:.2f} "
          f"substeps/s, wall {wall:.1f} s", flush=True)
    check(max(err_state.values()) <= 1e-5,
          f"resume: frame 2 state differs by {err_state}")
    check(err_mean <= 1e-5, f"resume: frame 2 image differs by {err_mean}")
    return counts, dict(wall_s=wall, substeps_per_s=steps / stats["sim_s"][0],
                        frame2_max_diff=err, frame2_mean_diff=err_mean,
                        rerun_max_diff=spread,
                        frame2_state_rel_err=err_state,
                        rerun_state_rel_err=spread_state,
                        redraw_bit_equal=redraw)


def prepare_main(dev):
    """apps.simulate.prepare at the main path's configuration."""
    from gsmpm_tpu_torch.apps.simulate import prepare

    return prepare(bench_config(), synthetic=MAIN_N, synthetic_res=MAIN_RES,
                   device=str(dev), quiet=True)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel_errs(got, want, fields=("x", "v", "F", "F_trial", "C")):
    return {f: float((getattr(got, f) - getattr(want, f)).abs().max())
            / max(1.0, float(getattr(want, f).abs().max())) for f in fields}


def mesh_phase(dev, wrappers):
    """parallel/ on a one-rank NCCL group built in this process: the
    MeshSimEngine's tiled frame (K1 / K2 per rank, the grid all-reduced)
    and psum frame against the single-device tiled and golden frames,
    the mesh render (render_block_rows, K4) against K4's twin blending the
    same windows (the stream render of the same state beside it), and K1,
    K2, K4 against their twins on the mesh path's inputs.  K1 / K2
    launches are exact per substep.  The tiled frame replays its captured
    substep; slice 11's turns (``_mesh_graph_turns``) hold it against the
    eager segment loop."""
    import os

    import torch.distributed as dist

    from gsmpm_tpu_torch.apps.simulate import prepare
    from gsmpm_tpu_torch.parallel.engines import (
        MeshSimEngine, make_mesh_render_fn,
    )
    from gsmpm_tpu_torch.parallel.mesh import make_mesh, pad_particles, shard
    from gsmpm_tpu_torch.render import cuda_blend as cb
    from gsmpm_tpu_torch.render.renderer import (
        RasterConfig, assemble_blocks, block_origins, block_rows_candidates,
        bump_caps_for_dropfree, preprocess, render_with_aux,
    )
    from gsmpm_tpu_torch.sim import cuda_mpm, tiles
    from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa
    from gsmpm_tpu_torch.sim.solver import postprocess, run_substeps

    laps = [time.perf_counter()]

    def lap():  # seconds since the previous lap
        laps.append(time.perf_counter())
        return laps[-1] - laps[-2]

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        mesh = make_mesh((("data", 1),), "cuda")
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        cfg = bench_config(output_path=str(OUT_DIR / "mesh"))
        dt, steps = cfg.mpm.substep_dt, cfg.mpm.steps_per_frame
        su = prepare(cfg, synthetic=MAIN_N, synthetic_res=MAIN_RES,
                     device=str(dev), quiet=True)
        st0, md0, _, _ = pad_particles(su.state, su.model, mesh.world_size)
        st0, md0 = shard((st0, md0), mesh)
        out, engines = {}, {}
        for engine in ("tiled", "psum"):
            eng = MeshSimEngine(mesh, bcs=su.bcs, grid=su.grid,
                                substep_dt=dt, n_steps=steps, prefer=engine)
            _zero(wrappers)
            g0 = _golden_graph_counts()
            t0 = time.perf_counter()
            st, t, _ = eng.frame(st0, md0, 0.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts(wrappers)
            g = _golden_graph_delta(g0)
            check(eng.engine == engine, f"mesh {engine}: fell back")
            want = steps if engine == "tiled" else 0
            check(counts["p2g_tiled"] == counts["g2p_tiled"] == want,
                  f"mesh {engine}: transfer launches {counts}")
            # the psum frame replays the golden graph, the grid's NCCL
            # all-reduce inside (slice 12)
            want_g = (dict(captures=1, replays=steps - 1)
                      if engine == "psum" else dict(captures=0, replays=0))
            check(g == want_g, f"mesh {engine}: golden graph counters {g}")
            engines[engine] = (eng, st, counts)
            out[engine] = dict(frame_s=wall, substeps_per_s=steps / wall,
                               launches=counts, golden_graph=g)
        laps_s = dict(engines=lap())
        # the single-device frames from the same start state
        ts = tiles.bootstrap(soa_from_state(su.state), su.model, su.grid,
                             su.tc)
        ts, soa, _ = tiles.frame_tiled(ts, soa_from_state(su.state),
                                       su.model, su.bcs, 0.0, steps, su.grid,
                                       su.tc, dt)
        single_tiled = state_from_soa(soa)
        golden, _ = run_substeps(su.state, su.model, su.bcs, 0.0, steps,
                                 su.grid, dt, checkpoint_policy=None)
        golden = dataclasses.replace(golden, cov=postprocess(golden)[0])
        for engine, want in (("tiled", single_tiled), ("psum", golden)):
            errs = _rel_errs(engines[engine][1], want)
            out[engine]["rel_err_vs_single"] = errs
            # float atomics (K1, index_add_) over 100 substeps
            check(max(errs.values()) <= 1e-4,
                  f"mesh {engine} vs single device: {errs}")
            print(f"mesh ({engine}, 1 NCCL rank): 1 frame x {steps} "
                  f"substeps in {out[engine]['frame_s']:.3f} s "
                  f"({out[engine]['substeps_per_s']:.2f} substeps/s), "
                  f"launches K1 {engines[engine][2]['p2g_tiled']} K2 "
                  f"{engines[engine][2]['g2p_tiled']}; relative err vs the "
                  "single-device frame " + ", ".join(
                      f"{k} {v:.3g}" for k, v in errs.items())
                  + " (tol 1e-4)", flush=True)

        # slice 11: the tiled engine's frame (its captured substep) against
        # the eager segment loop it replaced
        laps_s["single"] = lap()
        eng_t, st_t, _ = engines["tiled"]
        out["tiled"]["graph_turns"] = _mesh_graph_turns(
            mesh, eng_t, st0, md0, su, wrappers)
        laps_s["graph_turns"] = lap()

        # K1 / K2 against their twins on the rank's chunks after the frame,
        # given seeded motion (the falling box's C is ~1e-6: every term of
        # the transfers must count)
        ts_loc = seeded_motion(eng_t._tiled[2])
        tc = eng_t._tiled[1]
        ts_loc, sig = tiles.particle_phase(ts_loc, md0, su.bcs, 0.0, dt)
        win_k = cuda_mpm.p2g_tiled(ts_loc, sig, su.grid, tc, dt)
        win_r = cuda_mpm.p2g_tiled_ref(ts_loc, sig, su.grid, tc, dt)
        rel1 = float((window_components(win_k - win_r).abs().amax(dim=1)
                      / window_components(win_r).abs().amax(dim=1)).max())
        ext = tiles.grid_phase(win_k, su.model, su.bcs, 0.0, su.grid, tc, dt,
                               mesh.group)
        q_k = cuda_mpm.g2p_tiled(ts_loc, ext, su.grid, tc, dt)
        q_r = cuda_mpm.g2p_tiled_ref(ts_loc, ext, su.grid, tc, dt)
        rel2 = max(float((q_k[r0:r0 + n] - q_r[r0:r0 + n]).abs().max())
                   / float(q_r[r0:r0 + n].abs().max())
                   for r0, n in ((tiles.RX, 3), (tiles.RV, 3), (tiles.RC, 9),
                                 (tiles.RFT, 9)))
        check(rel1 <= 1e-5, f"mesh K1: relative err {rel1}")
        check(rel2 <= 1e-5, f"mesh K2: relative err {rel2}")

        # the tile-sharded render, drop-free caps, then K4 on its windows
        def splats(x, cov, R, opac, feats):
            return (*su.world(x, cov), opac, feats)

        rcfg, renders, nd = RasterConfig(), 0, None
        _zero(wrappers)
        for _ in range(7):
            render = make_mesh_render_fn(
                mesh, camera=su.camera, bg=su.bg,
                sh_degree=su.scene.sh_degree, rcfg=rcfg, transform_fn=splats)
            img, nd = render(st_t.x, st_t.cov, None, su.opacity, su.features)
            renders += 1
            if int(nd) == 0:
                break
            rcfg = bump_caps_for_dropfree(rcfg, *su.world(st_t.x, st_t.cov),
                                          su.opacity, su.camera)
        k4_launches = _counts(wrappers)["blend_fwd"]
        check(int(nd) == 0, f"mesh render: n_dropped {int(nd)}")
        check(k4_launches == renders, f"mesh render: K4 launches "
                                      f"{k4_launches} for {renders} renders")
        render_ms = cuda_ms(lambda: render(st_t.x, st_t.cov, None,
                                           su.opacity, su.features), 3, 1)
        stream = RasterConfig(stream=True)
        w_xyz, w_cov = su.world(st_t.x, st_t.cov)
        for _ in range(7):  # the stream render at drop-free budgets
            ref_img, snd = render_with_aux(w_xyz, w_cov, su.opacity,
                                           su.features, su.camera, su.bg,
                                           su.scene.sh_degree, stream)
            if int(snd) == 0:
                break
            stream = bump_caps_for_dropfree(stream, w_xyz, w_cov, su.opacity,
                                            su.camera)
        check(int(snd) == 0, f"mesh: stream render n_dropped {int(snd)}")
        # not gated: the stream render orders each tile's splats by a
        # quantized depth, the two-stage selection by the exact depth
        stream_diff = (img - ref_img).abs()
        pre = preprocess(w_xyz, w_cov, su.opacity, su.features, su.camera,
                         su.scene.sh_degree, rcfg)
        order = torch.sort(torch.where(pre.valid, pre.depth, torch.inf),
                           stable=True).indices
        _, nbx, nby = block_origins(su.camera, rcfg)
        cand, counts, origins = block_rows_candidates(pre, order, 0.0, nby,
                                                      nbx, rcfg)
        F, counts, meta = cb.blend_inputs(cand, counts, origins, rcfg)
        out_k = cb.blend_fwd(counts, F, meta)
        out_r = cb.blend_core_ref(counts, F, meta)
        torch.cuda.synchronize()
        err4 = float((out_k[:, 0:4] - out_r[:, 0:4]).abs().max())
        done4 = float((out_k[:, 4] != out_r[:, 4]).float().mean())
        # the mesh render's image against the K4 twin's blend of the same
        # windows (both through the app's background composite)
        rgb_r = out_r[:, 0:3] + out_r[:, 3:4] * su.bg[None, :, None]
        twin_img = assemble_blocks(rgb_r.reshape(-1, 3, rcfg.block, rcfg.block)
                                   .permute(0, 2, 3, 1), su.camera, rcfg)
        img_err = float((img - twin_img).abs().max())
        check(img_err <= 2e-3, f"mesh render vs K4's twin: {img_err}")
        check(err4 <= 2e-3, f"mesh K4: max err {err4}")
        check(done4 <= 1e-4, f"mesh K4: done flags differ {done4}")
        ms4 = cuda_ms(lambda: cb.blend_fwd(counts, F, meta), 5)
        laps_s["twins_render"] = lap()
        out["laps_s"] = laps_s
        print("mesh phase laps (s): " + ", ".join(
            f"{k} {v:.1f}" for k, v in laps_s.items()), flush=True)
        out["render"] = dict(render_ms=render_ms, renders=renders,
                             k_row=rcfg.k_row, k_block=rcfg.k_block,
                             K=int(F.shape[2]), img_err_vs_twin=img_err,
                             stream_max_diff=float(stream_diff.max()),
                             stream_mean_diff=float(stream_diff.mean()),
                             stream_pixels_over_1e2=int(
                                 (stream_diff.amax(-1) > 1e-2).sum()),
                             k4_ms=ms4, k4_err=err4, k4_done_diff=done4,
                             k1_rel_err=rel1, k2_rel_err=rel2)
        print(f"mesh render (1 NCCL rank): {renders} render(s) to drop-free "
              f"caps k_row {rcfg.k_row} / k_block {rcfg.k_block}, "
              f"{render_ms:.2f} ms a render, K4 launches {k4_launches}; vs "
              f"K4's twin max diff {img_err:.3g} (tol 2e-3); vs the stream "
              f"render of the same state (not gated) max "
              f"{float(stream_diff.max()):.3g}, mean "
              f"{float(stream_diff.mean()):.3g}; K4 on "
              f"its {F.shape[0]} windows x K {F.shape[2]}: {ms4:.4f} ms, max "
              f"err {err4:.3g}, done differ {done4:.3g}; K1 / K2 on the "
              f"rank's chunks: relative err {rel1:.3g} / {rel2:.3g} (tol "
              "1e-5)", flush=True)
        counts_all = {k: max(out["tiled"]["launches"][k],
                             out["psum"]["launches"][k])
                      for k in out["tiled"]["launches"]}
        counts_all["blend_fwd"] = k4_launches
        return counts_all, out
    finally:
        _end_group("mesh")


MESH_GRAPH_FRAMES = 2


def _mesh_eager_frame(mesh, ts, t, model, bcs, grid, tc, dt, steps, seg):
    """parallel/tiled_sharded.py's frame as the eager loop it ran before it
    replayed the substep graph: per segment the gathered rebucket, seg
    substep_tiled(group=) substeps, the hard-drift flag; then the
    replicated original-order rows.  Returns (ts, q, t)."""
    import torch.distributed as dist

    from gsmpm_tpu_torch.parallel.tiled_sharded import (
        _hard_drift, gather_tiled, shard_tiled,
    )
    from gsmpm_tpu_torch.sim import tiles

    ok = ts.ok
    for _ in range(steps // seg):
        ts = shard_tiled(tiles.rebucket(gather_tiled(ts, mesh), grid, tc),
                         mesh, tc)
        ok = ok & ts.ok
        for _ in range(seg):
            ts = tiles.substep_tiled(ts, model, bcs, t, grid, tc, dt,
                                     group=mesh.group,
                                     rebucket_on_drift=False)
            t = tiles._advance(t, dt)
        bad = _hard_drift(ts.q, grid, tc, ts.chunk_tile).to(torch.int32)
        dist.all_reduce(bad.reshape(1), op=dist.ReduceOp.MAX,
                        group=mesh.group)
        ok = ok & (bad == 0)
    ts = dataclasses.replace(ts, ok=ok)
    q = tiles.to_original_order(ts, tc.n_particles).contiguous()
    dist.all_reduce(q, group=mesh.group)
    return ts, q, t


def _mesh_graph_turns(mesh, eng, st0, md0, su, wrappers):
    """Slice 11: the MeshSimEngine's tiled frame function (segments of the
    captured substep, the grid's NCCL all-reduce inside; its graph was
    captured by the engine's frame) against the eager segment loop, in
    turns from one state (eager, graph, eager, graph; MESH_GRAPH_FRAMES
    frames each): substeps/s, K1 / K2 exactly one a substep, captures /
    replays / host reads per frame, each field's relative difference
    (SOLVER_RTOL), the device busy share of one profiled graph frame."""
    from gsmpm_tpu_torch.parallel.engines import _largest_divisor_leq
    from gsmpm_tpu_torch.parallel.tiled_sharded import shard_tiled
    from gsmpm_tpu_torch.sim import tiles
    from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa

    start = time.perf_counter()
    fn, tc, _ = eng._tiled
    steps, dt = eng.n_steps, eng.dt
    seg = _largest_divisor_leq(steps, 10)  # the engine's rebucket_every
    ts0 = shard_tiled(tiles.bootstrap(soa_from_state(st0), md0, su.grid, tc),
                      mesh, tc)
    soa0 = soa_from_state(st0)
    f = tiles.frame_tiled

    def counters():
        return dict(captures=f.captures, replays=f.replays,
                    host_reads=f.host_reads, rebuckets=f.rebuckets)

    def graph(n_frames):
        ts, t = ts0, 0.0
        for _ in range(n_frames):
            ts, q, t = fn(ts, t)
        return ts, q, t

    def eager(n_frames):
        ts, t = ts0, 0.0
        for _ in range(n_frames):
            ts, q, t = _mesh_eager_frame(mesh, ts, t, md0, su.bcs, su.grid,
                                         tc, dt, steps, seg)
        return ts, q, t

    turns, results, total = [], {}, {}
    for name in ("eager", "graph", "eager", "graph"):
        torch.cuda.synchronize()
        _zero(wrappers)
        g0 = counters()
        t0 = time.perf_counter()
        ts, q, t = (graph if name == "graph" else eager)(MESH_GRAPH_FRAMES)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts(wrappers)
        g = {k: v - g0[k] for k, v in counters().items()}
        want = MESH_GRAPH_FRAMES * steps
        check(bool(ts.ok), f"mesh graph turns {name}: not ok")
        check(counts["p2g_tiled"] == counts["g2p_tiled"] == want,
              f"mesh graph turns {name}: launches {counts}, expected {want}")
        if name == "graph":
            check(g == dict(captures=0, replays=want, host_reads=0,
                            rebuckets=0), f"mesh graph turns: {g}")
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
        else:
            check(g == dict(captures=0, replays=0, host_reads=0,
                            rebuckets=0), f"mesh eager turns: {g}")
        turns.append(dict(run=name, secs=secs, substeps_per_s=want / secs,
                          k1=counts["p2g_tiled"], k2=counts["g2p_tiled"],
                          **g))
        results.setdefault(name, (q, t))
    (q_e, t_e), (q_g, t_g) = results["eager"], results["graph"]
    check(t_e == t_g, f"mesh graph turns: clocks {t_e} vs {t_g}")
    entry = next(e for e in tiles._GRAPHS.values() if e.group is mesh.group)
    check(entry.clock.cpu().numpy().view(np.uint32)
          == np.float32(t_g).view(np.uint32),
          f"mesh graph: device clock {float(entry.clock)} vs host {t_g}")
    rel = _rel_errs(state_from_soa(tiles.unpack_q(q_g, soa0)),
                    state_from_soa(tiles.unpack_q(q_e, soa0)))
    check(max(rel.values()) <= SOLVER_RTOL,
          f"mesh graph vs eager segments: {rel} (tol {SOLVER_RTOL})")
    frame_ms = {n: 1e3 * float(np.mean([x["secs"] for x in turns
                                        if x["run"] == n])) / MESH_GRAPH_FRAMES
                for n in ("eager", "graph")}
    busy_ms, n_kernels = _profiled_busy_ms(lambda: graph(1))
    busy = dict(busy_ms=busy_ms, kernels=n_kernels,
                busy_pct=100 * busy_ms / frame_ms["graph"])
    sps = {n: [round(x["substeps_per_s"], 2) for x in turns if x["run"] == n]
           for n in ("eager", "graph")}
    print(f"mesh graph turns (tiled, 1 NCCL rank): {MAIN_N} gaussians, "
          f"n_grid {su.grid.n_grid}, turns of {MESH_GRAPH_FRAMES} frames x "
          f"{steps} substeps (segments of {seg}): eager {sps['eager']} "
          f"substeps/s, graph {sps['graph']}; per graph frame 0 captures, "
          f"{steps} replays, 0 host reads, {steps // seg} gathered "
          f"rebuckets, K1/K2 {steps}/{steps}; graph vs eager rel "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
          + f" (tol {SOLVER_RTOL}); device busy (torch.profiler, one graph "
          f"frame) {busy_ms:.1f} ms in {n_kernels} kernels = "
          f"{busy['busy_pct']:.1f}% of {frame_ms['graph']:.1f} ms (eager "
          f"frame {frame_ms['eager']:.1f} ms); the turns and the profile "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    return dict(turns=turns, substeps_per_s=sps, frame_ms=frame_ms,
                rel_err=rel, busy=busy, segment=seg, launches=total)



def halo_phase(dev, wrappers):
    """The halo engines (slice 6) on a one-rank NCCL group of their own, at
    the bench's secondary shape: 245,760 gaussians on the 100^3 grid, 100
    substeps a frame.  One MeshSimEngine frame each of halo, halo_tiled
    and halo_tiled2d (1 x 1): no fallback, K1 / K2 launches exact (100
    each for the tiled pair, 0 for halo), 0 bytes through the neighbour
    exchange on one rank, the frame within 1e-4 of each field's max of the
    single-device frame from the same state (tiles.frame_tiled, or golden
    run_substeps for halo); auto-selection picks tiled (the port's CUDA
    order, ROADMAP C); K1 and K2 against their twins on the halo_tiled
    path's inputs.  It renders nothing: the frame a halo engine returns
    goes through the same tile-sharded mesh render (render_block_rows, K4)
    that mesh_phase holds against K4's twin."""
    import os

    import torch.distributed as dist

    from gsmpm_tpu_torch.apps.simulate import prepare
    from gsmpm_tpu_torch.parallel import mesh as pmesh
    from gsmpm_tpu_torch.parallel.engines import MeshSimEngine
    from gsmpm_tpu_torch.parallel.halo_tiled import _exchange_accum_tiles, \
        _exchange_edges_tiles
    from gsmpm_tpu_torch.sim import cuda_mpm, tiles
    from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa
    from gsmpm_tpu_torch.sim.solver import postprocess, run_substeps

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh((("data", 1),), "cuda")
        cfg = bench_config(n_grid=100, output_path=str(OUT_DIR / "halo"))
        dt, steps = cfg.mpm.substep_dt, cfg.mpm.steps_per_frame
        su = prepare(cfg, synthetic=MAIN_N, synthetic_res=MAIN_RES,
                     device=str(dev), quiet=True)
        st0, md0 = pmesh.shard((su.state, su.model), mesh)
        auto = MeshSimEngine(mesh, bcs=su.bcs, grid=su.grid, substep_dt=dt,
                             n_steps=steps, state=st0).engine
        check(auto == "tiled", f"halo: auto-selection picked {auto}")
        out, engines = dict(auto=auto), {}
        for engine in ("halo", "halo_tiled", "halo_tiled2d"):
            eng = MeshSimEngine(mesh, bcs=su.bcs, grid=su.grid,
                                substep_dt=dt, n_steps=steps, prefer=engine,
                                state=st0)
            _zero(wrappers)
            pmesh.neighbor_ppermute.bytes_sent = 0
            t0 = time.perf_counter()
            st, _, _ = eng.frame(st0, md0, 0.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts(wrappers)
            sent = pmesh.neighbor_ppermute.bytes_sent
            check(eng.engine == engine, f"halo {engine}: fell back")
            want = 0 if engine == "halo" else steps
            check(counts["p2g_tiled"] == counts["g2p_tiled"] == want,
                  f"halo {engine}: transfer launches {counts}")
            check(sent == 0, f"halo {engine}: {sent} bytes sent on one rank")
            engines[engine] = (eng, st)
            out[engine] = dict(frame_s=wall, substeps_per_s=steps / wall,
                               launches=counts, bytes_sent=sent,
                               geometry=str(eng._geometry[:-1]))
        ts = tiles.bootstrap(soa_from_state(su.state), su.model, su.grid,
                             su.tc)
        ts, soa, _ = tiles.frame_tiled(ts, soa_from_state(su.state),
                                       su.model, su.bcs, 0.0, steps, su.grid,
                                       su.tc, dt)
        check(bool(ts.ok), "halo: the single-device tiled frame overflowed")
        single_tiled = state_from_soa(soa)
        golden, _ = run_substeps(su.state, su.model, su.bcs, 0.0, steps,
                                 su.grid, dt, checkpoint_policy=None)
        golden = dataclasses.replace(golden, cov=postprocess(golden)[0])
        for engine, (_, st) in engines.items():
            errs = _rel_errs(st, golden if engine == "halo" else single_tiled)
            out[engine]["rel_err_vs_single"] = errs
            check(max(errs.values()) <= 1e-4,
                  f"halo {engine} vs single device: {errs}")
            o = out[engine]
            print(f"halo ({engine}, 1 NCCL rank, n_grid 100): 1 frame x "
                  f"{steps} substeps in {o['frame_s']:.3f} s "
                  f"({o['substeps_per_s']:.2f} substeps/s), launches K1 "
                  f"{o['launches']['p2g_tiled']} K2 "
                  f"{o['launches']['g2p_tiled']}, bytes sent {o['bytes_sent']}"
                  f"; relative err vs the single-device "
                  f"{'golden' if engine == 'halo' else 'tiled'} frame "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + f" (tol 1e-4); {o['geometry']}", flush=True)

        # K1 / K2 against their twins on the halo_tiled path's inputs: the
        # rank's slots after the frame, bucketed as a segment buckets them,
        # given seeded motion, through the grid phase with the halo hooks
        eng = engines["halo_tiled"][0]
        soa, aux, mat, _ = eng._halo[1]
        tstarts, _, tc = eng._geometry[:3]
        model_l = dataclasses.replace(md0, mu=aux[0], lam=aux[1],
                                      viscosity=aux[2], material=mat)
        ts_loc = seeded_motion(tiles.bootstrap(soa, model_l, su.grid, tc))
        ts_loc, sig = tiles.particle_phase(ts_loc, model_l, su.bcs, 0.0, dt)
        win_k = cuda_mpm.p2g_tiled(ts_loc, sig, su.grid, tc, dt)
        win_r = cuda_mpm.p2g_tiled_ref(ts_loc, sig, su.grid, tc, dt)
        rel1 = float((window_components(win_k - win_r).abs().amax(dim=1)
                      / window_components(win_r).abs().amax(dim=1)).max())
        t0_, t1_ = tstarts[0], tstarts[1]
        ext = tiles.grid_phase(
            win_k, model_l, su.bcs, 0.0, su.grid, tc, dt,
            grid_reduce=lambda a: _exchange_accum_tiles(a, t0_, t1_, mesh,
                                                        None),
            grid_exchange=lambda g: _exchange_edges_tiles(g, t0_, t1_, mesh,
                                                          None))
        q_k = cuda_mpm.g2p_tiled(ts_loc, ext, su.grid, tc, dt)
        q_r = cuda_mpm.g2p_tiled_ref(ts_loc, ext, su.grid, tc, dt)
        rel2 = max(float((q_k[r0:r0 + n] - q_r[r0:r0 + n]).abs().max())
                   / float(q_r[r0:r0 + n].abs().max())
                   for r0, n in ((tiles.RX, 3), (tiles.RV, 3), (tiles.RC, 9),
                                 (tiles.RFT, 9)))
        check(rel1 <= 1e-5, f"halo K1: relative err {rel1}")
        check(rel2 <= 1e-5, f"halo K2: relative err {rel2}")
        live = int((ts_loc.chunk_live == 1).sum())
        print(f"halo_tiled path: K1 / K2 on the rank's {live} live chunks "
              f"of {tc.nchunk} (tile cap {tc.occ_cap}): relative err "
              f"{rel1:.3g} / {rel2:.3g} (tol 1e-5)", flush=True)
        out.update(k1_rel_err=rel1, k2_rel_err=rel2)
        counts_all = {k: max(out[e]["launches"][k] for e in engines)
                      for k in out["halo_tiled"]["launches"]}
        return counts_all, out
    finally:
        _end_group("halo")


def _avi_frames(path: str):
    """The '00dc' chunks of an AVI's 'movi' list and its idx1 entries;
    raises unless it is a RIFF AVI whose every chunk is a JPEG (SOI
    first, EOI last)."""
    import struct

    data = Path(path).read_bytes()
    check(data[:4] == b"RIFF" and data[8:12] == b"AVI ", f"{path}: not AVI")
    movi, idx1 = data.find(b"movi"), data.find(b"idx1")
    check(0 < movi < idx1, f"{path}: no movi list before idx1")
    pos, sizes = movi + 4, []
    while pos < idx1 - 8:
        tag, n = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        jpeg = data[pos + 8:pos + 8 + n]
        check(tag == b"00dc" and jpeg[:2] == b"\xff\xd8"
              and jpeg[-2:] == b"\xff\xd9", f"{path}: chunk {tag} not a JPEG")
        sizes.append(n)
        pos += 8 + n + (n & 1)
    n_idx = struct.unpack("<I", data[idx1 + 4:idx1 + 8])[0] // 16
    check(n_idx == len(sizes), f"{path}: idx1 {n_idx} != {len(sizes)} chunks")
    return sizes


def solver_phase(dev, wrappers, main):
    """Slice 7 at the main path's width: sim.MPMSolver (the simulate
    scene's 196,730 particles, n_grid 50, the ground collider, 2 frames of
    100 substeps) against tiles.frame_tiled driven directly from the same
    start, with exact K1 / K2 launches (SOLVER_FRAMES x 100 each) and its
    substeps/s; its postprocess against sim/solver.postprocess; a tile cap
    below the boot occupancy takes the golden route (K1 / K2 0 times, the
    state within SOLVER_RTOL of run_substeps); the native IO tier loaded;
    a 245,760-gaussian 62-property PLY read and written by both codecs
    (bit-equal, both times); the main path's video (the app's writer) and
    an encode_avi of its frames checked chunk by chunk."""
    import shutil

    from gsmpm_tpu_torch.io import _native, ply, video
    from gsmpm_tpu_torch.sim import MPMSolver, solver, tiles
    from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa

    status = _native.status()
    check(status == "loaded", f"solver: native IO tier {status}")
    cfg = bench_config()
    mpm, su = cfg.mpm, prepare_main(dev)
    steps = mpm.steps_per_frame

    def new_solver():
        s = MPMSolver(su.state.x, su.state.init_cov, su.state.vol, mpm,
                      device=str(dev))
        s.add_surface_collider((0, 0, 0.4), (0, 0, 1))  # the app's ground
        return s

    sol = new_solver()
    check(sol.use_tiled, "solver: the tiled engine is off on CUDA")
    torch.cuda.synchronize()
    _zero(wrappers)
    frame_s = []
    for _ in range(SOLVER_FRAMES):
        t0 = time.perf_counter()
        sol.step_frame()
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    counts = _counts(wrappers)
    want = SOLVER_FRAMES * steps
    check(sol.use_tiled and counts["p2g_tiled"] == counts["g2p_tiled"]
          == want, f"solver: tiled {sol.use_tiled}, launches {counts}, "
          f"expected {want} each")
    sps = want / sum(frame_s)

    # the same frames through tiles.frame_tiled driven directly
    ts = tiles.bootstrap(soa_from_state(su.state), su.model, su.grid, su.tc)
    st, t = su.state, 0.0
    for _ in range(SOLVER_FRAMES):
        ts, soa, t = tiles.frame_tiled(ts, soa_from_state(st), su.model,
                                       su.bcs, t, steps, su.grid, su.tc,
                                       mpm.substep_dt)
        st = state_from_soa(soa)
    check(bool(ts.ok) and t == sol.time, f"solver: clock {sol.time} vs {t}")
    errs = _rel_errs(sol.state, st)
    check(max(errs.values()) <= SOLVER_RTOL,
          f"solver vs frame_tiled: {errs} (tol {SOLVER_RTOL})")
    # 200 substeps of free fall move the box ~2e-3 (g t^2 / 2)
    motion = float((sol.state.x - su.state.x).abs().max())
    check(motion > 1e-4, f"solver: no motion ({motion})")
    state = sol.state
    cov6, R = sol.postprocess()
    cov_ref, R_ref = solver.postprocess(state, rotate_sh=True)
    check(torch.equal(cov6, cov_ref) and torch.equal(R, R_ref)
          and torch.equal(sol.state.cov, cov6), "solver: postprocess")

    # a tile cap below the boot occupancy: the golden route, 10 substeps
    boot = tiles.bootstrap(soa_from_state(su.state), su.model, su.grid, su.tc)
    occ = int(torch.unique(boot.chunk_tile[boot.chunk_live == 1]).numel())
    default_tc = solver.default_tile_config
    solver.default_tile_config = (
        lambda g, m: default_tc(g, m)._replace(n_occ_cap=occ - 1))
    try:
        capped = new_solver()
        _zero(wrappers)
        g0 = _golden_graph_counts()
        t0 = time.perf_counter()
        capped.step_frame(SOLVER_GOLDEN_STEPS)
        torch.cuda.synchronize()
        golden_s = time.perf_counter() - t0
        capped_counts = _counts(wrappers)
        golden_graph = _golden_graph_delta(g0)
    finally:
        solver.default_tile_config = default_tc
    check(not capped.use_tiled and capped_counts["p2g_tiled"]
          == capped_counts["g2p_tiled"] == 0,
          f"solver cap {occ - 1}: tiled {capped.use_tiled}, {capped_counts}")
    # the solver's golden frame replays the golden graph (slice 12)
    check(golden_graph == dict(captures=1,
                               replays=SOLVER_GOLDEN_STEPS - 1),
          f"solver golden frame: graph counters {golden_graph}")
    gold, t_gold = solver.run_substeps(su.state, su.model, su.bcs, 0.0,
                                       SOLVER_GOLDEN_STEPS, su.grid,
                                       mpm.substep_dt, checkpoint_policy=None)
    gold_errs = _rel_errs(capped.state, gold)
    check(capped.time == t_gold and max(gold_errs.values()) <= SOLVER_RTOL,
          f"solver golden route vs run_substeps: {gold_errs}")

    # the native PLY codec on a bench-size 3DGS checkpoint
    ply_dir = OUT_DIR / "solver"
    shutil.rmtree(ply_dir, ignore_errors=True)
    ply_dir.mkdir(parents=True)
    path = str(ply_dir / "point_cloud.ply")
    su.scene.save_ply(path)
    t0 = time.perf_counter()
    cols_native = ply.read_ply_vertices(path)
    native_read_s = time.perf_counter() - t0
    lib, _native._LIB = _native._LIB, None  # the numpy codec
    try:
        t0 = time.perf_counter()
        cols_py = ply.read_ply_vertices(path)
        py_read_s = time.perf_counter() - t0
    finally:
        _native._LIB = lib
    check(list(cols_native) == list(cols_py) and all(
        np.array_equal(cols_native[k].view(np.uint32), v.view(np.uint32))
        for k, v in cols_py.items()), "PLY: native columns differ")
    raw = Path(path).read_bytes()
    header = raw[:raw.index(b"end_header\n") + len(b"end_header\n")]
    t0 = time.perf_counter()
    ok = _native.write_ply_f32_planar(str(ply_dir / "native.ply"),
                                      header.decode(),
                                      np.stack(list(cols_py.values())))
    native_write_s = time.perf_counter() - t0
    check(ok and (ply_dir / "native.ply").read_bytes() == raw,
          "PLY: the native writer's bytes differ")
    t0 = time.perf_counter()
    su.scene.save_ply(str(ply_dir / "numpy.ply"))
    py_write_s = time.perf_counter() - t0
    n_g, n_p = len(cols_py["x"]), len(cols_py)

    # the main path's video and an AVI of its frames
    images = OUT_DIR / "main" / "images"
    n_frames = len(list(images.glob("*.png")))
    writer = main["video_writer"]
    if writer == "native MJPEG-AVI":
        check(len(_avi_frames(main["video"])) == n_frames,
              "main path AVI: frame count")
    t0 = time.perf_counter()
    check(video.encode_avi(str(images), str(ply_dir / "frames.avi")),
          "encode_avi failed")
    avi_s = time.perf_counter() - t0
    sizes = _avi_frames(str(ply_dir / "frames.avi"))
    check(len(sizes) == n_frames, f"AVI: {len(sizes)} chunks, {n_frames} PNGs")

    def listed(e):
        return ", ".join(f"{k} {v:.3g}" for k, v in e.items())

    print(f"solver: MPMSolver {SOLVER_FRAMES} frames x {steps} substeps at "
          f"{su.state.n_particles} particles, n_grid {mpm.n_grid}: "
          f"{sps:.2f} substeps/s (frames {['%.3f' % f for f in frame_s]} s), "
          f"launches K1 {counts['p2g_tiled']} K2 {counts['g2p_tiled']}; vs "
          f"frame_tiled driven directly: {listed(errs)} (tol {SOLVER_RTOL}); "
          f"postprocess bit-equal; cap {occ - 1} < boot {occ} tiles: golden "
          f"{SOLVER_GOLDEN_STEPS} substeps in {golden_s:.3f} s, K1/K2 "
          f"{capped_counts['p2g_tiled']}/{capped_counts['g2p_tiled']}, vs "
          f"run_substeps {listed(gold_errs)}", flush=True)
    print(f"native IO ({status}): PLY {n_g} x {n_p} float32 "
          f"({len(raw) / 1e6:.1f} MB) read native {native_read_s:.4f} s, "
          f"numpy {py_read_s:.4f} s ({py_read_s / native_read_s:.2f}x), "
          f"bit-equal; write native {native_write_s:.4f} s, numpy "
          f"{py_write_s:.4f} s, same bytes; main path video "
          f"{main['video']} ({writer}); encode_avi of its {n_frames} "
          f"{MAIN_RES}^2 frames {avi_s:.3f} s, {sum(sizes)} JPEG bytes",
          flush=True)
    return counts, dict(
        substeps_per_s=sps, frame_s=frame_s, rel_err_vs_frame_tiled=errs,
        motion=motion, boot_occupancy=occ, golden_s=golden_s,
        golden_graph=golden_graph,
        golden_rel_err=gold_errs, native_io=status,
        ply=dict(gaussians=n_g, properties=n_p, bytes=len(raw),
                 native_read_s=native_read_s, numpy_read_s=py_read_s,
                 native_write_s=native_write_s, numpy_write_s=py_write_s),
        video=main["video"], video_writer=writer, avi_s=avi_s,
        avi_frames=len(sizes))


DATA_CAMS = 2
PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG color type
# gsmpm_tpu's TPU-only RasterConfig knobs, accepted and unused on the port
TPU_KNOBS = dict(block_batch=4, remat=False, skip_empty=False, impl="xla",
                 sel="v1", stream_unroll=2, stream_chunk=256)


def png_with_row_filters(img: np.ndarray, ftypes) -> bytes:
    """(H, W, C) uint8 -> PNG bytes, row y filtered with ftypes[y] (0 none,
    1 sub, 2 up, 3 average, 4 Paeth): this phase's re-encoder.  The
    predictors read the image itself, so every row filters at once."""
    import struct
    import zlib

    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int32)
    up = np.vstack([np.zeros((1, w * c), np.int32), cur[:-1]])
    left = np.hstack([np.zeros((h, c), np.int32), cur[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int32), up[:, :-c]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(cur), left, up, (left + up) >> 1, paeth])
    ftypes = np.asarray(ftypes, np.int64)
    res = (cur - preds[ftypes, np.arange(h)]) & 0xFF
    rows = np.hstack([ftypes[:, None], res]).astype(np.uint8)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, PNG_COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def data_path_phase(dev, wrappers):
    """Slice 8: ``apps.identify --data_path`` at the bench fit's width.  An
    observed dataset of identify's scene (245,760 gaussians, n_grid 50,
    512^2, DATA_CAMS ring cameras x FIT_FRAMES frames) is written by
    scripts/torch_observed_dataset.py's main, every PNG re-encoded with a
    seeded filter per row so that all five occur, decoded by the native
    row unfilter and by its numpy twin (byte-equal, both timed), then
    identify fits it for FIT_FRAMES - 1 frames with every launch counter
    set to 0 just before and read just after.  Then gsmpm_tpu's interface
    on the card: a RasterConfig setting every TPU-only knob renders the
    main path's frame 0 bit-equal to the default (windowed K4, stream K3),
    ``drop_low_opacity`` feeds one MPMSolver frame (K1 / K2 100 each),
    and with tied parameters MPMModel.E() / nu() equal optimized_E / nu."""
    import importlib.util
    import shutil

    from gsmpm_tpu_torch.apps.identify import identify
    from gsmpm_tpu_torch.io import _native
    from gsmpm_tpu_torch.io import dataset as ds
    from gsmpm_tpu_torch.render import RasterConfig, render
    from gsmpm_tpu_torch.sim import MPMSolver
    from gsmpm_tpu_torch.sim.coupling import world2grid
    from gsmpm_tpu_torch.sim.volume import particle_volume

    check(_native.status() == "loaded", f"data_path: {_native.status()}")
    root = OUT_DIR / "data_path"
    shutil.rmtree(root, ignore_errors=True)
    data = root / "observed"
    script_path = (Path(__file__).resolve().parent / "scripts"
                   / "torch_observed_dataset.py")
    spec = importlib.util.spec_from_file_location("torch_observed_dataset",
                                                  script_path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    t0 = time.perf_counter()
    script.main(["--out", str(data), "--particles", str(MAIN_N), "--res",
                 str(FIT_RES), "--frames", str(FIT_FRAMES), "--cams",
                 str(DATA_CAMS), "--E_true", str(FIT_E_TRUE), "--device",
                 str(dev)])
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0

    # every PNG again, with one filter a row: all five types in each file
    paths = sorted(data.glob("cam*/*.png"))
    check(len(paths) == DATA_CAMS * FIT_FRAMES, f"dataset PNGs {paths}")
    rng = np.random.default_rng(11)
    originals = []
    for path in paths:
        img = ds.read_png(str(path))
        ftypes = rng.permutation(np.arange(img.shape[0]) % 5)
        path.write_bytes(png_with_row_filters(img, ftypes))
        originals.append(img)
    t0 = time.perf_counter()
    native = [ds.read_png(str(p)) for p in paths]
    native_s = time.perf_counter() - t0
    lib, _native._LIB = _native._LIB, None  # the numpy twin
    try:
        t0 = time.perf_counter()
        twin = [ds.read_png(str(p)) for p in paths]
        twin_s = time.perf_counter() - t0
    finally:
        _native._LIB = lib
    check(all(np.array_equal(a, b) and np.array_equal(a, o)
              for a, b, o in zip(native, twin, originals)),
          "data_path: native and twin PNG rows differ")
    shape = native[0].shape
    print(f"data_path: dataset {DATA_CAMS} cameras x {FIT_FRAMES} frames "
          f"{shape} written in {write_s:.1f} s, re-encoded one filter a row "
          f"(all five); decode of the {len(paths)} PNGs: native rows "
          f"{native_s:.4f} s ({1e3 * native_s / len(paths):.2f} ms a frame), "
          f"numpy twin {twin_s:.3f} s ({twin_s / native_s:.0f}x), "
          f"byte-equal", flush=True)

    args = identify_args(dev, str(root / "fit"), data_path=str(data))
    stats = {}
    _zero(wrappers)
    t0 = time.perf_counter()
    ident = identify(args, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(wrappers)
    fits = [r for r in stats["frames"] if r["frame"] > 0]
    check(len(fits) == FIT_FRAMES - 1, f"data_path fit frames {fits}")
    check(all(np.isfinite(r["loss"]) for r in stats["frames"]),
          f"data_path losses {stats['frames']}")
    check(ident.n_dropped_last == 0 and all(r["n_dropped"] == 0
                                            for r in fits),
          f"data_path n_dropped {[r['n_dropped'] for r in fits]}")
    check(ident.sim_engine == "tiled_vjp", f"data_path engine "
          f"{ident.sim_engine}")
    E = ident.optimized_E
    check(np.isfinite(E) and abs(E / FIT_E_INIT - 1.0) > 1e-6,
          f"data_path: E did not move from {FIT_E_INIT} ({E})")
    for name in ("p2g_tiled", "g2p_tiled", "sored_tiled", "blend_fwd",
                 "blend_bwd"):
        check(counts[name] > 0, f"data_path: {name} never launched")
    for name in ("stream_blend", "stream_blend_bwd", "blend_packed_fwd",
                 "blend_packed_bwd"):
        check(counts[name] == 0, f"data_path ran {name}")
    for name, k in PER_SUBSTEP.items():
        need = (FIT_FRAMES - 1) * FIT_SUBSTEPS * k
        check(counts[name] >= need, f"data_path {name}: {counts[name]} < "
              f"{need}")
    frame_s = [r["s"] for r in stats["frames"]]
    print(f"data_path: identify --data_path, {MAIN_N} gaussians, n_grid 50, "
          f"{FIT_RES}^2, {FIT_FRAMES} frames x {FIT_SUBSTEPS} substeps: frame "
          f"seconds {[round(x, 3) for x in frame_s]}, losses "
          f"{[round(r['loss'], 6) for r in stats['frames']]}, E "
          f"{FIT_E_INIT:g} -> {E:.6g}, nu {ident.optimized_nu:.5f}, wall "
          f"{wall:.1f} s, launches {counts}", flush=True)

    # tied parameters: every particle's E() / nu() is the readout
    n = ident.n_orig
    check(ident.fit_cfg.tie_params, "data_path: parameters not tied")
    E_p = ident.model.E()[:n].double()
    nu_p = ident.model.nu()[:n].double()
    E_err = float((E_p / E - 1.0).abs().max())
    nu_err = float((nu_p / ident.optimized_nu - 1.0).abs().max())
    check(E_err <= 1e-6 and nu_err <= 1e-6,
          f"MPMModel.E() / nu() vs optimized_E / nu: {E_err}, {nu_err}")
    del ident
    torch.cuda.empty_cache()

    # the TPU-only knobs: the main path's frame 0, bit for bit
    su = prepare_main(dev)
    splats = (*su.world(su.state.x, su.state.cov), su.opacity, su.features,
              su.camera, su.bg, su.scene.sh_degree)
    knobs_equal = {}
    for stream in (False, True):
        want = render(*splats, RasterConfig(stream=stream))
        got = render(*splats, RasterConfig(stream=stream, **TPU_KNOBS))
        knobs_equal["stream" if stream else "windowed"] = bool(
            torch.equal(got, want))
    check(all(knobs_equal.values()), f"TPU knobs change the render "
          f"{knobs_equal}")

    # drop_low_opacity feeds one MPMSolver frame
    mpm = bench_config().mpm
    faint = torch.zeros_like(su.scene.opacity)
    faint[::10] = -8.0 - su.scene.opacity[::10]  # logit -8: opacity 3e-4
    scene = dataclasses.replace(su.scene, opacity=su.scene.opacity + faint)
    kept = scene.drop_low_opacity(0.02)
    n_dropped = scene.num_gaussians - kept.num_gaussians
    check(n_dropped == -(-scene.num_gaussians // 10),
          f"drop_low_opacity dropped {n_dropped}")
    g_xyz, _, scaling = world2grid(kept.xyz, mpm.grid_extent)
    sol = MPMSolver(g_xyz, kept.get_covariance() * scaling * scaling,
                    particle_volume(g_xyz, mpm.n_grid, mpm.grid_extent), mpm,
                    device=str(dev))
    sol.add_surface_collider((0, 0, 0.4), (0, 0, 1))
    torch.cuda.synchronize()
    _zero(wrappers)
    t0 = time.perf_counter()
    sol.step_frame()
    torch.cuda.synchronize()
    solver_s = time.perf_counter() - t0
    solver_counts = _counts(wrappers)
    steps = mpm.steps_per_frame
    check(sol.use_tiled and solver_counts["p2g_tiled"] == steps
          and solver_counts["g2p_tiled"] == steps,
          f"drop_low_opacity MPMSolver: launches {solver_counts}, expected "
          f"{steps} each")
    check(bool(torch.isfinite(sol.state.x).all()), "MPMSolver: non-finite x")
    print(f"data_path: gsmpm_tpu's interface on the card: TPU-only "
          f"RasterConfig knobs bit-equal {knobs_equal}; drop_low_opacity("
          f"0.02) kept {kept.num_gaussians} of {scene.num_gaussians}, one "
          f"MPMSolver frame in {solver_s:.3f} s (K1 "
          f"{solver_counts['p2g_tiled']}, K2 {solver_counts['g2p_tiled']}); "
          f"tied MPMModel.E() / nu() vs optimized_E / nu: {E_err:.2e}, "
          f"{nu_err:.2e}", flush=True)
    return counts, dict(
        dataset=dict(cameras=DATA_CAMS, frames=FIT_FRAMES, shape=list(shape),
                     write_s=write_s, decode_native_s=native_s,
                     decode_twin_s=twin_s, pngs=len(paths)),
        frame_s=frame_s, losses=[r["loss"] for r in stats["frames"]], E=E,
        wall_s=wall, knobs_bit_equal=knobs_equal,
        drop_low_opacity=dict(kept=kept.num_gaussians, dropped=n_dropped,
                              solver_s=solver_s, launches=solver_counts),
        E_rel_err=E_err, nu_rel_err=nu_err)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from gsmpm_tpu_torch.utils import build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 twins stay fp32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    logs = build.build_all(build.SOURCES + (build.NATIVE,))
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)} "
          f"(already built: {not logs})", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    from gsmpm_tpu_torch.render import cuda_blend
    from gsmpm_tpu_torch.render import stream_raster
    from gsmpm_tpu_torch.sim import cuda_mpm

    # slice 1: the simulation path
    rows = kernel_phases(dev)
    small_parity(dev)
    wrappers = [r["wrapper"] for r in rows] + [
        cuda_mpm.sored_tiled, cuda_blend.blend_fwd, cuda_blend.blend_bwd,
        stream_raster.stream_blend_bwd, cuda_blend.blend_packed_fwd,
        cuda_blend.blend_packed_bwd]
    sim_counts, main = main_path(dev, wrappers)
    main["profile"] = profile_phase(dev, main)
    # slice 9: the tiled frame's substep graph against the eager loop
    t0 = time.perf_counter()
    graph_counts, graph = graph_phase(dev, wrappers)
    graph["phase_s"] = time.perf_counter() - t0
    print(f"graph phase: {graph['phase_s']:.1f} s", flush=True)
    # slice 12: the golden engine's substep graph against the eager loop
    t0 = time.perf_counter()
    golden_graph_counts, golden_graph = golden_graph_phase(dev, wrappers)
    golden_graph["phase_s"] = time.perf_counter() - t0
    print(f"golden_graph phase: {golden_graph['phase_s']:.1f} s", flush=True)

    # slice 2: the identification path
    ident, fit_counts, fit = identify_path(dev, wrappers)
    fit["steady"], first, fit_gt, fit_cams = steady_fit(dev, ident, wrappers)
    fit["profile"] = fit_profile(dev, ident, first, fit["steady"])
    # slice 10: the fit window's two graphs against the checkpointed loop
    t0 = time.perf_counter()
    fit_graph_counts, fit_graph = fit_graph_phase(dev, ident, fit_gt,
                                                  fit_cams, wrappers)
    fit_graph["phase_s"] = time.perf_counter() - t0
    print(f"fit_graph phase: {fit_graph['phase_s']:.1f} s", flush=True)
    # slice 12: the golden fit window's graphs against the checkpointed loop
    t0 = time.perf_counter()
    golden_fit_counts, golden_graph["fit"] = golden_fit_graph_phase(
        dev, ident, fit_gt, fit_cams, wrappers)
    golden_graph["fit"]["phase_s"] = time.perf_counter() - t0
    print(f"golden_graph phase (fit): {golden_graph['fit']['phase_s']:.1f} s",
          flush=True)
    blend_rows, fit["blend_tiers"] = blend_phases(dev, ident, first)
    rows += blend_rows + [sored_phase(dev, ident, first)]
    # K1 and K2 at the fit's shapes, beside their rows at simulate's
    for r, fit_row in zip(rows[:2], transfer_fit_phases(dev, ident, first)):
        r.update({f"fit_{k}": fit_row[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "rel_err", "blocks") if k in fit_row})
    fit["small_parity"] = small_fit_parity(dev)

    # slice 5: the multi-device fit steps, on a one-rank NCCL group
    t0 = time.perf_counter()
    mesh_fit_counts, mesh_fit = mesh_fit_phase(dev, ident, fit_gt, fit_cams,
                                               wrappers)
    mesh_fit["phase_s"] = time.perf_counter() - t0
    del ident, first, fit_gt, fit_cams
    torch.cuda.empty_cache()

    # slice 3: the stream-rendered fit (path A) and the packed render (B)
    sident, sfit_counts, sfit = stream_fit_path(dev, wrappers)
    sfit["steady"], sfirst, _, _ = steady_fit(dev, sident, wrappers)
    print(f"steady fit frame: stream render "
          f"{np.mean(sfit['steady']['frame_s']):.4f} s "
          f"{[round(x, 4) for x in sfit['steady']['frame_s']]}, windowed "
          f"render {np.mean(fit['steady']['frame_s']):.4f} s "
          f"{[round(x, 4) for x in fit['steady']['frame_s']]}", flush=True)
    sfit["profile"] = fit_profile(dev, sident, sfirst, sfit["steady"])
    rows.append(stream_bwd_phase(dev, sident, sfirst))
    packed_counts, packed, packed_rows = packed_phase(dev, sident, sfirst,
                                                      wrappers)
    rows += packed_rows
    sfit["small_parity"] = small_fit_parity(dev, stream=True)

    # slice 4: the golden route, checkpoint / resume, the one-rank mesh
    t0 = time.perf_counter()
    golden_counts, golden = golden_route_phase(dev, wrappers)
    resume_counts, resume = resume_phase(dev, wrappers)
    mesh_counts, mesh = mesh_phase(dev, wrappers)
    slice4_s = time.perf_counter() - t0
    print(f"slice 4 phases: {slice4_s:.1f} s", flush=True)
    # slice 6: the halo engines, on a one-rank NCCL group
    t0 = time.perf_counter()
    halo_counts, halo = halo_phase(dev, wrappers)
    halo["phase_s"] = time.perf_counter() - t0
    print(f"halo phase: {halo['phase_s']:.1f} s", flush=True)
    # slice 7: MPMSolver and the native IO tier
    t0 = time.perf_counter()
    solver_counts, solver = solver_phase(dev, wrappers, main)
    solver["phase_s"] = time.perf_counter() - t0
    print(f"solver phase: {solver['phase_s']:.1f} s", flush=True)
    # slice 8: identify --data_path and gsmpm_tpu's interface
    t0 = time.perf_counter()
    data_counts, data_path = data_path_phase(dev, wrappers)
    data_path["phase_s"] = time.perf_counter() - t0
    print(f"data_path phase: {data_path['phase_s']:.1f} s", flush=True)
    print(card)  # the data_path numbers' card
    for r in rows:
        if r["name"] in ("p2g_tiled", "g2p_tiled"):
            key = "k1_rel_err" if r["name"] == "p2g_tiled" else "k2_rel_err"
            r["mesh_rel_err"] = mesh["render"][key]
            r["halo_rel_err"] = halo[key]
        if r["name"] == "blend_fwd":
            r.update(mesh_max_abs_err=mesh["render"]["k4_err"],
                     mesh_ms=mesh["render"]["k4_ms"],
                     mesh_K=mesh["render"]["K"],
                     mesh_fit_max_abs_err=mesh_fit["k4_err"],
                     mesh_fit_ms=mesh_fit["k4_ms"],
                     mesh_fit_K=mesh_fit["rows_K"])
        if r["name"] == "blend_bwd":
            r.update(mesh_fit_rel_err=mesh_fit["k5_rel"],
                     mesh_fit_ms=mesh_fit["k5_ms"],
                     mesh_fit_K=mesh_fit["rows_K"])

    # each kernel's own path: the one its slice ported it for
    own_path = dict(stream_blend="simulate", stream_blend_bwd="stream_fit",
                    blend_packed_fwd="packed", blend_packed_bwd="packed")
    kernels = []
    for r in rows:
        name = r["name"]
        r["share"] = r["bound_ms"] / r["ms"]
        if "fit_ms" in r:
            r["fit_share"] = r["fit_bound_ms"] / r["fit_ms"]
        by_path = {"simulate": sim_counts[name], "identify": fit_counts[name],
                   "stream_fit": sfit_counts[name],
                   "packed": packed_counts[name],
                   "golden_route": golden_counts[name],
                   "resume": resume_counts[name], "mesh": mesh_counts[name],
                   "mesh_fit": mesh_fit_counts[name],
                   "halo": halo_counts[name], "graph": graph_counts[name],
                   "fit_graph": fit_graph_counts[name],
                   "mesh_graph": mesh["tiled"]["graph_turns"]["launches"][
                       name],
                   "mesh_fit_graph": mesh_fit["graph_turns"]["launches"][
                       name],
                   "golden_graph": golden_graph_counts[name],
                   "golden_fit_graph": golden_fit_counts[name],
                   "solver": solver_counts[name],
                   "data_path": data_counts[name]}
        check(max(by_path.values()) > 0, f"{name} launched on no path")
        check(by_path[own_path.get(name, "identify")] > 0,
              f"{name} not launched on its own path")
        kernels.append({
            "name": name, "route": r["route"], "source": r["source"],
            "replaces": r["replaces"],
            "launches": by_path[own_path.get(name, "identify")],
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ROW_EXTRAS if k in r},
        })
    check(len(kernels) == 9, f"{len(kernels)} kernels in the table")
    k3_fit = next(r for r in rows if r["name"] == "stream_blend_bwd")["k3_fit"]
    next(k for k in kernels if k["name"] == "stream_blend").update(fit_ms=k3_fit["ms"], fit_bound_ms=k3_fit["bound_ms"],
                      fit_culled_share=k3_fit["culled_share"])
    print(json.dumps({"main_path": main, "identify_path": fit,
                      "stream_fit_path": sfit, "packed_path": packed,
                      "golden_route_path": golden, "resume_path": resume,
                      "mesh_path": mesh, "slice4_s": slice4_s,
                      "mesh_fit_path": mesh_fit, "halo_path": halo,
                      "solver_path": solver, "data_path": data_path,
                      "graph_path": graph, "fit_graph_path": fit_graph,
                      "golden_graph_path": golden_graph}))
    print(card)  # nvidia-smi name, power.limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
