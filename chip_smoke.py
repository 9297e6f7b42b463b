#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gsmpm_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Requires CUDA; prints ``nvidia-smi`` name and power limit.
2. Builds every kernel of the main path from gsmpm_tpu_torch/csrc/ (one
   nvcc per source, started together) and times the build.
3. Holds each kernel against its plain PyTorch twin at the main path's
   shapes (245,760-gaussian box scene, n_grid 50, 800x800, the bench
   configuration; the transfers on a state given seeded motion, the blend
   on frame 0): max abs / relative error, kernel and twin time (CUDA
   events after warm-up) and the kernel's lower bound on this card.
4. Runs the whole port on the GPU and on the CPU at a small size and
   compares the frames.
5. Drives the main path, ``apps.simulate.simulate`` for 4 frames x 100
   substeps, with every launch counter set to 0 just before; checks
   n_dropped == 0, finite frames, motion, and that every kernel launched.
6. Profiles 2 more frames of ``simulate`` with torch.profiler: device time
   by kernel and the device's busy share of the frame loop.
7. Prints the main path's numbers as JSON, the ``nvidia-smi`` name and
   power limit line, one JSON line with every kernel's numbers, and a last
   line ``{"ok": true, "device": {...}}``.

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

MAIN_N = 245_760
MAIN_RES = 800
MAIN_FRAMES = 4
PROFILE_FRAMES = 2
PROFILE_TOP = 12
OUT_DIR = Path(__file__).resolve().parent / "outputs" / "chip_smoke"


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
    print("K1 p2g: relative err mass / momentum x, y, z "
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
    check(rel1 <= 1e-5, f"K1 p2g: relative err {rel1}")
    ms1 = cuda_ms(lambda: cuda_mpm.p2g_tiled(ts, sig, grid, tc, dt), 20)
    pms1 = cuda_ms(lambda: cuda_mpm.p2g_tiled_ref(ts, sig, grid, tc, dt), 3, 1)
    # must read x, v, C, mass, vol (17 rows) and 9 stress rows of the live
    # slots, write the windows; ~1260 flops per real particle
    b1 = bound_ms(n_live * 26 * 4 + win_k.numel() * 4, n_real * 1260.0)
    rows.append(dict(
        name="p2g_tiled", route="cuda",
        source="gsmpm_tpu_torch/csrc/mpm_transfer.cu",
        replaces="gsmpm_tpu/sim/pallas_mpm.py:160",
        max_abs_err=err1, rel_err=rel1, tol="1e-5 x max per component",
        ms=ms1, plain_ms=pms1, bound_ms=b1[0], bound_by=b1[1],
        library_ms=None, wrapper=cuda_mpm.p2g_tiled,
    ))

    # ---- K2 G2P (input: this substep's grid velocities)
    ext = tiles.grid_phase(win_k, su.model, su.bcs, 0.0, grid, tc, dt)
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
    print("K2 g2p: relative err by group "
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
    check(rel2 <= 1e-5, f"K2 g2p: relative err {rel2}")
    check(drift_mismatch <= 8, f"K2 g2p: {drift_mismatch} drift flags differ")
    ms2 = cuda_ms(lambda: cuda_mpm.g2p_tiled(ts, ext, grid, tc, dt), 20)
    pms2 = cuda_ms(lambda: cuda_mpm.g2p_tiled_ref(ts, ext, grid, tc, dt), 3, 1)
    occupied = int(torch.unique(ts.chunk_tile[ts.chunk_live == 1]).numel())
    # must read x, F, mass and the copied rows (18 rows) of every slot and
    # the occupied tiles' velocity blocks, write all 40 rows; ~1900 flops
    # per real particle
    b2 = bound_ms(tc.np_rows * (18 + 40) * 4 + occupied * 192 * 64 * 4,
                  n_real * 1900.0)
    rows.append(dict(
        name="g2p_tiled", route="cuda",
        source="gsmpm_tpu_torch/csrc/mpm_transfer.cu",
        replaces="gsmpm_tpu/sim/pallas_mpm.py:293",
        max_abs_err=err2, rel_err=rel2, tol="1e-5 x max per row group",
        ms=ms2, plain_ms=pms2, bound_ms=b2[0], bound_by=b2[1],
        library_ms=None, wrapper=cuda_mpm.g2p_tiled,
    ))

    # ---- K3 stream forward (input: frame 0 of the main path)
    rcfg = RasterConfig()
    w_xyz, w_cov = su.world_geometry(su.state)
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
    # evaluated (slot, pixel) pairs of this data: each pixel walks its
    # block's segment up to its last contributor when done, else to the end
    lo = bounds[:-1].to(torch.float64)[:, None]
    hi = bounds[1:].to(torch.float64)[:, None]
    last = out_k[:, 5].to(torch.float64)
    walked = torch.where(out_k[:, 4] > 0, (last - lo).clamp_min(0), hi - lo)
    pairs = float(walked.sum())
    # >= 20 fp32 operations per pair: 6 mul + 6 add for the power term,
    # exp, clamp, two compares, the transmittance and three color updates
    b3 = bound_ms(splanes.numel() * 4 + bounds.numel() * 4
                  + out_k.numel() * 4, pairs * 20.0)
    rows.append(dict(
        name="stream_blend", route="cuda",
        source="gsmpm_tpu_torch/csrc/stream_raster.cu",
        replaces="gsmpm_tpu/render/stream_raster.py:315",
        max_abs_err=err3, rel_err=err3, tol="2e-3 abs on rgb/T",
        ms=ms3, plain_ms=pms3, bound_ms=b3[0], bound_by=b3[1],
        library_ms=None, wrapper=sr.stream_blend,
        pairs=pairs, L=int(splanes.shape[1]),
    ))
    for r in rows:
        print(f"{r['name']}: max_abs_err {r['max_abs_err']:.3g} rel "
              f"{r['rel_err']:.3g} (tol {r['tol']}) kernel {r['ms']:.4f} ms "
              f"plain {r['plain_ms']:.3f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    print(f"main-path shapes: NP {tc.np_rows}, nchunk {tc.nchunk}, live "
          f"chunks {n_live // tc.S}, occupied tiles {occupied}, real "
          f"particles {n_real}, stream slots {splanes.shape[1]}, "
          f"pairs {pairs:.4g}, K2 drift flags differing {drift_mismatch}, "
          f"K3 done flags differing {done_mismatch:.3g}", flush=True)
    return rows


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
    return counts, dict(substeps_per_s=sps, render_ms_per_frame=render_ms,
                        sim_s=stats["sim_s"], render_s=stats["render_s"],
                        motion=motion)


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
    logs = build.build_all(["mpm_transfer", "stream_raster"])
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)} "
          f"(already built: {not logs})", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rows = kernel_phases(dev)
    small_parity(dev)
    counts, main = main_path(dev, [r["wrapper"] for r in rows])
    main["profile"] = profile_phase(dev, main)

    kernels = []
    for r in rows:
        kernels.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": counts[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"main_path": main}))
    print(card)  # nvidia-smi name, power.limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
