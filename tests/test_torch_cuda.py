"""The port's CUDA kernels vs their plain twins, on an NVIDIA GPU.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode).  This file imports no JAX, so on the machine with the
GPU it runs without the JAX conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Inputs are small (a few hundred particles, or 26,100 in three dense
tiles for K1; n_grid 16-24, 64^2-256^2, blend windows up
to K 20,480, streams up to ~10^5 slots) and made with numpy from seeds;
chip_smoke.py repeats the comparisons at the main paths' shapes.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from gsmpm_tpu_torch.apps.simulate import prepare, simulate
from gsmpm_tpu_torch.config import MPMConfig, RenderConfig, SimConfig
from gsmpm_tpu_torch.models.synthetic import synthetic_blob_scene
from gsmpm_tpu_torch.render import cuda_blend as cb
from gsmpm_tpu_torch.render import renderer as tr
from gsmpm_tpu_torch.render import stream_raster as sr
from gsmpm_tpu_torch.render.camera import make_camera
from gsmpm_tpu_torch.sim import cuda_mpm, tiles
from gsmpm_tpu_torch.sim import transfer_vjp as tv
from gsmpm_tpu_torch.sim.fitting import FitConfig, SystemIdentifier
from gsmpm_tpu_torch.sim.kernels import soa_from_state

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cfg(tmp_path, n_grid=16, substep_dt=1e-3):
    return SimConfig(
        mpm=MPMConfig(E=2e5, nu=0.3, material="jelly", n_grid=n_grid,
                      substep_dt=substep_dt, frame_dt=1e-2, density=200.0,
                      gravity=[0.0, 0.0, -9.8]),
        render=RenderConfig(output_path=str(tmp_path / "out")),
    )


def _first_substep_inputs(tmp_path, n=2048):
    """The transfers' inputs of a first substep whose state was given
    seeded motion: v, APIC C and F_trial perturbed on the real slots, so
    the momentum, APIC and stress terms are all nonzero (the scene's own
    first state has v = 0, C = 0, F_trial = I)."""
    cfg = _cfg(tmp_path)
    su = prepare(cfg, synthetic=n, synthetic_res=128, device="cuda",
                 quiet=True)
    ts = tiles.bootstrap(soa_from_state(su.state), su.model, su.grid, su.tc)
    rng = np.random.default_rng(4)
    q = ts.q.clone()
    live = (q[tiles.RMASS] > 0).to(q.dtype)
    for r0, rows, std in ((tiles.RV, 3, 2.0), (tiles.RC, 9, 10.0),
                          (tiles.RFT, 9, 0.02)):
        noise = rng.normal(size=(rows, q.shape[1])).astype(np.float32)
        q[r0:r0 + rows] += std * torch.from_numpy(noise).cuda() * live
    ts, sig = tiles.particle_phase(dataclasses.replace(ts, q=q), su.model,
                                   su.bcs, 0.0, cfg.mpm.substep_dt)
    return cfg, su, ts, sig


def _components(win):
    """P2G windows -> (4, -1): mass, momentum x, y, z."""
    return win.reshape(-1, 8, 4, 8, 64).transpose(0, 2).reshape(4, -1)


def test_p2g_kernel_matches_twin(cuda, tmp_path):
    cfg, su, ts, sig = _first_substep_inputs(tmp_path)
    dt = cfg.mpm.substep_dt
    before = cuda_mpm.p2g_tiled.launches
    got = cuda_mpm.p2g_tiled(ts, sig, su.grid, su.tc, dt)
    assert cuda_mpm.p2g_tiled.launches == before + 1
    want = tiles.p2g_tiled_ref(ts, sig, su.grid, su.tc, dt)
    scale = _components(want).abs().amax(dim=1)
    assert bool((scale > 0).all())
    # the stress term moves the momentum rows well beyond the tolerance
    no_stress = tiles.p2g_tiled_ref(ts, torch.zeros_like(sig), su.grid,
                                    su.tc, dt)
    moved = _components(want - no_stress).abs().amax(dim=1)[1:] / scale[1:]
    assert float(moved.min()) >= 1e-3
    # float atomics add in a run-dependent order: 1e-5 of each component's
    # largest entry (mass and each momentum component on its own)
    err = _components(got - want).abs().amax(dim=1)
    assert float((err / scale).max()) <= 1e-5


def test_p2g_kernel_dense_tiles(cuda):
    """K1 on tests/test_torch_cull_groups.py's dense case (~740 particles
    a cell in tile 0, whose 78 live chunks all add into one window; a tile
    of one chunk, a dead chunk inside a tile's range, dead slack chunks,
    five empty tiles): within 1e-5 of each component's largest entry of
    the twin (float atomics add in a run-dependent order), the empty
    tiles' windows exactly zero, on two calls whose outputs likely reuse
    the caching allocator's block of a freed tensor of NaNs."""
    from test_torch_cull_groups import dense_tiled_state

    ts, sig, grid, tc, dt = dense_tiled_state(cuda)
    want = tiles.p2g_tiled_ref(ts, sig, grid, tc, dt)
    scale = _components(want).abs().amax(dim=1)
    assert bool((scale > 0).all())
    empty = torch.bincount(ts.chunk_tile[ts.chunk_live == 1].long(),
                           minlength=tc.ntiles) == 0
    assert int(empty.sum()) == 5
    for _ in range(2):
        junk = torch.full_like(want, float("nan"))
        del junk  # the kernel's launcher must zero the windows it adds into
        before = cuda_mpm.p2g_tiled.launches
        got = cuda_mpm.p2g_tiled(ts, sig, grid, tc, dt)
        assert cuda_mpm.p2g_tiled.launches == before + 1
        err = _components(got - want).abs().amax(dim=1)
        assert float((err / scale).max()) <= 1e-5, err / scale
        assert float(got[empty].abs().max()) == 0.0


def test_g2p_kernel_matches_twin(cuda, tmp_path):
    cfg, su, ts, sig = _first_substep_inputs(tmp_path)
    dt = cfg.mpm.substep_dt
    rng = np.random.default_rng(0)
    ext = torch.from_numpy(rng.normal(size=(su.tc.ntiles, 192, 64))
                           .astype(np.float32)).to(cuda)
    got = cuda_mpm.g2p_tiled(ts, ext, su.grid, su.tc, dt)
    want = tiles.g2p_tiled_ref(ts, ext, su.grid, su.tc, dt)
    # natural scale of each row: |x|, |v|, 4 inv_dx |v| for C, |F|
    scale = torch.ones((tiles.QROWS, 1), device=cuda)
    scale[tiles.RX:tiles.RX + 3] = float(want[0:3].abs().max())
    scale[tiles.RV:tiles.RV + 3] = float(ext.abs().max())
    scale[tiles.RC:tiles.RC + 9] = 4.0 * su.grid.inv_dx * float(ext.abs().max())
    assert float(((got - want).abs() / scale).max()) <= 1e-5


def test_g2p_kernel_dense_tiles(cuda):
    """K2 on tests/test_torch_cull_groups.py's dense case: tile 0's 78 live
    chunks with a dead chunk among them, then a tile of one chunk, so the
    tile changes inside a run of chunks a block may take (chunks 78 / 79),
    then 24 chunks of tile 7 and dead slack chunks; seeded velocity blocks.
    The live chunks' rows within 1e-5 of each row group's natural scale of
    the twin, at most 8 drift flags differing (positions exactly on a cell
    boundary), and the dead chunks' rows passed through bit for bit."""
    from test_torch_cull_groups import dense_tiled_state

    ts, _, grid, tc, dt = dense_tiled_state(cuda)
    assert int(ts.chunk_live[40]) == 0 and int(ts.chunk_live[41]) == 1
    assert int(ts.chunk_tile[78]) == 0 and int(ts.chunk_tile[79]) == 3
    rng = np.random.default_rng(6)
    ext = torch.from_numpy(rng.normal(size=(tc.ntiles, 192, 64))
                           .astype(np.float32)).to(cuda)
    before = cuda_mpm.g2p_tiled.launches
    got = cuda_mpm.g2p_tiled(ts, ext, grid, tc, dt)
    assert cuda_mpm.g2p_tiled.launches == before + 1
    want = tiles.g2p_tiled_ref(ts, ext, grid, tc, dt)
    live = (ts.chunk_live == 1).repeat_interleave(tc.S)
    scale = torch.ones((tiles.QROWS, 1), device=cuda)
    scale[tiles.RX:tiles.RX + 3] = float(want[0:3].abs().max())
    scale[tiles.RV:tiles.RV + 3] = float(ext.abs().max())
    scale[tiles.RC:tiles.RC + 9] = 4.0 * grid.inv_dx * float(ext.abs().max())
    rows = [r for r in range(tiles.QROWS) if r != tiles.RDRIFT]
    err = ((got - want).abs() / scale)[rows][:, live]
    assert float(err.max()) <= 1e-5
    drift = got[tiles.RDRIFT, live] != want[tiles.RDRIFT, live]
    assert int(drift.sum()) <= 8
    # the F rows moved: a kernel that gathered the wrong block would miss
    moved = (want[tiles.RFT:tiles.RFT + 9] - want[tiles.RF:tiles.RF + 9])
    assert float(moved[:, live].abs().max()) > 1e-3
    assert torch.equal(got[:, ~live], ts.q[:, ~live])


@pytest.mark.parametrize("nchunk,blocks", [(1, 1), (2, 1), (1112, 556),
                                           (1303, 652)])
def test_g2p_block_counts(cuda, nchunk, blocks):
    """K2's launches report their CUDA blocks: two chunks a block."""
    assert cuda_mpm.g2p_blocks(nchunk) == blocks


def test_wrappers_reject_bad_inputs(cuda, tmp_path):
    cfg, su, ts, sig = _first_substep_inputs(tmp_path)
    with pytest.raises(ValueError):
        cuda_mpm.p2g_tiled(ts, sig[:, ::2], su.grid, su.tc, 1e-3)
    with pytest.raises(ValueError):
        cuda_mpm.g2p_tiled(ts, torch.zeros((1, 192, 64), device=cuda),
                           su.grid, su.tc, 1e-3)


def _stream_case(dev, n=800, res=128, seed=9, block=64, scale=0.05):
    """A dense cluster's sorted stream: (splanes, bounds, nbx, B, t_min,
    alpha_min); ``scale`` sets the splats' size."""
    rng = np.random.default_rng(seed)
    means = (0.08 * rng.normal(size=(n, 3))).astype(np.float32)
    means[:, 2] += 3.5
    A = scale * rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    opacity = rng.uniform(0.15, 0.95, size=n).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    cam = make_camera(res, res, 0.9, 0.9, np.eye(3), np.zeros(3))
    cfg = tr.RasterConfig(block=block)
    C = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pre = tr.preprocess(C(means), C(cov6), C(opacity), None, cam, 0, cfg,
                        colors_precomp=C(colors))
    splanes, bounds, _, lv = sr.stream_inputs(pre, cam, cfg)
    return splanes, bounds, lv.nbx, cfg.block, cfg.t_min, cfg.alpha_min


# K3 takes any multiple of 16; K7 (4 pixels per thread) blocks up to 64
@pytest.mark.parametrize("block", [64, 80])
def test_stream_kernel_matches_twin(cuda, block):
    args = _stream_case(cuda, res=2 * block, block=block)
    before = sr.stream_blend.launches
    got = sr.stream_blend(*args)
    assert sr.stream_blend.launches == before + 1
    want = sr.stream_blend_ref(*args)
    # sequential vs chunked transmittance products round differently
    assert float((got[:, 0:4] - want[:, 0:4]).abs().max()) <= 2e-3
    assert float((got[:, 4] != want[:, 4]).float().mean()) <= 1e-3
    if block > 64:
        with pytest.raises(ValueError):
            sr.stream_blend_bwd(args[0], args[1], got, torch.zeros_like(got),
                                args[2], block, args[5])


@pytest.mark.parametrize("block", [32, 64, 80])
def test_stream_kernels_on_crafted_splats(cuda, block):
    """K3 on tests/test_torch_cull_groups.py's crafted stream (large
    anisotropic splats straddling the 16 x 8 pixel groups and the block
    edges, splats below alpha_min, conics that are not positive definite)
    against its twin, and K7 on the new K3's output against its own."""
    from test_torch_cull_groups import crafted_stream

    splanes, bounds, nbx, B = crafted_stream(B=block, per_block=1500,
                                             device=cuda)
    cfg = tr.RasterConfig(block=B)
    args = (splanes, bounds, nbx, B, cfg.t_min, cfg.alpha_min)
    out = sr.stream_blend(*args)
    want = sr.stream_blend_ref(*args)
    # sequential vs chunked transmittance products round differently
    assert float((out[:, 0:4] - want[:, 0:4]).abs().max()) <= 2e-3
    assert float((out[:, 4] != want[:, 4]).float().mean()) <= 1e-3
    assert float(out[:, 4].mean()) > 0.05  # some pixels saturate
    if B > 64:
        return  # K7 takes blocks up to 64
    rng = np.random.default_rng(5)
    g = torch.zeros_like(out)
    g[:, 0:4] = torch.from_numpy(rng.normal(size=(out.shape[0], 4,
                                                  out.shape[2]))
                                 .astype(np.float32)).to(cuda)
    got = sr.stream_blend_bwd(splanes, bounds, out, g, nbx, B, cfg.alpha_min)
    dsp = sr.stream_blend_bwd_ref(splanes, bounds, out, g, nbx, B,
                                  cfg.alpha_min)
    for rows in (slice(0, 2), slice(2, 5), slice(5, 6), slice(6, 9)):
        scale = float(dsp[rows].abs().max())
        assert scale > 0
        err = float((got[rows] - dsp[rows]).abs().max())
        assert err <= 1e-4 * scale, (rows, err, scale)


def _sequential_walk(splanes, bounds, nbx, B, t_min, alpha_min):
    """K3's blend with no cull, in plain torch on the card: the segments
    (of equal length) walked slot by slot, every pixel evaluating every
    slot with the kernel's expressions in the kernel's order (each torch
    op rounds on its own, as the kernel's file does under --fmad=false).
    Returns rgb, T, done, last as K3's rows 0..5."""
    nf = bounds.numel() - 1
    lo = bounds[:-1].to(torch.int64)
    n = int(bounds[1] - bounds[0])
    assert bool(((bounds[1:] - bounds[:-1]) == n).all())
    bid = torch.arange(nf, device=splanes.device)
    x0 = ((bid % nbx) * B).float()[:, None]
    y0 = ((bid // nbx) * B).float()[:, None]
    px, py, pxx, pyy, pxy = sr._pixel_coords(B, splanes.device)
    P = B * B
    T = torch.ones((nf, P), device=splanes.device)
    rgb = torch.zeros((3, nf, P), device=splanes.device)
    last = torch.zeros((nf, P), device=splanes.device)
    done = torch.zeros((nf, P), dtype=torch.bool, device=splanes.device)
    for j in range(n):
        p = splanes[:, lo + j][..., None]                    # (9, nf, 1)
        gx, gy = p[0] - x0, p[1] - y0
        a, bb, c, logo = p[2], p[3], p[4], p[5]
        F2 = -0.5 * (a * gx * gx + c * gy * gy) - bb * gx * gy
        power = (-0.5 * a) * pxx
        power = power + (a * gx + bb * gy) * px
        power = power + F2
        power = power + (-0.5 * c) * pyy
        power = power + (c * gy + bb * gx) * py
        power = power + (-bb) * pxy
        power = power + logo
        alpha = torch.clamp_max(torch.exp(power), 0.99)
        gate = (power <= logo) & (alpha >= alpha_min) & ~done
        T_after = T * (1.0 - alpha)
        stop = gate & (T_after < t_min)
        upd = gate & ~stop
        w = T * alpha
        rgb = torch.where(upd, rgb + p[6:9] * w, rgb)
        T = torch.where(upd, T_after, T)
        last = torch.where(upd, (lo[:, None] + j + 1).float(), last)
        done = done | stop
    return rgb, T, done, last


def test_stream_kernel_culls_no_contributor(cuda):
    """K3 on the crafted stream against the walk without any cull: the
    cull skips only (slot, pixel) pairs the gate rejects, so every pixel
    meets the same contributors in the same order with the same
    expressions: done and last are equal, rgb and T to 1e-6."""
    from test_torch_cull_groups import crafted_stream

    splanes, bounds, nbx, B = crafted_stream(B=64, per_block=1500,
                                             device=cuda)
    cfg = tr.RasterConfig(block=B)
    out = sr.stream_blend(splanes, bounds, nbx, B, cfg.t_min, cfg.alpha_min)
    rgb, T, done, last = _sequential_walk(splanes, bounds, nbx, B,
                                          cfg.t_min, cfg.alpha_min)
    assert torch.equal(out[:, 4] > 0, done)
    assert torch.equal(out[:, 5], last)
    assert float((out[:, 0:3] - rgb.transpose(0, 1)).abs().max()) <= 1e-6
    assert float((out[:, 3] - T).abs().max()) <= 1e-6
    assert 0.05 < float(done.float().mean()) < 1.0


# the clamp and gate edges of K7 only show in large streams: a small and a
# medium one (~10^5 slots, pixels saturating deep into their segments);
# the cull matters with splats larger than a 16 x 8 pixel group at blocks
# of 16 and 32 (one and two CUDA blocks per cluster) and 64 (four)
@pytest.mark.parametrize("n,res,block,scale", [
    (800, 128, 64, 0.05), (40000, 256, 64, 0.05), (3000, 128, 32, 0.2),
    (3000, 64, 16, 0.2), (3000, 256, 64, 0.3)])
def test_stream_bwd_kernel_matches_twin(cuda, n, res, block, scale):
    args = _stream_case(cuda, n, res, block=block, scale=scale)
    splanes = args[0]
    out = sr.stream_blend(*args)
    rng = np.random.default_rng(3)
    g = torch.zeros_like(out)
    g[:, 0:4] = torch.from_numpy(rng.normal(size=(out.shape[0], 4,
                                                  out.shape[2]))
                                 .astype(np.float32)).to(cuda)
    before = sr.stream_blend_bwd.launches
    bwd_args = (args[2], args[3], args[5])  # nbx, B, alpha_min
    got = sr.stream_blend_bwd(splanes, args[1], out, g, *bwd_args)
    assert sr.stream_blend_bwd.launches == before + 1
    want = sr.stream_blend_bwd_ref(splanes, args[1], out, g, *bwd_args)
    # transmittance recovered by division in another order: 1e-4 of each
    # row group's largest entry (position, conic, log opacity, colors)
    for rows in (slice(0, 2), slice(2, 5), slice(5, 6), slice(6, 9)):
        scale = float(want[rows].abs().max())
        assert scale > 0
        err = float((got[rows] - want[rows]).abs().max())
        assert err <= 1e-4 * scale, (rows, err, scale)
    # slots no pixel blends get exact zeros (past every last contributor,
    # past the last segment), as in the twin
    dead = (want == 0).all(dim=0)
    assert bool(dead[int(args[1][-1]):].all())
    assert float(got[:, dead].abs().max()) == 0.0
    # the sums run in a fixed order: a rerun gives the bits
    assert torch.equal(got, sr.stream_blend_bwd(splanes, args[1], out, g,
                                                *bwd_args))


def test_simulate_gpu_matches_cpu(cuda, tmp_path):
    frames = {}
    for dev in ("cuda", "cpu"):
        cfg = _cfg(tmp_path / dev)
        frames[dev] = simulate(cfg, synthetic=512, frames=2, quiet=True,
                               synthetic_res=64, device=dev)
    for a, b in zip(frames["cuda"], frames["cpu"]):
        # float-atomic sum order over 20 substeps, then the render
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_mpm_solver_gpu_runs_kernels_and_matches_cpu(cuda):
    """sim.MPMSolver on CUDA steps with the tiled engine through K1 / K2
    (one launch each a substep, never the twins) and agrees with the CPU
    solver forced onto the twins to the float atomics' order (1e-4 of each
    field's max, as test_simulate_gpu_matches_cpu's frames)."""
    from gsmpm_tpu_torch.sim import MPMSolver

    rng = np.random.default_rng(3)
    n = 2000
    xyz = rng.uniform(0.6, 1.4, size=(n, 3)).astype(np.float32)
    cov6 = np.tile(np.float32([1e-4, 0, 0, 1e-4, 0, 1e-4]), (n, 1))
    v0 = rng.normal(size=(n, 3)).astype(np.float32)
    cfg = _cfg(Path("."), n_grid=24).mpm
    solvers = {}
    for dev in ("cuda", "cpu"):
        s = MPMSolver(xyz, cov6, np.full(n, 2e-4, np.float32), cfg, v0,
                      device=dev)
        s.use_tiled = True
        s.set_bc_ground_only()
        s.add_surface_collider((0, 0, 0.4), (0, 0, 1))
        solvers[dev] = s
    steps = cfg.steps_per_frame
    for frame in range(2):
        cuda_mpm.p2g_tiled.launches = cuda_mpm.g2p_tiled.launches = 0
        solvers["cuda"].step_frame()
        assert cuda_mpm.p2g_tiled.launches == steps
        assert cuda_mpm.g2p_tiled.launches == steps
        solvers["cpu"].step_frame()
        assert solvers["cuda"].time == solvers["cpu"].time
        for f in ("x", "v", "C", "F", "F_trial"):
            got = getattr(solvers["cuda"].state, f).cpu()
            want = getattr(solvers["cpu"].state, f)
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= 1e-4, (frame, f, err)
    assert solvers["cuda"].use_tiled


# ---------------------------------------------------------------------------
# K4 / K5 tile blend, K6 second-order reductions, the fit frame
# ---------------------------------------------------------------------------

def _blend_case(dev, counts, K, B=64, seed=0):
    """Random depth-ordered candidate windows: (counts, F, meta).  Faint
    splats (opacity 0.004-0.05), so pixels stay open deep into K."""
    rng = np.random.default_rng(seed)
    nb = len(counts)
    s = rng.uniform(1.0, 6.0, size=(nb, K))
    cand = np.zeros((10, nb, K), np.float32)
    cand[0:2] = rng.uniform(-8.0, B + 8.0, size=(2, nb, K))
    cand[2] = 1.0 / (s * s)
    cand[3] = rng.uniform(-0.2, 0.2, size=(nb, K)) / (s * s)
    cand[4] = 1.0 / (s * s)
    cand[5] = np.log(rng.uniform(0.004, 0.05, size=(nb, K)))
    cand[6:9] = rng.uniform(0.0, 1.0, size=(3, nb, K))
    cand[9] = np.ceil(3.0 * s)
    live = np.arange(K)[None, :] < np.asarray(counts)[:, None]
    cand[5] = np.where(live, cand[5], -1e30)
    org = torch.zeros((nb, 1), device=dev)
    F = cb._build_F(torch.from_numpy(cand).to(dev), org, org, B).contiguous()
    meta = cb.BlendMeta(64, B, 1e-4, 1.0 / 255.0, -(-K // 64))
    return torch.tensor(counts, dtype=torch.int32, device=dev), F, meta


# gsmpm_tpu's TPU-only RasterConfig knobs, accepted and unused here
TPU_KNOBS = dict(block_batch=4, remat=False, skip_empty=False, impl="xla",
                 sel="v1", stream_unroll=2, stream_chunk=256)


@pytest.mark.parametrize("stream", [False, True])
def test_raster_config_tpu_knobs_render_bit_equal(cuda, stream):
    """A RasterConfig that sets every TPU-only knob renders the bits of
    the default one, through the windowed blend (K4) and the stream blend
    (K3)."""
    from gsmpm_tpu_torch.render import RasterConfig, render

    rng = np.random.default_rng(12)
    n, res = 3000, 128
    means = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    means[:, 2] += 4.0
    A = 0.05 * rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    C = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    args = (C(means), C(cov6),
            C(rng.uniform(0.15, 0.95, size=n).astype(np.float32)),
            C(rng.normal(size=(n, 4, 3)).astype(np.float32)),
            make_camera(res, res, 0.9, 0.9, np.eye(3), np.zeros(3)),
            torch.ones(3, device=cuda), 1)
    launches = (cb.blend_fwd.launches, sr.stream_blend.launches)
    want = render(*args, RasterConfig(stream=stream))
    got = render(*args, RasterConfig(stream=stream, **TPU_KNOBS))
    assert torch.equal(got, want)
    k4, k3 = (cb.blend_fwd.launches - launches[0],
              sr.stream_blend.launches - launches[1])
    assert (k3, k4) == ((2, 0) if stream else (0, 2))


# K: the TPU's resident / streamed windows; B 32 and 16 take splats larger
# than a 16 x 8 pixel group, in clusters of one CUDA block
@pytest.mark.parametrize("K,B", [(768, 64), (20480, 64), (768, 32),
                                 (768, 16)])
def test_blend_kernels_match_twins(cuda, K, B):
    counts, F, meta = _blend_case(cuda, [K, K // 2, 7, 0], K, B=B)
    before = (cb.blend_fwd.launches, cb.blend_bwd.launches)
    out = cb.blend_fwd(counts, F, meta)
    want = cb.blend_core_ref(counts, F, meta)
    # sequential vs chunked transmittance products round differently, and
    # may flip a pixel's stop decision at t_min
    assert float((out[:, 0:4] - want[:, 0:4]).abs().max()) <= 2e-3
    assert float((out[:, 4] != want[:, 4]).float().mean()) <= 1e-3
    assert float((out[:, 5] != want[:, 5]).float().mean()) <= 1e-3
    assert float(out[:, 5].max()) > 0.5 * K  # the walk went deep

    rng = np.random.default_rng(1)
    g = torch.zeros_like(out)
    g[:, 0:4] = torch.from_numpy(rng.normal(size=(4, 4, meta.P))
                                 .astype(np.float32)).to(cuda)
    dF = cb.blend_bwd(F, out, g, meta)
    dF_ref = cb.blend_core_bwd_ref(F, out, g, meta)
    assert (cb.blend_fwd.launches, cb.blend_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    # transmittance recovered by division in another order: 1e-4 of each
    # row group's largest entry (quadratic form, log opacity, colors)
    for rows in (slice(0, 6), slice(6, 7), slice(8, 11)):
        scale = float(dF_ref[:, rows].abs().max())
        assert scale > 0
        err = float((dF[:, rows] - dF_ref[:, rows]).abs().max())
        assert err <= 1e-4 * scale, (rows, err, scale)
    assert float(dF[:, 11:].abs().max()) == 0.0
    assert float(dF[:, 7].abs().max()) == 0.0
    # the per-candidate sums run in a fixed order: a rerun gives the bits
    assert torch.equal(dF, cb.blend_bwd(F, out, g, meta))


def _pack(Fpad, counts, C):
    """Padded windows Fpad (nb, 16, K) stored back to back at chunk-aligned
    offsets, plus C unowned tail slots: (offs, F (16, T))."""
    aligned = [-(-c // C) * C for c in counts]
    offs = np.concatenate([[0], np.cumsum(aligned)[:-1]]).astype(np.int32)
    F = torch.zeros((16, sum(aligned) + C), device=Fpad.device)
    for b, (o, a) in enumerate(zip(offs, aligned)):
        F[:, o:o + a] = Fpad[b, :, :a]
    return torch.from_numpy(offs).to(Fpad.device), F


def _packed_case(dev, counts, K, seed=0, B=64):
    """The windows of _blend_case packed (_pack): (counts, offs, F (16, T),
    padded F, meta)."""
    counts_t, Fpad, meta = _blend_case(dev, counts, K, B=B, seed=seed)
    offs, F = _pack(Fpad, counts, meta.C)
    return counts_t, offs, F, Fpad, meta


@pytest.mark.parametrize("K,B", [(768, 64), (20480, 64), (768, 32)])
def test_packed_blend_kernels_match_twins(cuda, K, B):
    counts, offs, F, Fpad, meta = _packed_case(cuda, [K, K // 2, 7, 0], K,
                                               B=B)
    before = (cb.blend_packed_fwd.launches, cb.blend_packed_bwd.launches)
    out = cb.blend_packed_fwd(counts, offs, F, meta)
    want = cb.blend_packed_ref(counts, offs, F, meta)
    # as K4: sequential vs chunked transmittance products
    assert float((out[:, 0:4] - want[:, 0:4]).abs().max()) <= 2e-3
    assert float((out[:, 4] != want[:, 4]).float().mean()) <= 1e-3
    assert float((out[:, 5] != want[:, 5]).float().mean()) <= 1e-3
    assert float(out[:, 5].max()) > 0.5 * K  # the walk went deep
    # K8 is K4's code on another addressing: the same bits
    assert torch.equal(out, cb.blend_fwd(counts, Fpad, meta))

    rng = np.random.default_rng(1)
    g = torch.zeros_like(out)
    g[:, 0:4] = torch.from_numpy(rng.normal(size=(4, 4, meta.P))
                                 .astype(np.float32)).to(cuda)
    dF = cb.blend_packed_bwd(counts, offs, F, out, g, meta)
    dF_ref = cb.blend_packed_bwd_ref(counts, offs, F, out, g, meta)
    assert (cb.blend_packed_fwd.launches, cb.blend_packed_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for rows in (slice(0, 6), slice(6, 7), slice(8, 11)):
        scale = float(dF_ref[:, rows].abs().max())
        assert scale > 0
        err = float((dF[:, rows] - dF_ref[:, rows]).abs().max())
        assert err <= 1e-4 * scale, (rows, err, scale)
    assert float(dF[11:].abs().max()) == 0.0
    assert float(dF[7].abs().max()) == 0.0
    assert float(dF[:, -meta.C:].abs().max()) == 0.0  # unowned tail
    # K9 is K5's deterministic code on another addressing: the same bits
    dF_pad = cb.blend_bwd(Fpad, out, g, meta)
    for b, o in enumerate(offs.tolist()):
        a = -(-int(counts[b]) // meta.C) * meta.C
        assert torch.equal(dF[:, o:o + a], dF_pad[b, :, :a])


@pytest.mark.parametrize("B", [16, 32, 64])
def test_blend_bwd_on_crafted_windows(cuda, B):
    """K5 and K9 on tests/test_torch_cull_windows.py's crafted windows
    (splats of 0.3 to 40 pixels, larger than a pixel group and centred
    outside the block, conics not positive definite or near-singular,
    opacities from below alpha_min to 0.9999, dead columns) against the
    twins; two K5 launches give the same bits, and so does K9 on the same
    windows."""
    from test_torch_cull_windows import crafted_windows

    Fpad, _ = crafted_windows(B, nb=4, K=512, seed=B)
    counts_l = [512, 384, 100, 0]
    for b, c in enumerate(counts_l):
        Fpad[b, 6, c:] = cb.NEG  # past a window's count: dead, as built
    Fpad = Fpad.to(cuda).contiguous()
    counts = torch.tensor(counts_l, dtype=torch.int32, device=cuda)
    meta = cb.BlendMeta(64, B, 1e-4, 1.0 / 255.0, 512 // 64)
    out = cb.blend_fwd(counts, Fpad, meta)
    assert float(out[:, 5].max()) > 100  # the blend went past a step
    rng = np.random.default_rng(2)
    g = torch.zeros_like(out)
    g[:, 0:4] = torch.from_numpy(rng.normal(size=(4, 4, meta.P))
                                 .astype(np.float32)).to(cuda)
    dF = cb.blend_bwd(Fpad, out, g, meta)
    want = cb.blend_core_bwd_ref(Fpad, out, g, meta)
    for rows in (slice(0, 6), slice(6, 7), slice(8, 11)):
        scale = float(want[:, rows].abs().max())
        assert scale > 0
        err = float((dF[:, rows] - want[:, rows]).abs().max())
        assert err <= 1e-4 * scale, (rows, err, scale)
    assert float(dF[:, 11:].abs().max()) == 0.0
    assert float(dF[:, 7].abs().max()) == 0.0
    assert torch.equal(dF, cb.blend_bwd(Fpad, out, g, meta))
    offs, F = _pack(Fpad, counts_l, meta.C)
    dF9 = cb.blend_packed_bwd(counts, offs, F, out, g, meta)
    for b, o in enumerate(offs.tolist()):
        a = -(-counts_l[b] // meta.C) * meta.C
        assert torch.equal(dF9[:, o:o + a], dF[b, :, :a])


def _sequential_fwd(F, counts, meta):
    """tests/test_torch_cull_windows.py's unculled sequential forward walk,
    on the card: torch's elementwise ops round as the kernels built without
    FMA contraction, so K4 / K8 give its bits."""
    from test_torch_cull_windows import sequential_walk

    return sequential_walk(F, counts, meta.B, meta.t_min, meta.alpha_min,
                           cull=False)


@pytest.mark.parametrize("B", [16, 32, 64])
def test_blend_fwd_on_crafted_windows(cuda, B):
    """K4 and K8 on tests/test_torch_cull_windows.py's crafted windows
    (splats of 0.3 to 40 pixels, larger than a pixel group and centred
    outside the block, conics not positive definite or near-singular,
    opacities from below alpha_min to 0.9999, dead columns) against the
    twins; the culled walk gives an unculled sequential walk's bits, two
    K4 launches give the same bits, and K8 on the same windows packed
    gives K4's."""
    from test_torch_cull_windows import crafted_windows

    Fpad, _ = crafted_windows(B, nb=4, K=512, seed=B + 1)
    counts_l = [512, 384, 100, 0]
    for b, c in enumerate(counts_l):
        Fpad[b, 6, c:] = cb.NEG  # past a window's count: dead, as built
    Fpad = Fpad.to(cuda).contiguous()
    counts = torch.tensor(counts_l, dtype=torch.int32, device=cuda)
    meta = cb.BlendMeta(64, B, 1e-2, 1.0 / 255.0, 512 // 64)
    before = (cb.blend_fwd.launches, cb.blend_packed_fwd.launches)
    out = cb.blend_fwd(counts, Fpad, meta)
    want = cb.blend_core_ref(counts, Fpad, meta)
    assert float((out[:, 0:4] - want[:, 0:4]).abs().max()) <= 2e-3
    assert float((out[:, 4] != want[:, 4]).float().mean()) <= 1e-3
    assert float((out[:, 5] != want[:, 5]).float().mean()) <= 1e-3
    assert float(out[:, 5].max()) > 100  # the blend went past a step
    assert 0 < int(out[:, 4].sum()) < out[:, 4].numel()
    assert torch.equal(out, _sequential_fwd(Fpad, counts, meta))
    assert torch.equal(out, cb.blend_fwd(counts, Fpad, meta))
    offs, F = _pack(Fpad, counts_l, meta.C)
    assert torch.equal(cb.blend_packed_fwd(counts, offs, F, meta), out)
    assert (cb.blend_fwd.launches, cb.blend_packed_fwd.launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("B,per", [(16, 1), (32, 1), (48, 3), (64, 4)])
def test_forward_walk_block_counts(cuda, B, per):
    """K4 / K8's launches report their CUDA blocks: ceil(groups / 8)
    blocks of 8 warps per pixel block, a group being 16 x 8 pixels."""
    assert cb.blend_fwd_blocks(40, B) == 40 * per


@pytest.mark.parametrize("B,per", [(16, 1), (32, 1), (48, 3), (64, 4)])
def test_reverse_walk_block_counts(cuda, B, per):
    """The reverse walks' launches report their CUDA blocks: a cluster of
    ceil(groups / 8) blocks per pixel block, a group being 16 x 8 pixels."""
    assert cb.blend_bwd_blocks(40, B) == 40 * per
    assert sr.stream_bwd_blocks(64, B) == 64 * per


def test_packed_window_outside_array_asserts(cuda):
    """A window past the packed array's end stops K8 with a device-side
    assert (no host sync checks it); run in a child process, whose CUDA
    context the assert ends."""
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_cuda as t\n"
        "dev = torch.device('cuda')\n"
        "counts, offs, F, _, meta = t._packed_case(dev, [768, 384, 7, 0], 768)\n"
        "t.cb.blend_packed_fwd(counts, offs + F.shape[1] // 2, F, meta)\n"
        "torch.cuda.synchronize()\n"
        "print('no assert')\n")
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], cwd=root, timeout=300,
                       capture_output=True, text=True)
    assert r.returncode != 0, r.stdout + r.stderr
    assert "no assert" not in r.stdout
    assert "assert" in (r.stdout + r.stderr).lower(), r.stdout + r.stderr


def _fit_ident(dev, n=512, n_grid=24, substeps=3, res=64):
    scene = synthetic_blob_scene(n=n, seed=5, radius=0.4,
                                 center=(0.0, 0.8, 0.0), device=dev)
    cfg = MPMConfig(material="jelly", E=1e4, nu=0.3, n_grid=n_grid,
                    grid_extent=2.0, gravity=[0.0, -9.81, 0.0], fitting=True)
    v = torch.tensor([[0.0, -2.0, 0.0]], device=dev).repeat(n, 1)
    ident = SystemIdentifier(
        scene, cfg, init_velocity=v,
        fit_cfg=FitConfig(substeps_per_frame=substeps),
        raster_cfg=tr.RasterConfig(block=32, chunk=32),
        bg=torch.ones(3, device=dev))
    cam = make_camera(res, res, 0.7, 0.7, np.eye(3),
                      np.array([0.0, 0.8, -3.0]))
    return ident, cam


def test_sored_kernel_matches_twin(cuda):
    ident, _ = _fit_ident(cuda)
    state = ident.reset_state()
    n = state.x.shape[0]
    tc = tiles.default_tile_config(ident.grid.n_grid, n)
    ts = tiles.bootstrap(soa_from_state(state), ident.model, ident.grid, tc)
    rng = np.random.default_rng(2)
    planes = torch.from_numpy(rng.normal(size=(tc.ntiles, 48, 256))
                              .astype(np.float32)).to(cuda)
    args = (ts.q, planes, ts.chunk_tile, ts.chunk_live, ident.grid, tc)
    before = cuda_mpm.sored_tiled.launches
    got = cuda_mpm.sored_tiled(*args)
    assert cuda_mpm.sored_tiled.launches == before + 1
    want = tv.sored_tiled_ref(*args)
    # fp32 sums over 27 nodes in another order: 1e-4 of each row group's
    # largest entry (d W, d U^k, d D^k of each window component)
    for c in range(3):
        for lo, hi in ((0, 3), (3, 12), (12, 21)):
            rows = slice(21 * c + lo, 21 * c + hi)
            scale = float(want[rows].abs().max())
            assert scale > 0
            err = float((got[rows] - want[rows]).abs().max())
            assert err <= 1e-4 * scale, (c, lo, err, scale)
    assert float(got[63].abs().max()) == 0.0


def _edge_tiled_state(dev, n_grid=32, n_bulk=300_000, n_face=2_000):
    """A tiled state over every tile of an n_grid^3 unit domain: n_bulk
    particles spread uniformly, n_face whose coordinate on each axis lies,
    with probability 1/3 each, within half a cell of the low face, of the
    high face or anywhere (so stencils fold at both faces of every axis,
    corners included).  Chunk tables of sharded_tile_config for 2 ranks."""
    from gsmpm_tpu_torch.parallel.tiled_sharded import sharded_tile_config
    from gsmpm_tpu_torch.sim.state import GridConfig

    rng = np.random.default_rng(7)
    grid = GridConfig(n_grid, 1.0)
    half = 0.5 * grid.dx
    kind = rng.integers(0, 3, (n_face, 3))       # per particle and axis
    coord = np.where(kind == 0, rng.uniform(0, half, (n_face, 3)),
                     np.where(kind == 1, rng.uniform(1 - half, 1, (n_face, 3)),
                              rng.uniform(0, 1, (n_face, 3))))
    x = np.concatenate([rng.uniform(0, 1, (n_bulk, 3)), coord])
    n = x.shape[0]
    tc = sharded_tile_config(n_grid, n, 2)
    NP = tc.np_rows
    q = torch.zeros((tiles.QROWS, NP), device=dev)
    q[tiles.RX:tiles.RX + 3, :n] = torch.from_numpy(
        x.T.astype(np.float32)).to(dev)
    q[tiles.RMASS, :n] = 1.0
    zeros = torch.zeros((tc.nchunk,), dtype=torch.int32, device=dev)
    ts = tiles.TiledState(
        q=q, aux=torch.zeros((tiles.AUXROWS, NP), device=dev),
        material=torch.zeros((NP,), dtype=torch.int32, device=dev),
        orig=torch.cat([torch.arange(n, device=dev),
                        torch.full((NP - n,), -1, device=dev)]),
        chunk_tile=zeros, chunk_first=zeros, chunk_live=zeros,
        need_rebucket=torch.zeros((), dtype=torch.bool, device=dev),
        ok=torch.ones((), dtype=torch.bool, device=dev))
    return tiles.rebucket(ts, grid, tc), grid, tc


def test_sored_kernel_edges(cuda):
    """K6's persistent grid at its edges, against the twin: CTAs whose
    chunks lie in several tiles, the dead tail (exact zeros, as row 63),
    stencils folded at both faces of every axis, a rank's slice of the
    chunk tables (parallel/tiled_sharded.shard_tiled) whose chunk count
    does not divide among the CTAs, chunks in a shuffled order (tables
    that revisit tiles, dead chunks among live ones), and two launches
    with equal bits."""
    from gsmpm_tpu_torch.parallel.mesh import Mesh
    from gsmpm_tpu_torch.parallel.tiled_sharded import shard_tiled

    ts, grid, tc = _edge_tiled_state(cuda)
    assert bool(ts.ok)
    mesh = Mesh(axis_names=("data",), sizes=(2,), rank=1, world_size=2,
                device=cuda, group=None, coords=(1,), axis_groups=(None,))
    ts1 = shard_tiled(ts, mesh, tc)
    ncl = tc.nchunk // 2
    # the rank's slice as its own tile config: the same cap, ncl chunks
    tc1 = tc._replace(n_particles=(ncl - tc.occ_cap) * tc.S)
    assert tc1.nchunk == ncl
    rng = np.random.default_rng(3)
    perm = torch.from_numpy(rng.permutation(tc.nchunk)).to(cuda)
    slots = (perm[:, None] * tc.S + torch.arange(tc.S, device=cuda)).ravel()
    shuffled = (ts.q[:, slots].contiguous(), ts.chunk_tile[perm].contiguous(),
                ts.chunk_live[perm].contiguous())
    planes = torch.from_numpy(rng.normal(size=(tc.ntiles, 48, 256))
                              .astype(np.float32)).to(cuda)
    for q, ctile, clive, cfg in (
            (ts.q, ts.chunk_tile, ts.chunk_live, tc),
            (ts1.q, ts1.chunk_tile, ts1.chunk_live, tc1),
            shuffled + (tc,)):
        live = clive.cpu().numpy() == 1
        nchunk = cfg.nchunk
        info = cuda_mpm.sored_launch_info(nchunk)
        n = info["ctas"]
        assert info["local_bytes"] == 0, info
        # what the edges need: dead chunks, more chunks than CTAs and a
        # remainder, and a CTA (chunks cta, cta + n, ...) whose live
        # chunks lie in two tiles
        assert not live.all() and nchunk > n and nchunk % n, (nchunk, n)
        tiles_of = ctile.cpu().numpy()
        assert max(np.unique(tiles_of[i::n][live[i::n]]).size
                   for i in range(n)) >= 2
        args = (q, planes, ctile, clive, grid, cfg)
        # stale NaNs where the output will be allocated: every element the
        # kernel leaves unwritten would show
        torch.full((64, cfg.np_rows), float("nan"), device=cuda)
        got = cuda_mpm.sored_tiled(*args)
        again = cuda_mpm.sored_tiled(*args)
        want = tv.sored_tiled_ref(*args)
        assert torch.equal(got, again)
        for c in range(3):
            for lo, hi in ((0, 3), (3, 12), (12, 21)):
                rows = slice(21 * c + lo, 21 * c + hi)
                scale = float(want[rows].abs().max())
                assert scale > 0
                err = float((got[rows] - want[rows]).abs().max())
                assert err <= 1e-4 * scale, (c, lo, err, scale)
        assert float(got[63].abs().max()) == 0.0
        dead = torch.from_numpy(np.repeat(~live, cfg.S)).to(cuda)
        assert float(got[:, dead].abs().max()) == 0.0
        assert bool(torch.isfinite(got).all())


def test_fit_frame_gpu_matches_cpu(cuda):
    """One fit frame (3 tiled-VJP substeps, the windowed render, loss,
    backward, SGD) on the GPU kernels and on the CPU twins."""
    res = {}
    gt = None
    for dev in ("cpu", "cuda"):
        ident, cam = _fit_ident(torch.device(dev))
        ident._sim_engine = "tiled_vjp"
        if gt is None:
            gt = ident.generate_ground_truth(3e3, 0.3, [cam], 2)[1].cpu()
        state = ident.reset_state()
        loss, st, _, img = ident.fit_frame(state, 0.0, cam, gt.to(dev))
        assert ident.sim_engine == "tiled_vjp"
        res[dev] = (float(loss), img.cpu(), [g.cpu() for g in
                                            ident.last_grads], st.x.cpu())
    (lc, ic, gc, xc), (lg, ig, gg, xg) = res["cpu"], res["cuda"]
    # float atomics over 3 substeps, then the render and its reverse walk
    assert abs(lc - lg) <= 1e-6
    assert float((ic - ig).abs().max()) <= 1e-3
    assert float((xc - xg).abs().max()) <= 1e-4
    for a, b in zip(gc, gg):
        assert float((a - b).abs().max()) <= 1e-3 * float(a.abs().max())


# ---------------------------------------------------------------------------
# the tiled frame's substep graph (sim/tiles.py: frame_tiled on CUDA)
# ---------------------------------------------------------------------------

GRAPH_STEPS = 20


def _graph_case(dev, n=4000):
    """A seeded box on the 24^3 grid thrown along +x at ~8 m/s (it crosses
    two cells within a frame of GRAPH_STEPS substeps, so the frame
    rebuckets), the ground collider, an impulse over substeps 3-6 and a
    fixed cube over substeps 8-12: (solver, tile config, bootstrap)."""
    from gsmpm_tpu_torch.config import BoundaryConditionConfig
    from gsmpm_tpu_torch.sim import MPMSolver

    rng = np.random.default_rng(11)
    xyz = rng.uniform(0.6, 1.4, size=(n, 3)).astype(np.float32)
    cov6 = np.tile(np.float32([1e-4, 0, 0, 1e-4, 0, 1e-4]), (n, 1))
    v0 = (np.float32([8.0, 0.0, 0.0])
          + 0.5 * rng.normal(size=(n, 3))).astype(np.float32)
    cfg = _cfg(Path("."), n_grid=24).mpm
    dt = cfg.substep_dt
    s = MPMSolver(xyz, cov6, np.full(n, 2e-4, np.float32), cfg, v0,
                  device=dev)
    s.set_boundary_conditions([
        BoundaryConditionConfig(type="impulse", center=[1.0, 1.0, 1.0],
                                size=[0.2, 0.4, 0.4], force=[0.0, 0.2, 0.0],
                                start_time=3 * dt, num_dt=4),
        BoundaryConditionConfig(type="fixed_cube", center=[1.3, 1.0, 1.0],
                                size=[0.1, 0.2, 0.2], start_time=8 * dt,
                                num_dt=5)])
    s.add_surface_collider((0, 0, 0.4), (0, 0, 1))
    tc = tiles.default_tile_config(cfg.n_grid, n)
    ts = tiles.bootstrap(soa_from_state(s.state), s.model, s.grid, tc)
    return s, tc, ts


def _graph_counts():
    f = tiles.frame_tiled
    return dict(captures=f.captures, replays=f.replays,
                host_reads=f.host_reads, rebuckets=f.rebuckets,
                k1=cuda_mpm.p2g_tiled.launches, k2=cuda_mpm.g2p_tiled.launches,
                k1_captured=cuda_mpm.p2g_tiled.captured,
                k2_captured=cuda_mpm.g2p_tiled.captured)


def _delta(before):
    return {k: v - before[k] for k, v in _graph_counts().items()}


def _eager_frame(s, tc, ts, model=None, steps=GRAPH_STEPS):
    t = 0.0
    for _ in range(steps):
        ts = tiles.substep_tiled(ts, model or s.model, s.bcs, t, s.grid, tc,
                                 s.cfg.substep_dt)
        t = tiles._advance(t, s.cfg.substep_dt)
    return ts, t


def _assert_close(got, want, n):
    """Original-order rows of two tiled states: K1's float atomics add in a
    run-dependent order, so 1e-4 of each field's largest magnitude (the
    GPU-vs-CPU solver test's tolerance)."""
    a = tiles.to_original_order(got, n)
    b = tiles.to_original_order(want, n)
    for name, lo, hi in (("x", tiles.RX, tiles.RX + 3),
                         ("v", tiles.RV, tiles.RV + 3),
                         ("C", tiles.RC, tiles.RC + 9),
                         ("F", tiles.RF, tiles.RF + 9),
                         ("F_trial", tiles.RFT, tiles.RFT + 9)):
        scale = float(b[lo:hi].abs().max())
        err = float((a[lo:hi] - b[lo:hi]).abs().max())
        assert err <= 1e-4 * max(scale, 1e-30), (name, err, scale)


def test_frame_graph_matches_eager_loop(cuda):
    """frame_tiled on CUDA replays a captured substep: against the eager
    substep_tiled loop from the same state, one capture, one host read a
    substep, K1 / K2 once a substep (the warm-up's launches and the
    replays counted, the capture not), and the device clock's bits equal
    the returned host clock's."""
    s, tc, ts0 = _graph_case(cuda)
    n = s.state.n_particles
    want, t_want = _eager_frame(s, tc, ts0)
    before = _graph_counts()
    ts, _, t = tiles.frame_tiled(ts0, soa_from_state(s.state), s.model,
                                 s.bcs, 0.0, GRAPH_STEPS, s.grid, tc,
                                 s.cfg.substep_dt)
    d = _delta(before)
    assert d["captures"] == 1 and d["replays"] == GRAPH_STEPS - 1
    assert d["host_reads"] == GRAPH_STEPS
    assert d["k1"] == d["k2"] == GRAPH_STEPS
    assert d["k1_captured"] == d["k2_captured"] == 1
    assert t == t_want
    clock = next(reversed(tiles._GRAPHS.values())).clock
    assert clock.cpu().numpy().view(np.uint32) == np.float32(t).view(
        np.uint32)
    assert bool(ts.ok)
    _assert_close(ts, want, n)
    # the returned state owns its tensors: a second frame leaves it
    q = ts.q.clone()
    before = _graph_counts()
    tiles.frame_tiled(ts, soa_from_state(s.state), s.model, s.bcs, t,
                      GRAPH_STEPS, s.grid, tc, s.cfg.substep_dt)
    d = _delta(before)
    assert d["captures"] == 0 and d["replays"] == GRAPH_STEPS
    assert d["k1"] == d["k2"] == GRAPH_STEPS
    assert torch.equal(ts.q, q)


def test_frame_graph_rebuckets_without_recapture(cuda):
    """A rebucket inside the frame runs eagerly between replays and copies
    its tables into the graph's buffers: no second capture, and the frame
    still matches the eager loop."""
    s, tc, ts0 = _graph_case(cuda)
    want, _ = _eager_frame(s, tc, ts0)
    before = _graph_counts()
    ts, _, _ = tiles.frame_tiled(ts0, soa_from_state(s.state), s.model,
                                 s.bcs, 0.0, GRAPH_STEPS, s.grid, tc,
                                 s.cfg.substep_dt)
    d = _delta(before)
    assert d["rebuckets"] >= 1 and d["captures"] == 1
    assert not torch.equal(ts.chunk_tile, ts0.chunk_tile)
    _assert_close(ts, want, s.state.n_particles)


def test_frame_graph_recaptures_for_a_new_model(cuda):
    """A model with other tensors (here gravity along +x) is a new graph:
    one more capture, and its frame follows the new model."""
    s, tc, ts0 = _graph_case(cuda)
    soa, dt = soa_from_state(s.state), s.cfg.substep_dt
    tiles.frame_tiled(ts0, soa, s.model, s.bcs, 0.0, 2, s.grid, tc, dt)
    model = dataclasses.replace(
        s.model, gravity=torch.tensor([50.0, 0.0, 0.0], device=cuda))
    before = _graph_counts()
    ts, _, _ = tiles.frame_tiled(ts0, soa, model, s.bcs, 0.0, GRAPH_STEPS,
                                 s.grid, tc, dt)
    assert _delta(before)["captures"] == 1
    want, _ = _eager_frame(s, tc, ts0, model=model)
    _assert_close(ts, want, s.state.n_particles)
    before = _graph_counts()
    tiles.frame_tiled(ts0, soa, s.model, s.bcs, 0.0, 2, s.grid, tc, dt)
    assert _delta(before)["captures"] == 0  # the first model's graph kept


# ---------------------------------------------------------------------------
# the fitting window's graphs (sim/tiles.py: _FittingWindow on CUDA)
# ---------------------------------------------------------------------------

FIT_SUBSTEPS = 30
# graph against the checkpointed eager window from one state: K1's float
# atomics add in a run-dependent order (forward, recompute), so the rows
# within 1e-4 of each field's largest magnitude (_assert_close) and the
# gradients within 1e-3 of theirs (test_fit_frame_gpu_matches_cpu's)
FIT_GRAD_REL = 1e-3


def _thrown_ident(dev, n=512):
    """_fit_ident's blob thrown along +x at ~10 m/s (seeded spread) for
    FIT_SUBSTEPS substeps a frame: its window rebuckets twice."""
    ident, cam = _fit_ident(dev, n=n, substeps=FIT_SUBSTEPS)
    rng = np.random.default_rng(21)
    v = (np.float32([10.0, -2.0, 0.0]) + 0.5 * rng.normal(size=(n, 3)))
    ident.init_velocity = torch.from_numpy(v.astype(np.float32)).to(dev)
    return ident, cam


def _fit_graph_counts():
    f = tiles.run_substeps_tiled_fitting
    return dict(captures=f.captures, replays=f.replays,
                host_reads=f.host_reads, rebuckets=f.rebuckets,
                k1=cuda_mpm.p2g_tiled.launches, k2=cuda_mpm.g2p_tiled.launches,
                k6=cuda_mpm.sored_tiled.launches,
                k1_captured=cuda_mpm.p2g_tiled.captured,
                k2_captured=cuda_mpm.g2p_tiled.captured,
                k6_captured=cuda_mpm.sored_tiled.captured)


def _fit_delta(before):
    return {k: v - before[k] for k, v in _fit_graph_counts().items()}


def _window(ident, state, graph: bool, group=None):
    """The fitting window from state and d(loss)/d(logE, y) through it:
    run_substeps_tiled_fitting (on CUDA the graphs) or the checkpointed
    substep_tiled_fitting loop, the grid summed over ``group`` when given.
    Returns (tiled rows in original order, gradients, ok)."""
    from gsmpm_tpu_torch.sim.state import mu_lam_from_logE_y

    logE = ident.model.logE.detach().clone().requires_grad_(True)
    y = ident.model.y.detach().clone().requires_grad_(True)
    n, dt = state.x.shape[0], 0.03 / FIT_SUBSTEPS
    with torch.enable_grad():
        mu, lam = mu_lam_from_logE_y(logE, y)
        model = dataclasses.replace(ident.model, logE=logE, y=y, mu=mu,
                                    lam=lam)
        soa = soa_from_state(state)
        tc = tiles.default_tile_config(ident.grid.n_grid, n)
        if graph:
            out, _, ok = tiles.run_substeps_tiled_fitting(
                soa, model, ident.bcs, 0.0, FIT_SUBSTEPS, ident.grid, dt,
                group=group)
            q = tiles.pack_q(out)
        else:
            ts = tiles.bootstrap(soa, model, ident.grid, tc)
            for _ in range(FIT_SUBSTEPS):
                ts = tiles.substep_tiled_fitting(ts, model, ident.bcs, 0.0,
                                                 ident.grid, tc, dt,
                                                 group=group)
            ok, q = ts.ok, tiles.to_original_order(ts, n)
        x, v, F = q[tiles.RX:tiles.RX + 3], q[tiles.RV:tiles.RV + 3], \
            q[tiles.RF:tiles.RF + 9]
        loss = (torch.sum(x * torch.sin(x)) + torch.sum(F * F)
                + 0.1 * torch.sum(v * v))
    grads = torch.autograd.grad(loss, (logE, y))
    return q.detach(), grads, bool(ok)


def _assert_rows_close(a, b):
    for name, lo, hi in (("x", tiles.RX, tiles.RX + 3),
                         ("v", tiles.RV, tiles.RV + 3),
                         ("C", tiles.RC, tiles.RC + 9),
                         ("F", tiles.RF, tiles.RF + 9)):
        scale = float(b[lo:hi].abs().max())
        err = float((a[lo:hi] - b[lo:hi]).abs().max())
        assert err <= 1e-4 * max(scale, 1e-30), (name, err, scale)


def test_fit_graph_window_matches_checkpointed(cuda):
    """The window's two graphs (30 forward replays, 30 adjoint replays,
    two rebuckets in between) against the checkpointed eager window from
    the same state: rows within 1e-4 and d logE / d y within FIT_GRAD_REL
    of their largest magnitudes; then a second window replays only."""
    ident, _ = _thrown_ident(cuda)
    state = ident.reset_state()
    q_e, g_e, ok_e = _window(ident, state, graph=False)
    before = _fit_graph_counts()
    q_g, g_g, ok_g = _window(ident, state, graph=True)
    d = _fit_delta(before)
    assert ok_e and ok_g
    assert d["rebuckets"] >= 1 and d["host_reads"] == FIT_SUBSTEPS
    assert d["captures"] + d["replays"] == 2 * FIT_SUBSTEPS
    _assert_rows_close(q_g, q_e)
    for a, b in zip(g_g, g_e):
        assert float((a - b).abs().max()) <= FIT_GRAD_REL * float(
            b.abs().max())
    before = _fit_graph_counts()
    q_2, _, _ = _window(ident, state, graph=True)
    d = _fit_delta(before)
    assert d["captures"] == 0 and d["replays"] == 2 * FIT_SUBSTEPS
    assert d["rebuckets"] >= 1  # the rebuckets copy into the same buffers
    _assert_rows_close(q_2, q_e)


def test_fit_graph_launches_per_fit_frame(cuda):
    """fit_frame through the graphs: K1 / K2 / K6 exactly 90 / 150 / 60 a
    frame of 30 substeps, the replays' launches counted and the captures'
    not; a later frame (new logE / y after the SGD step) captures
    nothing."""
    ident, cam = _thrown_ident(cuda)
    gt = ident.generate_ground_truth(3e3, 0.3, [cam], 2)[1]
    state = ident.reset_state()
    want = dict(k1=3 * FIT_SUBSTEPS, k2=5 * FIT_SUBSTEPS,
                k6=2 * FIT_SUBSTEPS)
    for frame in range(3):
        logE = ident.model.logE.clone()
        before = _fit_graph_counts()
        _, state, t, _ = ident.fit_frame(state, 0.03 * frame, cam, gt)
        d = _fit_delta(before)
        assert ident.sim_engine == "tiled_vjp"
        assert ident._total_rebuilds == 0
        assert {k: d[k] for k in want} == want, (frame, d)
        assert d["captures"] + d["replays"] == 2 * FIT_SUBSTEPS
        assert not torch.equal(ident.model.logE, logE)
        if frame:
            assert d["captures"] == 0
            assert d["k1_captured"] == d["k2_captured"] == 0
            assert d["k6_captured"] == 0
    # the returned state and gradients own their tensors: the next frame's
    # replays leave them
    held = [state.x, state.F, *ident.last_grads]
    copies = [h.clone() for h in held]
    ident.fit_frame(state, t, cam, gt)
    for h, c in zip(held, copies):
        assert torch.equal(h, c)


def test_fit_graph_cap_bump_rerun_replays(cuda):
    """A render that drops candidates re-runs the same frame after a cap
    resize (sim/fitting.py's _drop_free): the re-runs replay the captured
    graphs, and the frame's final launches are a whole window's."""
    ident, cam = _thrown_ident(cuda)
    gt = ident.generate_ground_truth(3e3, 0.3, [cam], 2)[1]
    state = ident.reset_state()
    ident.fit_frame(state, 0.0, cam, gt)  # the graphs are captured
    ident.raster_cfg = ident.raster_cfg._replace(k_tile=8, k_coarse=8,
                                                 k_global=8)
    rebuilds = ident._total_rebuilds
    before = _fit_graph_counts()
    ident.fit_frame(state, 0.0, cam, gt)
    d = _fit_delta(before)
    tries = ident._total_rebuilds - rebuilds + 1
    assert tries >= 2 and ident.n_dropped_last == 0
    assert d["captures"] == 0
    # every try replays the forward graph, the backward runs once
    assert d["replays"] == (tries + 1) * FIT_SUBSTEPS
    assert d["k6"] == 2 * FIT_SUBSTEPS


def test_fit_graph_overflow_takes_golden_eager(cuda, monkeypatch):
    """A tile cap below the blob's occupied tiles: the window reports the
    overflow, fit_frame moves to the golden engine for good and redoes the
    frame there: no tiled replay and no K1 / K2 / K6 launch; the golden
    window's graphs (sim/solver.py) replay, 2 a substep, captured once."""
    ident, cam = _thrown_ident(cuda)
    gt = ident.generate_ground_truth(3e3, 0.3, [cam], 2)[1]
    real = tiles.default_tile_config
    monkeypatch.setattr(tiles, "default_tile_config",
                        lambda g, n: real(g, n)._replace(n_occ_cap=1))
    state = ident.reset_state()
    loss, state, t, _ = ident.fit_frame(state, 0.0, cam, gt)
    assert ident.sim_engine == "golden" and np.isfinite(float(loss))
    before, golden = _fit_graph_counts(), _golden_counts()
    loss, _, _, _ = ident.fit_frame(state, t, cam, gt)
    d, g = _fit_delta(before), _golden_delta(golden)
    assert np.isfinite(float(loss))
    assert d["replays"] == d["captures"] == d["host_reads"] == 0
    assert d["k1"] == d["k2"] == d["k6"] == 0
    assert g["captures"] == 0 and g["replays"] == 2 * FIT_SUBSTEPS


# ---------------------------------------------------------------------------
# the golden engine's graphs (sim/solver.py: run_substeps on CUDA)
# ---------------------------------------------------------------------------

# (incremental_cov, fitting) of each golden frame
GOLDEN_MODES = {"plain": (False, False), "incremental_cov": (True, False),
                "fitting": (False, True)}
GOLDEN_FIELDS = ("x", "v", "C", "F", "F_trial", "cov")


def _golden_counts():
    from gsmpm_tpu_torch.sim import solver

    f = solver.run_substeps
    return dict(captures=f.captures, replays=f.replays,
                k1=cuda_mpm.p2g_tiled.launches, k2=cuda_mpm.g2p_tiled.launches,
                k6=cuda_mpm.sored_tiled.launches,
                captured=(cuda_mpm.p2g_tiled.captured
                          + cuda_mpm.g2p_tiled.captured
                          + cuda_mpm.sored_tiled.captured))


def _golden_delta(before):
    return {k: v - before[k] for k, v in _golden_counts().items()}


def _golden_eager(state, model, bcs, grid, dt, steps, inc=False, fit=False,
                  group=None, t=0.0):
    """The golden frame as the plain loop over substep_soa."""
    from gsmpm_tpu_torch.sim.kernels import state_from_soa, substep_soa

    soa = soa_from_state(state)
    for _ in range(steps):
        soa = substep_soa(soa, model, bcs, t, grid, dt, incremental_cov=inc,
                          group=group, fitting=fit)
        t = tiles._advance(t, dt)
    return state_from_soa(soa), t


def _assert_states_close(got, want, fields=GOLDEN_FIELDS):
    """index_add_'s float atomics add in a run-dependent order: 1e-4 of
    each field's largest magnitude."""
    for name in fields:
        a, b = getattr(got, name).detach(), getattr(want, name).detach()
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= 1e-4 * max(scale, 1e-30), (name, err, scale)


@pytest.mark.parametrize("mode", list(GOLDEN_MODES))
def test_golden_graph_matches_eager_loop(cuda, mode):
    """run_substeps on CUDA without autograd replays one captured golden
    substep: against the eager substep_soa loop from the same state (the
    _graph_case box with its impulse and fixed cube windows inside the
    frame) within 1e-4 of each field's max; one capture, then replays
    only; no K1 / K2 / K6 launch in it; the device clock's bits equal the
    returned host clock's; the returned state owns its tensors."""
    from gsmpm_tpu_torch.sim import solver

    inc, fit = GOLDEN_MODES[mode]
    s, _, _ = _graph_case(cuda)
    dt = s.cfg.substep_dt
    args = (s.model, s.bcs, 0.0, GRAPH_STEPS, s.grid, dt)
    want, t_want = _golden_eager(s.state, s.model, s.bcs, s.grid, dt,
                                 GRAPH_STEPS, inc, fit)
    before = _golden_counts()
    with torch.no_grad():
        got, t = solver.run_substeps(s.state, *args, incremental_cov=inc,
                                     fitting=fit, checkpoint_policy=None)
    d = _golden_delta(before)
    assert d["captures"] == 1 and d["replays"] == GRAPH_STEPS - 1
    assert d["k1"] == d["k2"] == d["k6"] == d["captured"] == 0
    assert t == t_want
    entry = next(reversed(solver._GOLDEN_GRAPHS.values()))
    assert entry.clock.cpu().numpy().view(np.uint32) == np.float32(t).view(
        np.uint32)
    _assert_states_close(got, want)
    held = got.x.clone()
    before = _golden_counts()
    with torch.no_grad():
        solver.run_substeps(s.state, *args, incremental_cov=inc,
                            fitting=fit, checkpoint_policy=None)
    d = _golden_delta(before)
    assert d["captures"] == 0 and d["replays"] == GRAPH_STEPS
    assert torch.equal(got.x, held)


def test_golden_graph_recaptures_for_a_new_model(cuda):
    """A model with other tensors (gravity along +x) is a new golden graph:
    one more capture, and its frame follows the new model; the first
    model's graph stays cached."""
    from gsmpm_tpu_torch.sim import solver

    s, _, _ = _graph_case(cuda)
    dt = s.cfg.substep_dt
    solver.run_substeps(s.state, s.model, s.bcs, 0.0, 2, s.grid, dt,
                        checkpoint_policy=None)
    model = dataclasses.replace(
        s.model, gravity=torch.tensor([50.0, 0.0, 0.0], device=cuda))
    before = _golden_counts()
    got, _ = solver.run_substeps(s.state, model, s.bcs, 0.0, GRAPH_STEPS,
                                 s.grid, dt, checkpoint_policy=None)
    assert _golden_delta(before)["captures"] == 1
    want, _ = _golden_eager(s.state, model, s.bcs, s.grid, dt, GRAPH_STEPS)
    _assert_states_close(got, want)
    before = _golden_counts()
    solver.run_substeps(s.state, s.model, s.bcs, 0.0, 2, s.grid, dt,
                        checkpoint_policy=None)
    assert _golden_delta(before)["captures"] == 0


def _golden_fit(ident, state, graph: bool, group=None):
    """The golden fitting window from state and d(loss)/d(logE, y) through
    it: run_substeps(fitting=True) under autograd (on CUDA the window's
    graphs) or the checkpointed substep_soa loop, the grid summed over
    ``group`` when given.  Returns (state, gradients)."""
    from gsmpm_tpu_torch.sim import solver
    from gsmpm_tpu_torch.sim.kernels import state_from_soa, substep_soa
    from gsmpm_tpu_torch.sim.state import mu_lam_from_logE_y

    logE = ident.model.logE.detach().clone().requires_grad_(True)
    y = ident.model.y.detach().clone().requires_grad_(True)
    dt = 0.03 / FIT_SUBSTEPS
    with torch.enable_grad():
        mu, lam = mu_lam_from_logE_y(logE, y)
        model = dataclasses.replace(ident.model, logE=logE, y=y, mu=mu,
                                    lam=lam)
        if graph:
            st, _ = solver.run_substeps(state, model, ident.bcs, 0.0,
                                        FIT_SUBSTEPS, ident.grid, dt,
                                        group=group, fitting=True)
        else:
            soa, t = soa_from_state(state), 0.0
            for _ in range(FIT_SUBSTEPS):
                soa = torch.utils.checkpoint.checkpoint(
                    substep_soa, soa, model, ident.bcs, t, ident.grid, dt,
                    group=group, fitting=True, use_reentrant=False)
                t = tiles._advance(t, dt)
            st = state_from_soa(soa)
        loss = (torch.sum(st.x * torch.sin(st.x)) + torch.sum(st.F * st.F)
                + 0.1 * torch.sum(st.v * st.v))
    grads = torch.autograd.grad(loss, (logE, y))
    return st, grads


def test_golden_window_matches_checkpointed(cuda):
    """run_substeps(fitting=True) under autograd on CUDA runs the golden
    window (a forward and an adjoint graph): the state within 1e-4 and
    d logE / d y within FIT_GRAD_REL of their largest magnitudes of the
    checkpointed loop's; no K1 / K2 / K6 launch; a second window with
    other logE / y replays only, 2 a substep."""
    ident, _ = _thrown_ident(cuda)
    state = ident.reset_state()
    st_e, g_e = _golden_fit(ident, state, graph=False)
    before = _golden_counts()
    st_g, g_g = _golden_fit(ident, state, graph=True)
    d = _golden_delta(before)
    assert d["captures"] + d["replays"] == 2 * FIT_SUBSTEPS
    assert d["k1"] == d["k2"] == d["k6"] == d["captured"] == 0
    _assert_states_close(st_g, st_e, ("x", "v", "C", "F"))
    for a, b in zip(g_g, g_e):
        assert float((a - b).abs().max()) <= FIT_GRAD_REL * float(
            b.abs().max())
    ident._set_params(ident.model.logE + 0.1, ident.model.y)
    before = _golden_counts()
    _golden_fit(ident, state, graph=True)
    d = _golden_delta(before)
    assert d["captures"] == 0 and d["replays"] == 2 * FIT_SUBSTEPS


def test_ground_truth_replays_the_golden_graph(cuda):
    """generate_ground_truth steps its frames on the golden graph: one
    capture for its model, replays for every later substep (2 frames of
    FIT_SUBSTEPS a pass; a render that drops candidates regenerates them,
    replaying the same graph), no tiled kernel."""
    ident, cam = _thrown_ident(cuda)
    before = _golden_counts()
    frames = ident.generate_ground_truth(3e3, 0.3, [cam], 3)
    d = _golden_delta(before)
    assert len(frames) == 3
    assert all(bool(torch.isfinite(f).all()) for f in frames)
    steps = d["captures"] + d["replays"]
    assert d["captures"] == 1 and steps % (2 * FIT_SUBSTEPS) == 0
    assert d["k1"] == d["k2"] == d["k6"] == 0


# ---------------------------------------------------------------------------
# the mesh paths' graphs on a one-rank NCCL group (parallel/tiled_sharded.py,
# the fitting window with a group)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL group built here, its graphs dropped before it is
    destroyed; skips without a GPU or NCCL."""
    import socket

    import torch.distributed as dist

    from gsmpm_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    if not dist.is_nccl_available():
        pytest.skip("this PyTorch build has no NCCL")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield make_mesh((("data", 1),), "cuda")
    finally:
        tiles._drop_group_graphs()
        dist.destroy_process_group()


def test_all_reduce_sum_replays_inside_a_graph(cuda, nccl_mesh):
    """all_reduce_sum captured in a _Captured body, forward and backward
    (autograd's _AllReduceSum inside the capture): each replay equals the
    eager sum on new inputs."""
    from types import SimpleNamespace

    from gsmpm_tpu_torch.parallel.mesh import all_reduce_sum

    group = nccl_mesh.group
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4096, device=cuda, generator=gen)
    out, grad = torch.empty_like(x), torch.empty_like(x)

    def body():
        out.copy_(all_reduce_sum(2.0 * x, group))
        leaf = x.detach().requires_grad_(True)
        with torch.enable_grad():
            s = all_reduce_sum(leaf * leaf, group)
            grad.copy_(torch.autograd.grad(s.sum(), leaf)[0])

    counters = SimpleNamespace(captures=0, replays=0)
    graph = tiles._Captured(cuda, counters)
    graph(body)  # warm-up, then the capture
    assert counters.captures == 1
    for _ in range(3):
        x.copy_(torch.randn(4096, device=cuda, generator=gen))
        graph(body)
        torch.cuda.synchronize()
        # one rank: the sum is its own term, the cotangent its own
        assert torch.equal(out, 2.0 * x)
        assert torch.equal(grad, 2.0 * x)
    assert counters.replays == 3


def _mesh_frame_case(dev, mesh):
    """_graph_case's thrown box with its BCs as the one rank's chunk slice:
    (solver, tile config, this rank's bootstrapped slice, frame fn)."""
    from gsmpm_tpu_torch.parallel.tiled_sharded import (
        make_sharded_frame_tiled, shard_tiled, sharded_tile_config,
    )

    s, _, _ = _graph_case(dev)
    n = s.state.n_particles
    tc = sharded_tile_config(s.grid.n_grid, n, mesh.world_size)
    ts = shard_tiled(tiles.bootstrap(soa_from_state(s.state), s.model,
                                     s.grid, tc), mesh, tc)
    fn = make_sharded_frame_tiled(mesh, model=s.model, bcs=s.bcs,
                                  grid=s.grid, tc=tc, dt=s.cfg.substep_dt,
                                  n_substeps=GRAPH_STEPS, rebucket_every=10)
    return s, tc, ts, fn


def _mesh_eager_frame(mesh, s, tc, ts, time=0.0):
    """The sharded frame's eager segment loop: gathered rebucket, 10
    substep_tiled(group=) substeps, the hard-drift flag."""
    import torch.distributed as dist

    from gsmpm_tpu_torch.parallel.tiled_sharded import (
        _hard_drift, gather_tiled, shard_tiled,
    )

    dt = s.cfg.substep_dt
    ok = ts.ok
    for _ in range(GRAPH_STEPS // 10):
        ts = shard_tiled(tiles.rebucket(gather_tiled(ts, mesh), s.grid, tc),
                         mesh, tc)
        ok = ok & ts.ok
        for _ in range(10):
            ts = tiles.substep_tiled(ts, s.model, s.bcs, time, s.grid, tc,
                                     dt, group=mesh.group,
                                     rebucket_on_drift=False)
            time = tiles._advance(time, dt)
        bad = _hard_drift(ts.q, s.grid, tc, ts.chunk_tile).to(torch.int32)
        dist.all_reduce(bad.reshape(1), op=dist.ReduceOp.MAX,
                        group=mesh.group)
        ok = ok & (bad == 0)
    return dataclasses.replace(ts, ok=ok), time


def test_mesh_frame_graph_matches_eager_segments(cuda, nccl_mesh):
    """make_sharded_frame_tiled on CUDA replays one captured substep (the
    grid's NCCL all-reduce inside): one capture, no host read, K1 / K2 once
    a substep, the device clock's bits the host clock's, rows within
    SOLVER_RTOL (1e-4) of the eager segment loop's; a second frame replays
    only."""
    s, tc, ts0, fn = _mesh_frame_case(cuda, nccl_mesh)
    want, t_want = _mesh_eager_frame(nccl_mesh, s, tc, ts0)
    before = _graph_counts()
    ts, q, t = fn(ts0, 0.0)
    d = _delta(before)
    assert d["captures"] == 1 and d["replays"] == GRAPH_STEPS - 1
    assert d["host_reads"] == d["rebuckets"] == 0
    assert d["k1"] == d["k2"] == GRAPH_STEPS
    assert d["k1_captured"] == d["k2_captured"] == 1
    assert t == t_want and bool(ts.ok) and bool(want.ok)
    entry = next(reversed(tiles._GRAPHS.values()))
    assert entry.group is nccl_mesh.group
    assert entry.clock.cpu().numpy().view(np.uint32) == np.float32(t).view(
        np.uint32)
    _assert_close(ts, want, s.state.n_particles)
    assert torch.equal(q, tiles.to_original_order(ts, tc.n_particles))
    before = _graph_counts()
    fn(ts, t)
    d = _delta(before)
    assert d["captures"] == 0 and d["replays"] == GRAPH_STEPS
    assert d["k1"] == d["k2"] == GRAPH_STEPS


def test_mesh_fit_window_matches_checkpointed(cuda, nccl_mesh):
    """run_substeps_tiled_fitting(group=) under autograd on CUDA: the
    window's two graphs with the all-reduces inside, rows within 1e-4 and
    d logE / d y within FIT_GRAD_REL of the checkpointed
    substep_tiled_fitting(group=) loop's; a second window replays only,
    K1 / K2 / K6 exactly 90 / 150 / 60."""
    ident, _ = _thrown_ident(cuda)
    state = ident.reset_state()
    group = nccl_mesh.group
    q_e, g_e, ok_e = _window(ident, state, graph=False, group=group)
    before = _fit_graph_counts()
    q_g, g_g, ok_g = _window(ident, state, graph=True, group=group)
    d = _fit_delta(before)
    assert ok_e and ok_g
    assert d["rebuckets"] >= 1 and d["host_reads"] == FIT_SUBSTEPS
    assert d["captures"] == 2
    assert d["captures"] + d["replays"] == 2 * FIT_SUBSTEPS
    assert next(reversed(tiles._FIT_GRAPHS.values())).group is group
    _assert_rows_close(q_g, q_e)
    for a, b in zip(g_g, g_e):
        assert float((a - b).abs().max()) <= FIT_GRAD_REL * float(
            b.abs().max())
    before = _fit_graph_counts()
    _window(ident, state, graph=True, group=group)
    d = _fit_delta(before)
    assert d["captures"] == 0 and d["replays"] == 2 * FIT_SUBSTEPS
    assert (d["k1"], d["k2"], d["k6"]) == (3 * FIT_SUBSTEPS,
                                           5 * FIT_SUBSTEPS,
                                           2 * FIT_SUBSTEPS)
    assert d["k1_captured"] == d["k2_captured"] == d["k6_captured"] == 0


def test_golden_psum_graph_matches_eager_loop(cuda, nccl_mesh):
    """run_substeps(group=) on CUDA without autograd (the psum engine)
    replays one captured golden substep with the dense grid's NCCL
    all-reduce inside: within 1e-4 of the eager substep_soa(group=) loop,
    incremental_cov on; the cached graph names the group, and
    _drop_group_graphs frees it."""
    from gsmpm_tpu_torch.sim import solver

    s, _, _ = _graph_case(cuda)
    dt, group = s.cfg.substep_dt, nccl_mesh.group
    want, t_want = _golden_eager(s.state, s.model, s.bcs, s.grid, dt,
                                 GRAPH_STEPS, inc=True, group=group)
    before = _golden_counts()
    with torch.no_grad():
        got, t = solver.run_substeps(s.state, s.model, s.bcs, 0.0,
                                     GRAPH_STEPS, s.grid, dt,
                                     incremental_cov=True, group=group,
                                     checkpoint_policy=None)
    d = _golden_delta(before)
    assert d["captures"] == 1 and d["replays"] == GRAPH_STEPS - 1
    assert t == t_want
    _assert_states_close(got, want)
    entry = next(reversed(solver._GOLDEN_GRAPHS.values()))
    assert entry.group is group
    tiles._drop_group_graphs(group)
    assert all(e.group is None for e in solver._GOLDEN_GRAPHS.values())


def test_golden_window_with_group_matches_checkpointed(cuda, nccl_mesh):
    """The golden window with a group (the all-reduces of the forward, the
    recompute and its VJP inside its graphs) against the checkpointed
    substep_soa(group=) loop: state within 1e-4, d logE / d y within
    FIT_GRAD_REL; then replays only."""
    from gsmpm_tpu_torch.sim import solver

    ident, _ = _thrown_ident(cuda)
    state = ident.reset_state()
    group = nccl_mesh.group
    st_e, g_e = _golden_fit(ident, state, graph=False, group=group)
    before = _golden_counts()
    st_g, g_g = _golden_fit(ident, state, graph=True, group=group)
    d = _golden_delta(before)
    assert d["captures"] == 2
    assert d["captures"] + d["replays"] == 2 * FIT_SUBSTEPS
    assert next(reversed(solver._GOLDEN_FIT_GRAPHS.values())).group is group
    _assert_states_close(st_g, st_e, ("x", "v", "C", "F"))
    for a, b in zip(g_g, g_e):
        assert float((a - b).abs().max()) <= FIT_GRAD_REL * float(
            b.abs().max())
    before = _golden_counts()
    _golden_fit(ident, state, graph=True, group=group)
    d = _golden_delta(before)
    assert d["captures"] == 0 and d["replays"] == 2 * FIT_SUBSTEPS
