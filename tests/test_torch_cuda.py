"""The port's CUDA kernels vs their plain twins, on an NVIDIA GPU.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode).  This file imports no JAX, so on the machine with the
GPU it runs without the JAX conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Inputs are small (a few hundred particles, n_grid 16, 128^2) and made with
numpy from seeds; chip_smoke.py repeats the comparisons at the main path's
shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsmpm_tpu_torch.apps.simulate import prepare, simulate
from gsmpm_tpu_torch.config import MPMConfig, RenderConfig, SimConfig
from gsmpm_tpu_torch.render import renderer as tr
from gsmpm_tpu_torch.render import stream_raster as sr
from gsmpm_tpu_torch.render.camera import make_camera
from gsmpm_tpu_torch.sim import cuda_mpm, tiles
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


def test_wrappers_reject_bad_inputs(cuda, tmp_path):
    cfg, su, ts, sig = _first_substep_inputs(tmp_path)
    with pytest.raises(ValueError):
        cuda_mpm.p2g_tiled(ts, sig[:, ::2], su.grid, su.tc, 1e-3)
    with pytest.raises(ValueError):
        cuda_mpm.g2p_tiled(ts, torch.zeros((1, 192, 64), device=cuda),
                           su.grid, su.tc, 1e-3)


def test_stream_kernel_matches_twin(cuda):
    rng = np.random.default_rng(9)
    n = 800
    means = (0.08 * rng.normal(size=(n, 3))).astype(np.float32)
    means[:, 2] += 3.5
    A = 0.05 * rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    opacity = rng.uniform(0.15, 0.95, size=n).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    cam = make_camera(128, 128, 0.9, 0.9, np.eye(3), np.zeros(3))
    cfg = tr.RasterConfig(block=64)
    C = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    pre = tr.preprocess(C(means), C(cov6), C(opacity), None, cam, 0, cfg,
                        colors_precomp=C(colors))
    splanes, bounds, _, lv = sr.stream_inputs(pre, cam, cfg)
    args = (splanes, bounds, lv.nbx, cfg.block, cfg.t_min, cfg.alpha_min)
    before = sr.stream_blend.launches
    got = sr.stream_blend(*args)
    assert sr.stream_blend.launches == before + 1
    want = sr.stream_blend_ref(*args)
    # sequential vs chunked transmittance products round differently
    assert float((got[:, 0:4] - want[:, 0:4]).abs().max()) <= 2e-3
    assert float((got[:, 4] != want[:, 4]).float().mean()) <= 1e-3


def test_simulate_gpu_matches_cpu(cuda, tmp_path):
    frames = {}
    for dev in ("cuda", "cpu"):
        cfg = _cfg(tmp_path / dev)
        frames[dev] = simulate(cfg, synthetic=512, frames=2, quiet=True,
                               synthetic_res=64, device=dev)
    for a, b in zip(frames["cuda"], frames["cpu"]):
        # float-atomic sum order over 20 substeps, then the render
        np.testing.assert_allclose(a, b, atol=1e-3)
