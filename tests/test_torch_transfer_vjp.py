"""The port's hand-written transfer VJPs (sim/transfer_vjp.py) and the K6
twin vs gsmpm_tpu on its TPU route.

The JAX side runs its production adjoint: ``transfer_vjp.FORCE_PALLAS``
routes the VJPs through the Pallas kernels in interpret mode (as
tests/test_transfer_vjp.py does), restored in ``finally``.  The port runs
the plain twins on the CPU; tests/test_torch_cuda.py and chip_smoke.py hold
the CUDA kernels against the same twins on the GPU.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmpm_tpu.sim.transfer_vjp as jtv
from gsmpm_tpu.config import MPMConfig
from gsmpm_tpu.models.synthetic import synthetic_blob_scene
from gsmpm_tpu.sim import tiles as jt
from gsmpm_tpu.sim.boundary import BCSet, StickyGroundBC
from gsmpm_tpu.sim.coupling import world2grid
from gsmpm_tpu.sim.kernels import soa_from_state, state_from_soa
from gsmpm_tpu.sim.pallas_mpm import sored_tiled_pallas
from gsmpm_tpu.sim.state import (
    GridConfig, init_model, init_state, mu_lam_from_logE_y,
)
from gsmpm_tpu.sim.volume import particle_volume

from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.models.convert import (
    TILED_FIELDS, state_from_numpy, tiled_state_from_numpy,
)
from gsmpm_tpu_torch.sim import boundary as tb
from gsmpm_tpu_torch.sim import cuda_mpm
from gsmpm_tpu_torch.sim import tiles as tt
from gsmpm_tpu_torch.sim import transfer_vjp as ttv
from gsmpm_tpu_torch.sim.kernels import soa_from_state as t_soa_from_state
from gsmpm_tpu_torch.sim.kernels import state_from_soa as t_state_from_soa
from gsmpm_tpu_torch.sim.state import GridConfig as TGridConfig
from gsmpm_tpu_torch.sim.state import init_model as t_init_model
from gsmpm_tpu_torch.sim.state import mu_lam_from_logE_y as t_mu_lam


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _pallas_adjoint():
    jtv.FORCE_PALLAS = True
    try:
        yield
    finally:
        jtv.FORCE_PALLAS = False


DT = 0.03 / 30
KW = dict(material="jelly", E=1e4, nu=0.3, n_grid=24, grid_extent=2.0,
          gravity=[0.0, -9.81, 0.0], fitting=True)


def _fit_state(n=256):
    """tests/test_transfer_vjp.py's falling blob (n_grid 24)."""
    scene = synthetic_blob_scene(n=n, seed=5, radius=0.4,
                                 center=(0.0, 0.8, 0.0))
    cfg = MPMConfig(**KW)
    g_xyz, _, sc = world2grid(scene.xyz, cfg.grid_extent, pad=0.3)
    g_cov = scene.get_covariance() * sc * sc
    vol = particle_volume(g_xyz, cfg.n_grid, cfg.grid_extent)
    init_v = jnp.tile(jnp.asarray([0.0, -2.0, 0.0], jnp.float32)[None],
                      (n, 1))
    state = init_state(g_xyz, g_cov, vol, cfg, init_v)
    return state, init_model(cfg, n), GridConfig(cfg.n_grid,
                                                 cfg.grid_extent)


def _tiled(seed=3):
    """Bootstrapped JAX tiles with seeded motion on the real slots (v, C
    and F perturbed, so every term of the transfers is nonzero) and the
    same state as the port's TiledState."""
    state, model, grid = _fit_state()
    n = state.x.shape[0]
    tc = jt.default_tile_config(grid.n_grid, n)
    ts = jt.bootstrap(soa_from_state(state), model, grid, tc)
    rng = np.random.default_rng(seed)
    q = np.array(ts.q)
    live = (q[jt.RMASS] > 0).astype(np.float32)
    for r0, rows, std in ((jt.RV, 3, 1.0), (jt.RC, 9, 5.0),
                          (jt.RF, 9, 0.02)):
        q[r0:r0 + rows] += std * rng.normal(size=(rows, q.shape[1])) * live
    ts = dataclasses.replace(ts, q=jnp.asarray(q.astype(np.float32)))
    port = tiled_state_from_numpy(
        {k: np.asarray(getattr(ts, k)) for k in TILED_FIELDS})
    return ts, port, grid, tc, rng


def _close(got, want, rel, what):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    err = np.abs(np.asarray(got) - want).max()
    assert err / scale < rel, (what, err, scale)


@pytest.mark.parametrize("route", ["pallas", "xla"])
def test_sored_twin_matches_jax(route):
    """The K6 twin vs _sored_kernel (interpret mode) and vs the XLA chunk
    form: 1e-5 of each row group's largest entry (the kernel's 3-pass bf16
    split is ~1e-6 relative)."""
    ts, port, grid, tc, rng = _tiled()
    planes = rng.normal(size=(tc.ntiles, 48, 256)).astype(np.float32)
    got = ttv.sored_tiled_ref(port.q, torch.from_numpy(planes),
                              port.chunk_tile, port.chunk_live,
                              TGridConfig(*grid), tt.TileConfig(*tc)).numpy()
    if route == "pallas":
        want = np.asarray(sored_tiled_pallas(
            ts.q, jnp.asarray(planes), ts.chunk_tile, ts.chunk_live, grid,
            tc, 3))
    else:
        W, U, D = jtv._sored_all(ts.q, jnp.asarray(planes).reshape(
            tc.ntiles, 3, 16, 256), ts.chunk_tile, ts.chunk_live, grid, tc,
            3)
        want = np.zeros_like(got)
        for c in range(3):
            want[21 * c:21 * c + 3] = np.asarray(W[c])
            want[21 * c + 3:21 * c + 12] = np.asarray(U[c]).reshape(9, -1)
            want[21 * c + 12:21 * c + 21] = np.asarray(D[c]).reshape(9, -1)
        # the XLA form computes dead chunks too; the kernels write zeros
        dead = np.repeat(np.asarray(ts.chunk_live) != 1, tc.S)
        want[:, dead] = 0.0
    for c in range(3):
        for lo, hi in ((0, 3), (3, 12), (12, 21)):
            rows = slice(21 * c + lo, 21 * c + hi)
            _close(got[rows], want[rows], 1e-5, (route, c, lo))
    assert np.abs(got[63:]).max() == 0.0


def test_p2g_fit_vjp_matches_jax():
    """d(windows)/d(q, sig) transposed: the port's backward (fake G2Ps plus
    the K6 twin) vs gsmpm_tpu's custom VJP on the Pallas kernels, to 2e-4
    of scale (tests/test_transfer_vjp.py's tolerance)."""
    ts, port, grid, tc, rng = _tiled()
    sig = np.concatenate([1e3 * rng.normal(size=(9, tc.np_rows)),
                          np.zeros((7, tc.np_rows))]).astype(np.float32)
    What = rng.normal(size=(tc.ntiles, 256, 64)).astype(np.float32)
    args = (ts.chunk_tile, ts.chunk_first, ts.chunk_live, grid, tc, DT)
    with _pallas_adjoint():
        out, vjp = jax.vjp(lambda q, s: jtv.p2g_fit(q, s, *args), ts.q,
                           jnp.asarray(sig))
        dq_j, dsig_j = vjp(jnp.asarray(What))
    q = port.q.clone().requires_grad_(True)
    s = torch.from_numpy(sig).requires_grad_(True)
    got = ttv.p2g_fit(q, s, port.chunk_tile, port.chunk_first,
                      port.chunk_live, TGridConfig(*grid), tt.TileConfig(*tc),
                      DT)
    # the Pallas kernels' 3-pass bf16 split rounds each product to ~1e-6
    _close(got.detach().numpy(), out, 2e-5, "windows")
    got.backward(torch.from_numpy(What))
    _close(q.grad.numpy(), dq_j, 2e-4, "dq")
    _close(s.grad.numpy(), dsig_j, 2e-4, "dsig")
    for rows in ((jt.RX, 3), (jt.RV, 3), (jt.RC, 9)):
        sl = slice(rows[0], rows[0] + rows[1])
        _close(q.grad.numpy()[sl], np.asarray(dq_j)[sl], 2e-4, rows)


def test_g2p_fit_vjp_matches_jax():
    """d(q')/d(q, ext) transposed: the port's backward (fake P2G and G2P
    plus the K6 twin) vs gsmpm_tpu's custom VJP on the Pallas kernels."""
    ts, port, grid, tc, rng = _tiled(seed=4)
    ext = rng.normal(size=(tc.ntiles, 192, 64)).astype(np.float32)
    ghat = rng.normal(size=(jt.QROWS, tc.np_rows)).astype(np.float32)
    ghat[jt.RDRIFT:] = 0.0  # the drift flag and spare rows carry none
    args = (ts.chunk_tile, ts.chunk_first, ts.chunk_live, grid, tc, DT)
    with _pallas_adjoint():
        out, vjp = jax.vjp(lambda q, e: jtv.g2p_fit(q, e, *args), ts.q,
                           jnp.asarray(ext))
        dq_j, dext_j = vjp(jnp.asarray(ghat))
    q = port.q.clone().requires_grad_(True)
    e = torch.from_numpy(ext).requires_grad_(True)
    got = ttv.g2p_fit(q, e, port.chunk_tile, port.chunk_first,
                      port.chunk_live, TGridConfig(*grid), tt.TileConfig(*tc),
                      DT)
    got.backward(torch.from_numpy(ghat))
    _close(got.detach().numpy()[:jt.RDRIFT], np.asarray(out)[:jt.RDRIFT],
           2e-5, "q'")
    _close(q.grad.numpy(), dq_j, 2e-4, "dq")
    _close(e.grad.numpy(), dext_j, 2e-4, "dext")
    for r0, n in ((jt.RX, 3), (jt.RF, 9)):
        sl = slice(r0, r0 + n)
        _close(q.grad.numpy()[sl], np.asarray(dq_j)[sl], 2e-4, r0)


@pytest.mark.parametrize("n_sub", [3])
def test_fitting_substeps_and_grads_match_jax(n_sub):
    """run_substeps_tiled_fitting forward, and d(loss)/d(logE, x0) through
    it (sticky ground, rebucket inside the window, checkpointed substeps),
    vs gsmpm_tpu's chunk_impl="vjp" on the Pallas kernels."""
    state, model, grid = _fit_state()
    n = state.x.shape[0]
    bcs = BCSet(grid_ops=(StickyGroundBC(),))

    def jloss(logE, x0):
        mu, lam = mu_lam_from_logE_y(logE, model.y)
        m = dataclasses.replace(model, logE=logE, mu=mu, lam=lam)
        soa, _, ok = jt.run_substeps_tiled_fitting(
            soa_from_state(dataclasses.replace(state, x=x0)), m, bcs,
            jnp.float32(0.0), n_sub, grid, DT, chunk_impl="vjp")
        st = state_from_soa(soa)
        return (jnp.sum(st.x * jnp.sin(st.x)) + jnp.sum(st.F * st.F)
                + 0.1 * jnp.sum(st.v * st.v)
                + 0.01 * jnp.sum(st.C * st.C)), st

    with _pallas_adjoint():
        (lj, stj), gj = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(model.logE, state.x)

    t_state = state_from_numpy({f.name: np.asarray(getattr(state, f.name))
                                for f in dataclasses.fields(state)})
    t_model = t_init_model(TMPMConfig(**KW), n, "cpu")
    logE = t_model.logE.clone().requires_grad_(True)
    x0 = t_state.x.clone().requires_grad_(True)
    mu, lam = t_mu_lam(logE, t_model.y)
    m = dataclasses.replace(t_model, logE=logE, mu=mu, lam=lam)
    soa, _, ok = tt.run_substeps_tiled_fitting(
        t_soa_from_state(dataclasses.replace(t_state, x=x0)), m,
        tb.BCSet(grid_ops=(tb.StickyGroundBC(torch.tensor([1.0, 0.6, 1.0]),
                                            torch.tensor([1.0, 0.1, 1.0])),)),
        0.0, n_sub,
        TGridConfig(*grid), DT)
    assert bool(ok)
    st = t_state_from_soa(soa)
    loss = (torch.sum(st.x * torch.sin(st.x)) + torch.sum(st.F * st.F)
            + 0.1 * torch.sum(st.v * st.v) + 0.01 * torch.sum(st.C * st.C))
    for name in ("x", "v", "C", "F"):
        # 3 substeps of 3-pass bf16 products on the JAX side
        _close(getattr(st, name).detach().numpy(), getattr(stj, name), 1e-4,
               name)
    assert float(loss.detach()) == pytest.approx(float(lj), rel=1e-5)
    loss.backward()
    _close(logE.grad.numpy(), gj[0], 2e-4, "d_logE")
    _close(x0.grad.numpy(), gj[1], 2e-4, "d_x0")


def test_cpu_sored_wrapper_takes_twin_and_counts_nothing():
    _, port, grid, tc, rng = _tiled()
    planes = torch.from_numpy(rng.normal(size=(tc.ntiles, 48, 256))
                              .astype(np.float32))
    args = (port.q, planes, port.chunk_tile, port.chunk_live,
            TGridConfig(*grid), tt.TileConfig(*tc))
    before = cuda_mpm.sored_tiled.launches
    assert torch.equal(cuda_mpm.sored_tiled(*args),
                       ttv.sored_tiled_ref(*args))
    assert cuda_mpm.sored_tiled.launches == before
