"""The port's tiled MPM engine (gsmpm_tpu_torch/sim/tiles.py) vs gsmpm_tpu.

Same inputs for both packages, made with numpy from a seed and carried
across with gsmpm_tpu_torch.models.convert.  On the CPU the transfer
wrappers run their plain twins; the CUDA kernels are held against the same
twins by tests/test_torch_cuda.py and chip_smoke.py on the GPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmpm_tpu.config import MPMConfig
from gsmpm_tpu.sim.boundary import BCSet, make_surface_collider
from gsmpm_tpu.sim.kernels import soa_from_state
from gsmpm_tpu.sim.state import GridConfig, init_model, init_state
from gsmpm_tpu.sim import tiles as jt
from gsmpm_tpu.sim.volume import particle_volume

from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.models.convert import TILED_FIELDS, tiled_state_from_numpy
from gsmpm_tpu_torch.sim import boundary as tb
from gsmpm_tpu_torch.sim import cuda_mpm
from gsmpm_tpu_torch.sim import tiles as tt
from gsmpm_tpu_torch.sim.kernels import soa_from_state as t_soa_from_state
from gsmpm_tpu_torch.sim.state import GridConfig as TGridConfig
from gsmpm_tpu_torch.sim.state import MPMState as TMPMState
from gsmpm_tpu_torch.sim.state import init_model as t_init_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(n=600, g=16, seed=5):
    """tests/test_pallas_mpm.py's scene: 600 particles, n_grid 16."""
    kw = dict(E=2e4, nu=0.3, material="jelly", n_grid=g, grid_extent=2.0,
              substep_dt=1e-4, frame_dt=1e-2, density=200.0)
    cfg = MPMConfig(**kw)
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0.1, 1.9, size=(n, 3)).astype(np.float32)
    cov6 = np.tile(np.asarray([1e-4, 0, 0, 1e-4, 0, 1e-4], np.float32), (n, 1))
    vol = particle_volume(jnp.asarray(xyz), cfg.n_grid, cfg.grid_extent)
    state = init_state(jnp.asarray(xyz), jnp.asarray(cov6), vol, cfg)
    state = dataclasses.replace(
        state,
        v=jnp.asarray(2.0 * rng.normal(size=(n, 3)).astype(np.float32)),
        C=jnp.asarray(0.1 * rng.normal(size=(n, 3, 3)).astype(np.float32)),
    )
    model = init_model(cfg, n)
    grid = GridConfig(cfg.n_grid, cfg.grid_extent)
    t_state = TMPMState(**{
        f.name: torch.from_numpy(np.array(getattr(state, f.name)))
        for f in dataclasses.fields(state)
    })
    t_model = t_init_model(TMPMConfig(**kw), n, "cpu")
    return cfg, (state, model, grid), (t_state, t_model, TGridConfig(*grid))


def _jax_tiled(n=600, seed=5):
    cfg, (state, model, grid), port = _setup(n=n, seed=seed)
    soa = soa_from_state(state)
    tc = jt.default_tile_config(grid.n_grid, n)
    ts = jt.bootstrap(soa, model, grid, tc)
    return cfg, ts, grid, tc, port


def _to_port(ts):
    return tiled_state_from_numpy(
        {k: np.asarray(getattr(ts, k)) for k in TILED_FIELDS})


def test_bootstrap_tables_equal_jax():
    """Bucketing is integer work on the same f32 positions: every table and
    the permuted q/aux rows must be identical (stable sorts on both sides)."""
    cfg, ts, grid, tc, (t_state, t_model, t_grid) = _jax_tiled()
    t_ts = tt.bootstrap(t_soa_from_state(t_state), t_model, t_grid,
                        tt.TileConfig(*tc))
    for k in TILED_FIELDS:
        np.testing.assert_array_equal(getattr(t_ts, k).numpy(),
                                      np.asarray(getattr(ts, k)), err_msg=k)


def test_rebucket_after_drift_equal_jax():
    """Rebucket after particles moved across tiles (incl. the dead-chunk
    tables and padding pattern) is identical."""
    cfg, ts, grid, tc, _ = _jax_tiled()
    rng = np.random.default_rng(3)
    q = np.array(ts.q)
    live = np.asarray(ts.orig) >= 0
    q[0:3, live] = np.clip(
        q[0:3, live] + 0.3 * rng.normal(size=(3, live.sum())), 0.05, 1.95
    ).astype(np.float32)
    ts_moved = dataclasses.replace(ts, q=jnp.asarray(q))
    want = jt.rebucket(ts_moved, grid, tc)
    got = tt.rebucket(_to_port(ts_moved), TGridConfig(*grid),
                      tt.TileConfig(*tc))
    for k in TILED_FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)


def test_p2g_twin_matches_jax_ref():
    cfg, ts, grid, tc, _ = _jax_tiled()
    rng = np.random.default_rng(0)
    sig = np.concatenate([1e3 * rng.normal(size=(9, tc.np_rows)),
                          np.zeros((7, tc.np_rows))]).astype(np.float32)
    want = np.asarray(jt.p2g_tiled_ref(ts, jnp.asarray(sig), grid, tc,
                                       cfg.substep_dt))
    got = cuda_mpm.p2g_tiled(_to_port(ts), torch.from_numpy(sig),
                             TGridConfig(*grid), tt.TileConfig(*tc),
                             cfg.substep_dt).numpy()
    scale = np.abs(want).max()
    # f32 sums in another contraction order (bmm of pair tables vs einsum)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_p2g_twin_matches_jax_ref_dense(seed):
    """K1's dense case (tests/test_torch_cull_groups.py: ~740 particles a
    cell, 79 chunks adding into one tile's window, a tile of one chunk,
    five empty tiles) through both packages' P2G references."""
    from test_torch_cull_groups import dense_tiled_state

    ts, sig, grid, tc, dt = dense_tiled_state(seed=seed, dead_chunk=None)
    j_ts = jt.TiledState(**{k: jnp.asarray(getattr(ts, k).numpy())
                            for k in TILED_FIELDS})
    want = np.asarray(jt.p2g_tiled_ref(
        j_ts, jnp.asarray(sig.numpy()), GridConfig(*grid),
        jt.TileConfig(*tc), dt))
    got = cuda_mpm.p2g_tiled(ts, sig, grid, tc, dt).numpy()
    # f32 sums in another contraction order, per component's largest entry
    def comp(w):  # windows -> (4, -1): mass, momentum x, y, z
        return w.reshape(-1, 8, 4, 8, 64).swapaxes(0, 2).reshape(4, -1)

    scale = np.abs(comp(want)).max(axis=1)
    assert (scale > 0).all()
    err = np.abs(comp(got - want)).max(axis=1)
    assert (err / scale).max() <= 2e-6, err / scale


def test_g2p_twin_matches_jax_ref():
    cfg, ts, grid, tc, _ = _jax_tiled(seed=7)
    rng = np.random.default_rng(1)
    windows = rng.normal(size=(tc.ntiles, 192, 64)).astype(np.float32)
    want = np.asarray(jt.g2p_tiled_ref(ts, jnp.asarray(windows), grid, tc,
                                       cfg.substep_dt))
    got = cuda_mpm.g2p_tiled(_to_port(ts), torch.from_numpy(windows),
                             TGridConfig(*grid), tt.TileConfig(*tc),
                             cfg.substep_dt).numpy()
    # per-row scale: C rows are ~4 inv_dx larger than v rows; f32 sum order
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)
    np.testing.assert_array_equal(got[jt.RDRIFT], want[jt.RDRIFT])


def test_cpu_wrappers_take_twins_and_count_nothing():
    cfg, ts, grid, tc, _ = _jax_tiled()
    t_ts, t_grid, t_tc = _to_port(ts), TGridConfig(*grid), tt.TileConfig(*tc)
    sig = torch.zeros((16, tc.np_rows))
    before = (cuda_mpm.p2g_tiled.launches, cuda_mpm.g2p_tiled.launches)
    win = cuda_mpm.p2g_tiled(t_ts, sig, t_grid, t_tc, cfg.substep_dt)
    assert torch.equal(win, tt.p2g_tiled_ref(t_ts, sig, t_grid, t_tc,
                                             cfg.substep_dt))
    ext = torch.ones((tc.ntiles, 192, 64))
    q = cuda_mpm.g2p_tiled(t_ts, ext, t_grid, t_tc, cfg.substep_dt)
    assert torch.equal(q, tt.g2p_tiled_ref(t_ts, ext, t_grid, t_tc,
                                           cfg.substep_dt))
    assert (cuda_mpm.p2g_tiled.launches,
            cuda_mpm.g2p_tiled.launches) == before


@pytest.mark.parametrize("collider", [False, True])
def test_run_substeps_tiled_matches_jax(collider):
    """5 substeps of the whole tiled engine (stress, P2G, fold, grid update,
    BCs, extract, G2P, rebucket) vs gsmpm_tpu's impl="ref"."""
    cfg, (state, model, grid), (t_state, t_model, t_grid) = _setup()
    bcs = (BCSet(grid_ops=(make_surface_collider((0, 0, 0.4), (0, 0, 1)),))
           if collider else BCSet())
    t_bcs = (tb.BCSet(grid_ops=(tb.make_surface_collider((0, 0, 0.4),
                                                          (0, 0, 1)),))
             if collider else tb.BCSet())
    soa_j, t_j, ok_j = jt.run_substeps_tiled(
        soa_from_state(state), model, bcs, jnp.float32(0.0), 5, grid,
        cfg.substep_dt, impl="ref",
    )
    soa_t, t_t, ok_t = tt.run_substeps_tiled(
        t_soa_from_state(t_state), t_model, t_bcs, 0.0, 5, t_grid,
        cfg.substep_dt,
    )
    assert bool(ok_j) and bool(ok_t)
    assert t_t == pytest.approx(float(t_j), abs=0)
    for name in ("x", "v", "C", "F", "F_trial"):
        want = np.stack([np.asarray(p) for p in getattr(soa_j, name)])
        got = torch.stack(getattr(soa_t, name)).numpy()
        # f32 rounding of different contraction orders, 5 substeps
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-6,
                                   err_msg=name)

