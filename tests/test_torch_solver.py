"""The port's sim/solver.py (the AoS oracle and MPMSolver), ops/bspline.py,
the AoS constitutive laws, the m33 helpers and eval_sh vs gsmpm_tpu.

Inputs are made with numpy from seeds; states go to the port through
models/convert.py.  Tolerances:
- elementwise formulas (bspline, m33, eval_sh) 1e-6 of the values' scale:
  the same f32 operations in the same order, up to fused multiply-adds;
- the AoS laws 2e-5 (F) and 2e-5 of the stress's max, as the planes laws'
  test (tests/test_torch_constitutive.py): Jacobi SVD and 3x3 products
  round differently in the two runtimes;
- grids and substeps 1e-5 of each field's max (C 1e-4): scatter-adds sum
  the same terms in other orders (C is the velocity moment times
  4 / dx^2);
- the port's AoS oracle against its own planes engine (the counterpart of
  tests/test_soa.py) the same 1e-5 / 1e-4, the stress 2e-5;
- a tiled frame on the CPU twins against gsmpm_tpu's tiled frame in
  Pallas interpret mode 1e-5 (C 1e-4);
- the golden route after a tile-cap overflow bit-equal to the golden
  engine: the same torch code on the same state.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsmpm_tpu.ops.m33 as jm33
from gsmpm_tpu.config import BoundaryConditionConfig, MPMConfig
from gsmpm_tpu.ops import bspline as jbs
from gsmpm_tpu.ops.constitutive import compute_stress_from_F_trial
from gsmpm_tpu.render.sh import eval_sh
from gsmpm_tpu.sim import solver as jsolver
from gsmpm_tpu.sim.boundary import BCSet, make_surface_collider
from gsmpm_tpu.sim.state import GridConfig, init_model, init_state
from gsmpm_tpu.sim.volume import particle_volume

import gsmpm_tpu_torch.ops.m33 as tm33
import gsmpm_tpu_torch.sim as tsim_pkg
from gsmpm_tpu_torch.config import BoundaryConditionConfig as TBCConfig
from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.models.convert import state_from_numpy
from gsmpm_tpu_torch.ops import bspline as tbs
from gsmpm_tpu_torch.ops.constitutive import \
    compute_stress_from_F_trial as t_stress
from gsmpm_tpu_torch.render.sh import eval_sh as t_eval_sh
from gsmpm_tpu_torch.sim import boundary as tb
from gsmpm_tpu_torch.sim import solver as tsolver
from gsmpm_tpu_torch.sim import tiles as ttiles
from gsmpm_tpu_torch.sim.state import GridConfig as TGridConfig
from gsmpm_tpu_torch.sim.state import init_model as t_init_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(E=2e4, nu=0.3, material="jelly", n_grid=16, grid_extent=2.0,
          substep_dt=1e-3, frame_dt=1e-2, density=200.0)
FIELDS = ("x", "v", "C", "F", "F_trial")
REL = dict(x=1e-5, v=1e-5, F=1e-5, F_trial=1e-5, C=1e-4, cov=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel_err(got, want):
    want = _np(want)
    return float(np.abs(_np(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _assert_states(got, want, fields=FIELDS, rel=REL):
    for f in fields:
        err = _rel_err(getattr(got, f), getattr(want, f))
        assert err <= rel[f], (f, err)


def _rand_F(n, seed, scale):
    rng = np.random.default_rng(seed)
    return (np.eye(3) + scale * rng.normal(size=(n, 3, 3))).astype(np.float32)


def _to_port(state):
    return state_from_numpy({f.name: np.asarray(getattr(state, f.name))
                             for f in dataclasses.fields(state)})


def _moving_state(n=512, seed=3, cfg=None):
    """tests/test_soa.py's state: a box with seeded v, F, F_trial, C."""
    cfg = cfg or MPMConfig(**KW)
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0.5, 1.5, size=(n, 3)).astype(np.float32)
    A = 0.01 * rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    vol = particle_volume(jnp.asarray(xyz), cfg.n_grid, cfg.grid_extent)
    state = init_state(jnp.asarray(xyz), jnp.asarray(cov6), vol, cfg)
    return dataclasses.replace(
        state,
        v=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)),
        F=jnp.asarray(_rand_F(n, seed + 1, 0.05)),
        F_trial=jnp.asarray(_rand_F(n, seed + 2, 0.05)),
        C=jnp.asarray(0.1 * rng.normal(size=(n, 3, 3)).astype(np.float32)),
    )


# ---------------------------------------------------------------------------
# ops: bspline, m33 helpers, eval_sh, the AoS laws
# ---------------------------------------------------------------------------

def test_bspline_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.1, 1.9, size=(300, 3)).astype(np.float32)
    inv_dx = 8.0
    jb, jfx, jw, jdw = jbs.quadratic_bspline_weights(jnp.asarray(x), inv_dx)
    tb_, tfx, tw, tdw = tbs.quadratic_bspline_weights(torch.from_numpy(x),
                                                      inv_dx)
    np.testing.assert_array_equal(tb_.numpy(), np.asarray(jb))
    assert tb_.dtype == torch.int32
    np.testing.assert_allclose(tfx.numpy(), np.asarray(jfx), atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), atol=1e-6)
    np.testing.assert_allclose(tbs.stencil_weights(tw).numpy(),
                               np.asarray(jbs.stencil_weights(jw)), atol=1e-6)
    np.testing.assert_allclose(
        tbs.stencil_dweights(tw, tdw, inv_dx).numpy(),
        np.asarray(jbs.stencil_dweights(jw, jdw, inv_dx)), atol=8e-6)
    np.testing.assert_array_equal(tbs.SPLINE_OFFSETS, jbs.SPLINE_OFFSETS)


def test_m33_helpers_match_jax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(9, 64)).astype(np.float32)
    u = rng.normal(size=(3, 64)).astype(np.float32)
    v = rng.normal(size=(3, 64)).astype(np.float32)
    jA, ju, jv = (tuple(jnp.asarray(r) for r in a) for a in (A, u, v))
    tA, tu, tv = (tuple(torch.from_numpy(r) for r in a) for a in (A, u, v))
    pairs = [
        (tm33.diag(tu), jm33.diag(ju)),
        (tm33.matvec(tA, tv), jm33.matvec(jA, jv)),
        (tm33.outer(tu, tv), jm33.outer(ju, jv)),
        ((tm33.trace(tA),), (jm33.trace(jA),)),
    ]
    for got, want in pairs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(10 + degree)
    n = 128
    sh = rng.normal(size=(n, 16, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    want = np.asarray(eval_sh(jnp.asarray(sh), jnp.asarray(d), degree))
    got = t_eval_sh(torch.from_numpy(sh), torch.from_numpy(d), degree)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * max(
        np.abs(want).max(), 1.0))


@pytest.mark.parametrize(
    "mat", [0, 1, 2, 3, 4, 5],
    ids=["jelly", "metal", "sand", "foam", "fluid", "plasticine"],
)
def test_compute_stress_from_F_trial_matches_jax(mat):
    n = 256
    rng = np.random.default_rng(1)
    F = _rand_F(n, 2, 0.12)
    material = np.full((n,), mat, np.int32)
    mu = rng.uniform(1e3, 1e5, n).astype(np.float32)
    lam = rng.uniform(1e3, 1e5, n).astype(np.float32)
    ys = rng.uniform(1e2, 1e4, n).astype(np.float32)
    alpha, xi, pv, soft, dt = 0.3, 0.01, 10.0, 0.1, 1e-4
    J = jnp.asarray
    res = compute_stress_from_F_trial(
        J(F), J(material), J(mu), J(lam), J(ys), jnp.float32(alpha), 1,
        jnp.float32(xi), jnp.float32(pv), jnp.float32(soft), dt,
        active_materials=(mat,),
    )
    f32 = lambda v: torch.tensor(np.float32(v))  # noqa: E731
    T = torch.from_numpy
    out = t_stress(T(F), T(material), T(mu), T(lam), T(ys), f32(alpha), 1,
                   f32(xi), f32(pv), f32(soft), dt, active_materials=(mat,))
    np.testing.assert_allclose(out.F.numpy(), np.asarray(res.F), atol=2e-5)
    want = np.asarray(res.stress)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(out.stress.numpy() / scale, want / scale,
                               atol=2e-5)
    np.testing.assert_allclose(out.yield_stress.numpy(),
                               np.asarray(res.yield_stress), rtol=2e-5)


# ---------------------------------------------------------------------------
# the AoS oracle
# ---------------------------------------------------------------------------

def _bcs_pair():
    return (BCSet(grid_ops=(make_surface_collider((0, 0, 0.6), (0, 0, 1)),)),
            tb.BCSet(grid_ops=(tb.make_surface_collider((0, 0, 0.6),
                                                        (0, 0, 1)),)))


def test_aos_transfers_match_jax():
    """p2g, grid_update and g2p, each on the same inputs on both sides."""
    cfg = MPMConfig(**KW)
    grid, tgrid = GridConfig(16, 2.0), TGridConfig(16, 2.0)
    state = _moving_state()
    tstate = _to_port(state)
    rng = np.random.default_rng(5)
    stress = (1e3 * rng.normal(size=(512, 3, 3))).astype(np.float32)
    dt = cfg.substep_dt

    jm, jp = jsolver.p2g(state, jnp.asarray(stress), grid, dt)
    tm, tp = tsolver.p2g(tstate, torch.from_numpy(stress), tgrid, dt)
    assert _rel_err(tm, jm) <= 1e-5 and _rel_err(tp, jp) <= 1e-5

    gravity = np.asarray([0.0, -9.8, 0.0], np.float32)
    jv = jsolver.grid_update(jm, jp, jnp.asarray(gravity), dt)
    tv = tsolver.grid_update(torch.from_numpy(np.array(jm)),
                             torch.from_numpy(np.array(jp)),
                             torch.from_numpy(gravity), dt)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)

    for inc in (False, True):
        js = jsolver.g2p(state, jv, grid, dt, incremental_cov=inc)
        ts = tsolver.g2p(tstate, torch.from_numpy(np.array(jv)), tgrid, dt,
                         incremental_cov=inc)
        _assert_states(ts, js, FIELDS + ("cov",))


@pytest.mark.parametrize("fitting", [False, True], ids=["sim", "fitting"])
def test_substep_aos_matches_jax(fitting):
    cfg = MPMConfig(**KW)
    state = _moving_state()
    model = init_model(cfg, 512)
    jbcs, tbcs = _bcs_pair()
    want = jsolver._substep_aos(state, model, jbcs, jnp.float32(0.0),
                                GridConfig(16, 2.0), cfg.substep_dt,
                                fitting=fitting)
    got = tsolver._substep_aos(_to_port(state),
                               t_init_model(TMPMConfig(**KW), 512, "cpu"),
                               tbcs, 0.0, TGridConfig(16, 2.0),
                               cfg.substep_dt, fitting=fitting)
    _assert_states(got, want)


@pytest.mark.parametrize("case", ["sim", "fitting", "incremental_cov"])
def test_substep_aos_matches_port_planes_engine(case):
    """The counterpart of tests/test_soa.py: the port's AoS oracle against
    its planes engine (sim/kernels.substep_soa, through ``substep``)."""
    tcfg = TMPMConfig(**KW)
    state = _to_port(_moving_state(seed=11))
    model = t_init_model(tcfg, 512, "cpu")
    _, tbcs = _bcs_pair()
    kw = dict(fitting=case == "fitting",
              incremental_cov=case == "incremental_cov")
    args = (state, model, tbcs, 0.0, TGridConfig(16, 2.0), tcfg.substep_dt)
    ref = tsolver._substep_aos(*args, **kw)
    out = tsolver.substep(*args, **kw)
    _assert_states(out, ref, FIELDS + ("cov",))


# ---------------------------------------------------------------------------
# MPMSolver
# ---------------------------------------------------------------------------

def _scene(n, seed, lo=0.6, hi=1.4, n_grid=16, push=None):
    """A box of n gaussians (lo / hi per axis or for all three) with seeded
    covariances and velocities, or all moving at ``push``."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    A = 0.01 * rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].copy()
    vol = np.array(particle_volume(jnp.asarray(xyz), n_grid, 2.0))
    v0 = (0.5 * rng.normal(size=(n, 3))).astype(np.float32)
    if push is not None:
        v0[:] = np.asarray(push, np.float32)
    return xyz, cov6, vol, v0


# an impulse that switches on inside frame 1 and off inside frame 2
IMPULSE = dict(type="impulse", center=[1.0, 1.0, 1.0], size=[0.3, 0.3, 0.3],
               force=[0.0, 0.0, 20.0], start_time=0.004, num_dt=10)


def _solvers(kw, n, seed, tiled=False, impulse=True, **scene):
    """gsmpm_tpu's MPMSolver and the port's on one scene, with the sticky
    ground, a surface collider and (``impulse``) the impulse."""
    xyz, cov6, vol, v0 = _scene(n, seed, n_grid=kw["n_grid"], **scene)
    js = jsolver.MPMSolver(jnp.asarray(xyz), jnp.asarray(cov6),
                           jnp.asarray(vol), MPMConfig(**kw),
                           jnp.asarray(v0))
    ts = tsim_pkg.MPMSolver(xyz, cov6, vol, TMPMConfig(**kw), v0,
                            device="cpu")
    assert not js.use_tiled and not ts.use_tiled  # the CPU default
    js.use_tiled = ts.use_tiled = tiled
    for s, bcc in ((js, BoundaryConditionConfig), (ts, TBCConfig)):
        s.set_bc_ground_only()
        s.add_surface_collider((0, 0, 0.4), (0, 0, 1))
        if impulse:
            s.set_boundary_conditions([bcc.from_dict(IMPULSE)])
    return js, ts


def test_mpm_solver_golden_matches_jax():
    """Two frames of 10 substeps on the golden engine; the impulse's
    window (0.004 s to 0.014 s) opens and closes on the same substeps with
    the port's host-float clock as with gsmpm_tpu's float32 clock."""
    js, ts = _solvers(KW, 1000, 21)
    kicked = None
    for frame in range(2):
        js.step_frame()
        ts.step_frame()
        assert ts.time == float(js.time), frame
        _assert_states(ts.state, js.state)
        if frame == 0:
            kicked = np.abs(_np(ts.state.v)[:, 2]).max()
    assert kicked > 1.0  # the impulse acted
    assert not ts.use_tiled and ts._ts is None


def test_mpm_solver_tiled_matches_jax():
    """use_tiled forced on the CPU: the port's tiled frames on the K1 / K2
    twins against gsmpm_tpu's in Pallas interpret mode, 3,000 particles on
    the 32^3 grid, 2 frames of 5 substeps.  No impulse here: gsmpm_tpu's
    impulse gives the tiled layout's massless padding slots F / 0 and
    NaN (ROADMAP C), so the port's tiled frames with the impulse are held
    to its golden frames instead."""
    kw = dict(KW, n_grid=32, frame_dt=5e-3)
    js, ts = _solvers(kw, 3000, 22, tiled=True, impulse=False)
    _, ti = _solvers(kw, 3000, 22, tiled=True)
    _, gold = _solvers(kw, 3000, 22)
    for frame in range(2):
        for s in (js, ts, ti, gold):
            s.step_frame()
        assert ts.time == float(js.time) == ti.time == gold.time, frame
        _assert_states(ts.state, js.state)
        _assert_states(ti.state, gold.state)
    assert ts.use_tiled and ti.use_tiled and js.use_tiled
    assert bool(ts._ts.ok) and bool(ti._ts.ok)
    jc, jR = js.postprocess()
    tc, tR = ts.postprocess()
    assert _rel_err(tc, jc) <= 1e-5 and _rel_err(tR, jR) <= 1e-5


def _capped(cap):
    def tile_config(n_grid, n_particles):
        return ttiles.TileConfig(n_grid, n_particles, S=256, n_occ_cap=cap)
    return tile_config


def test_mpm_solver_tile_cap_below_boot_takes_golden(monkeypatch):
    """A tile cap below the bootstrap occupancy: the first frame runs on
    the golden engine, bit-equal to a golden solver, and the tiled engine
    stays off."""
    kw = dict(KW, frame_dt=5e-3)
    _, ts = _solvers(kw, 600, 23, tiled=True)
    _, gold = _solvers(kw, 600, 23)
    monkeypatch.setattr(tsolver, "default_tile_config", _capped(1))
    for _ in range(2):
        ts.step_frame()
        gold.step_frame()
        assert not ts.use_tiled and ts._ts is None
        assert ts.time == gold.time
        for f in FIELDS:
            assert torch.equal(getattr(ts.state, f), getattr(gold.state, f)), f


def test_mpm_solver_overflow_mid_frame_redoes_frame_on_golden(monkeypatch):
    """The cap at the bootstrap occupancy (2 tiles) and the box thrown
    along +x at 14 m/s: frame 1 stays tiled, frame 2 overflows at a
    rebucket and is redone from its start state on the golden engine
    (state and clock of frame 1 kept)."""
    kw = dict(KW, n_grid=32, frame_dt=1e-2)
    _, ts = _solvers(kw, 800, 24, tiled=True, lo=(0.55, 0.8, 0.6),
                     hi=(0.9, 1.2, 0.9), push=(14.0, 0.0, 0.0))
    tc = ttiles.default_tile_config(32, 800)
    boot = ttiles.bootstrap(tsolver.soa_from_state(ts.state), ts.model,
                            ts.grid, tc)
    live = boot.chunk_live == 1
    occ = int(torch.unique(boot.chunk_tile[live]).numel())
    assert occ == 2
    monkeypatch.setattr(tsolver, "default_tile_config", _capped(occ))
    ts.step_frame()
    assert ts.use_tiled and bool(ts._ts.ok)
    start, t1 = ts.state, ts.time
    ts.step_frame()
    assert not ts.use_tiled and ts._ts is None
    want, t2 = tsolver.run_substeps(start, ts.model, ts.bcs, t1, 10, ts.grid,
                                    kw["substep_dt"], checkpoint_policy=None)
    assert ts.time == t2
    for f in FIELDS:
        assert torch.equal(getattr(ts.state, f), getattr(want, f)), f


def test_mpm_solver_postprocess_matches_jax():
    """postprocess: cov6 = F Sigma0 F^T from F_trial and the SH rotation R
    (stored transposed); the solver keeps cov6 in its state."""
    xyz, cov6, vol, v0 = _scene(400, 25)
    cfg = MPMConfig(**KW)
    js = jsolver.MPMSolver(jnp.asarray(xyz), jnp.asarray(cov6),
                           jnp.asarray(vol), cfg, jnp.asarray(v0))
    js.state = dataclasses.replace(
        js.state, F_trial=jnp.asarray(_rand_F(400, 26, 0.2)))
    ts = tsim_pkg.MPMSolver(xyz, cov6, vol, TMPMConfig(**KW), v0,
                            device="cpu")
    ts.state = _to_port(js.state)
    jc, jR = js.postprocess()
    tc, tR = ts.postprocess()
    assert _rel_err(tc, jc) <= 1e-5
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    assert torch.equal(ts.state.cov, tc)


def test_sim_package_exports():
    for name in ("MPMState", "MPMModel", "material_types", "MPMSolver",
                 "substep", "particle_volume"):
        assert hasattr(tsim_pkg, name), name
