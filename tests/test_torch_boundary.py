"""The port's boundary conditions (all five types and the surface
collider) vs gsmpm_tpu's, built from the same configs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmpm_tpu.config import BoundaryConditionConfig, MPMConfig
from gsmpm_tpu.sim.boundary import build_boundary_conditions, make_surface_collider
from gsmpm_tpu.sim.state import init_model, init_state

from gsmpm_tpu_torch.config import BoundaryConditionConfig as TBC
from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.sim import boundary as tb
from gsmpm_tpu_torch.sim.state import init_model as t_init_model
from gsmpm_tpu_torch.sim.state import init_state as t_init_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BCS = [
    dict(type="fixed_cube", center=[1.0, 1.0, 0.5], size=[0.3, 0.3, 0.2],
         start_time=0.0, num_dt=20),
    dict(type="impulse", center=[1.0, 1.0, 1.0], size=[0.4, 0.4, 0.4],
         force=[0.0, 0.0, 5.0], start_time=1e-3, num_dt=10),
    dict(type="sticky_ground"),
    dict(type="additional_params", center=[1.0, 0.8, 1.0], size=[0.3, 0.3, 0.3],
         E=5e4, nu=0.2, density=500.0, mu=700.0),
    dict(type="modify_material", center=[0.8, 1.0, 1.0], size=[0.3, 0.3, 0.3],
         material="sand"),
]
KW = dict(E=2e5, nu=0.3, material="jelly", n_grid=16, substep_dt=1e-4,
          frame_dt=1e-2, density=200.0)


def _both(n=500, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0.3, 1.7, size=(n, 3)).astype(np.float32)
    cov6 = np.tile(np.asarray([1e-4, 0, 0, 1e-4, 0, 1e-4], np.float32), (n, 1))
    vol = np.full((n,), 1e-4, np.float32)
    cfg = MPMConfig(**KW)
    state = init_state(jnp.asarray(xyz), jnp.asarray(cov6), jnp.asarray(vol), cfg)
    bcs, state, model = build_boundary_conditions(
        [BoundaryConditionConfig.from_dict(b) for b in BCS], cfg, state,
        init_model(cfg, n))
    tcfg = TMPMConfig(**KW)
    T = torch.from_numpy
    tstate = t_init_state(T(xyz), T(cov6), T(vol), tcfg)
    tbcs, tstate, tmodel = tb.build_boundary_conditions(
        [TBC.from_dict(b) for b in BCS], tcfg, tstate,
        t_init_model(tcfg, n, "cpu"))
    return (bcs, state, model), (tbcs, tstate, tmodel), rng


def test_init_phase_bcs_match_jax():
    """additional_params (E, nu, density, mu override) and modify_material
    rewrite the same particles' parameters."""
    (_, state, model), (_, tstate, tmodel), _ = _both()
    for name in ("logE", "y", "mu", "lam"):
        np.testing.assert_allclose(getattr(tmodel, name).numpy(),
                                   np.asarray(getattr(model, name)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tmodel.material.numpy(),
                                  np.asarray(model.material))
    assert tmodel.active_materials == model.active_materials == (0, 2)
    np.testing.assert_array_equal(tstate.density.numpy(),
                                  np.asarray(state.density))
    np.testing.assert_allclose(tstate.mass.numpy(), np.asarray(state.mass),
                               rtol=1e-7)


@pytest.mark.parametrize("time", [0.0, 1.5e-3, 3e-3])
def test_grid_and_particle_bcs_match_jax(time):
    """fixed_cube (time window), sticky_ground and the collider on grid
    velocities; impulse (time window) on particle velocities."""
    (bcs, state, model), (tbcs, tstate, tmodel), rng = _both()
    dt, dx = KW["substep_dt"], 2.0 / KW["n_grid"]
    coll = make_surface_collider((0, 0, 0.4), (0, 0, 1), friction=0.3)
    tcoll = tb.make_surface_collider((0, 0, 0.4), (0, 0, 1), friction=0.3)
    coords = rng.uniform(-2, 18, size=(2000, 3)).astype(np.float32)
    gv = rng.normal(size=(2000, 3)).astype(np.float32)
    want, got = jnp.asarray(gv), torch.from_numpy(gv)
    for op, top in zip(bcs.grid_ops + (coll,), tbcs.grid_ops + (tcoll,)):
        want = op.apply_grid(want, jnp.asarray(coords), jnp.float32(time), dt, dx)
        got = top.apply_grid(got, torch.from_numpy(coords), time, dt, dx)
    # the collider's norm and friction scale round in two runtimes
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert (np.asarray(want) == 0).any()  # the cube/ground really zeroed
    v = rng.normal(size=(500, 3)).astype(np.float32)
    (imp,), (timp,) = bcs.particle_ops, tbcs.particle_ops
    vj = imp.apply_particles(state.x, jnp.asarray(v), state.mass,
                             jnp.float32(time), dt)
    vt = timp.apply_particles(tstate.x, torch.from_numpy(v), tstate.mass,
                              time, dt)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6,
                               atol=1e-6)
