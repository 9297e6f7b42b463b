"""The captured substep of the port's tiled frame (sim/tiles.py) on the CPU.

On CUDA ``frame_tiled`` replays one captured CUDA graph of
``_substep_body`` over static buffers (``_SubstepGraph``); here the same
graph object runs that body eagerly, on the kernels' plain twins, and is
held against the eager ``frame_tiled`` (bit for bit), against gsmpm_tpu's
``frame_tiled(impl="ref")`` and against ``_advance``'s host clock.  The
frame has a rebucket and an impulse and a fixed-cube window that open and
close inside it.  tests/test_torch_cuda.py holds the replayed graph
against the eager loop on the GPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsmpm_tpu.config import BoundaryConditionConfig, MPMConfig
from gsmpm_tpu.sim import tiles as jt
from gsmpm_tpu.sim.boundary import build_boundary_conditions
from gsmpm_tpu.sim.kernels import soa_from_state
from gsmpm_tpu.sim.state import GridConfig, init_model, init_state

from gsmpm_tpu_torch.config import BoundaryConditionConfig as TBC
from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.sim import boundary as tb
from gsmpm_tpu_torch.sim import tiles as tt
from gsmpm_tpu_torch.sim.kernels import soa_from_state as t_soa_from_state
from gsmpm_tpu_torch.sim.state import GridConfig as TGridConfig
from gsmpm_tpu_torch.sim.state import MPMState as TMPMState
from gsmpm_tpu_torch.sim.state import init_model as t_init_model

N, STEPS, DT = 2000, 20, 2e-3
KW = dict(E=2e4, nu=0.3, material="jelly", n_grid=16, grid_extent=2.0,
          substep_dt=DT, frame_dt=STEPS * DT, density=200.0)
# an impulse along +y over substeps 4-7 (its box holds no tile centre,
# where gsmpm_tpu's padding slots, massless, would take F / 0) and a fixed
# cube over substeps 10-14, both inside the frame
BCS = [
    dict(type="impulse", center=[0.8, 1.0, 1.2], size=[0.15, 0.3, 0.3],
         force=[0.0, 2.0, 0.0], start_time=4 * DT, num_dt=4),
    dict(type="fixed_cube", center=[1.3, 1.0, 1.0], size=[0.2, 0.2, 0.2],
         start_time=10 * DT, num_dt=5),
]
FIELDS = ("x", "v", "C", "F", "F_trial")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed=7):
    """The same seeded box for both packages, thrown along +x at ~7 m/s
    (its particles cross two cells, so the frame rebuckets)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0.5, 1.5, size=(N, 3)).astype(np.float32)
    cov6 = np.tile(np.float32([1e-4, 0, 0, 1e-4, 0, 1e-4]), (N, 1))
    vol = np.full(N, 1e-4, np.float32)
    v0 = (np.float32([7.0, 0.0, 0.0])
          + 0.5 * rng.normal(size=(N, 3))).astype(np.float32)
    cfg = MPMConfig(**KW)
    state = init_state(jnp.asarray(xyz), jnp.asarray(cov6), jnp.asarray(vol),
                       cfg)
    state = dataclasses.replace(state, v=jnp.asarray(v0))
    bcs, state, model = build_boundary_conditions(
        [BoundaryConditionConfig.from_dict(b) for b in BCS], cfg, state,
        init_model(cfg, N))
    tcfg = TMPMConfig(**KW)
    t_state = TMPMState(**{
        f.name: torch.from_numpy(np.array(getattr(state, f.name)))
        for f in dataclasses.fields(state)
    })
    t_bcs, t_state, t_model = tb.build_boundary_conditions(
        [TBC.from_dict(b) for b in BCS], tcfg, t_state,
        t_init_model(tcfg, N, "cpu"))
    grid = GridConfig(cfg.n_grid, cfg.grid_extent)
    return (state, model, bcs, grid), (t_state, t_model, t_bcs,
                                       TGridConfig(*grid))


@pytest.fixture(scope="module")
def frames():
    """One frame three ways from the same state: the substep graph's body
    run eagerly (with the device clock and the host clock after every
    substep), the eager ``frame_tiled``, gsmpm_tpu's ``frame_tiled``."""
    (state, model, bcs, grid), (t_state, t_model, t_bcs, t_grid) = _scene()
    tc = tt.default_tile_config(t_grid.n_grid, N)
    soa = t_soa_from_state(t_state)
    ts0 = tt.bootstrap(soa, t_model, t_grid, tc)

    rebuckets, host_reads = tt.frame_tiled.rebuckets, tt.frame_tiled.host_reads
    graph = tt._SubstepGraph(ts0, t_model, t_bcs, t_grid, tc, DT)
    graph.load(ts0, 0.0)
    t, clocks = 0.0, []
    for _ in range(STEPS):
        graph.step()
        t = tt._advance(t, DT)
        clocks.append((graph.clock.clone(), t))
    body = dict(ts=graph.state(), time=t, clocks=clocks,
                rebuckets=tt.frame_tiled.rebuckets - rebuckets,
                host_reads=tt.frame_tiled.host_reads - host_reads)

    ts_e, soa_e, t_e = tt.frame_tiled(ts0, soa, t_model, t_bcs, 0.0, STEPS,
                                      t_grid, tc, DT)
    eager = dict(ts=ts_e, soa=soa_e, time=t_e)

    jtc = jt.default_tile_config(grid.n_grid, N)
    jts = jt.bootstrap(soa_from_state(state), model, grid, jtc)
    _, soa_j, t_j = jt.frame_tiled(jts, soa_from_state(state), model, bcs,
                                   jnp.float32(0.0), STEPS, grid, jtc, DT,
                                   impl="ref")
    return body, eager, (soa_j, t_j), soa


def test_body_matches_eager_frame_bit_for_bit(frames):
    """(a) The captured body, driven by the graph's host part (one drift
    read a substep, the rebucket copied into the same buffers), gives the
    eager frame_tiled's tiled state bit for bit, rebucket included."""
    body, eager, _, _ = frames
    assert body["rebuckets"] >= 1
    assert body["host_reads"] == STEPS
    assert body["time"] == eager["time"]
    for f in dataclasses.fields(tt.TiledState):
        got, want = getattr(body["ts"], f.name), getattr(eager["ts"], f.name)
        assert got.dtype == want.dtype and torch.equal(got, want), f.name
    assert bool(body["ts"].ok)


def test_body_matches_jax_frame(frames):
    """(b) The same frame against gsmpm_tpu's frame_tiled(impl="ref"), with
    test_torch_tiles.py::test_run_substeps_tiled_matches_jax's tolerance:
    2e-6 of each field's scale, the float32 rounding of two contraction
    orders.  A field's scale is its largest magnitude (at least 1); C's is
    that of its summands, (4 / dx^2) |v| |x_i - x_p| ~ 4 |v| / dx, at
    least: C is a velocity gradient, and a box moving at ~7 m/s (for the
    rebucket) has a C far below the velocity's rounding over dx / 4 (~3e-6
    of |v| after one substep).  Both BC windows open and close inside the
    frame."""
    body, _, (soa_j, t_j), template = frames
    times = [t for _, t in body["clocks"]]
    starts = [0.0] + times[:-1]  # the clock each substep ran at
    for bc in BCS:
        lo = float(np.float32(bc["start_time"]))
        hi = float(np.float32(bc["start_time"] + DT * bc["num_dt"]))
        inside = [lo <= t < hi for t in starts]
        assert not inside[0] and any(inside) and not inside[-1], bc["type"]
    assert body["time"] == pytest.approx(float(t_j), abs=0)
    q = tt.to_original_order(body["ts"], N)
    soa_t = tt.unpack_q(q, template)
    v_max = float(np.abs(np.stack([np.asarray(p) for p in soa_j.v])).max())
    for name in FIELDS:
        want = np.stack([np.asarray(p) for p in getattr(soa_j, name)])
        got = torch.stack(getattr(soa_t, name)).numpy()
        scale = max(np.abs(want).max(), 1.0)
        if name == "C":
            scale = max(scale, 4.0 * v_max * KW["n_grid"] / KW["grid_extent"])
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-6,
                                   err_msg=name)


def test_device_clock_equals_host_clock(frames):
    """(c) After every substep the body's float32 clock tensor holds the
    bits of _advance's host clock."""
    body, _, _, _ = frames
    for clock, t in body["clocks"]:
        assert clock.dtype == torch.float32 and clock.shape == ()
        assert clock.numpy().view(np.uint32) == np.float32(t).view(np.uint32)


def _edge_times():
    """Just outside, at and just inside both edges of each window."""
    out = []
    for bc in BCS:
        lo = np.float32(bc["start_time"])
        hi = np.float32(bc["start_time"] + DT * bc["num_dt"])
        for edge in (lo, hi):
            out += [np.nextafter(edge, np.float32(-1)), edge,
                    np.nextafter(edge, np.float32(1))]
    return out


@pytest.mark.parametrize("time", _edge_times(), ids=lambda t: f"{t:.9g}")
def test_bc_masks_with_tensor_clock_match_jax(time):
    """(d) With a 0-d float32 tensor clock the impulse and the fixed cube
    act exactly where gsmpm_tpu's masks do, at the bits of the host-float
    clock's result."""
    (state, _, bcs, _), (t_state, _, t_bcs, _) = _scene()
    rng = np.random.default_rng(1)
    dx = 2.0 / KW["n_grid"]
    coords = rng.uniform(-2, 18, size=(3000, 3)).astype(np.float32)
    gv = rng.normal(size=(3000, 3)).astype(np.float32)
    clock = torch.tensor(time, dtype=torch.float32)
    (imp,), (cube,) = bcs.particle_ops, bcs.grid_ops
    (timp,), (tcube,) = t_bcs.particle_ops, t_bcs.grid_ops

    want = np.asarray(cube.apply_grid(jnp.asarray(gv), jnp.asarray(coords),
                                      jnp.float32(time), DT, dx))
    got = tcube.apply_grid(torch.from_numpy(gv), torch.from_numpy(coords),
                           clock, DT, dx)
    host = tcube.apply_grid(torch.from_numpy(gv), torch.from_numpy(coords),
                            float(time), DT, dx)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, host)
    active = bool(cube.start_time <= jnp.float32(time) < cube.end_time)
    assert bool((got.numpy() != gv).any()) == active

    v = rng.normal(size=(N, 3)).astype(np.float32)
    want = np.asarray(imp.apply_particles(state.x, jnp.asarray(v), state.mass,
                                          jnp.float32(time), DT))
    got = timp.apply_particles(t_state.x, torch.from_numpy(v), t_state.mass,
                               clock, DT)
    host = timp.apply_particles(t_state.x, torch.from_numpy(v), t_state.mass,
                                float(time), DT)
    assert torch.equal(got, host)
    # the same rows pushed; the push itself rounds in two runtimes
    np.testing.assert_array_equal(got.numpy() != v, want != v)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    active = bool(imp.start_time <= jnp.float32(time) < imp.end_time)
    assert bool((got.numpy() != v).any()) == active
