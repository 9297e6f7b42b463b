"""The golden engine's captured bodies (sim/solver.py) on the CPU.

On CUDA ``run_substeps`` is gsmpm_tpu's one golden program: a call that
autograd does not record replays one cached CUDA graph of the golden
substep (``_GoldenGraph``: ``substep_soa`` at a 0-d float32 device clock,
its planes copied back into static buffers), and a recorded fitting call
under the "substep" policy runs ``_GoldenFittingWindow`` (a forward graph
replayed per substep, an adjoint graph that recomputes a substep and takes
its VJP replayed backwards).  Here the same bodies run eagerly:

- (a) the substep body at the device clock against a plain loop over
  ``substep_soa`` at the host clock, bit for bit, for plain,
  ``incremental_cov`` and fitting frames of a thrown box with an impulse
  and a fixed cube whose windows open and close inside the frame; the
  device clock holds ``_advance``'s bits;
- (b) each against gsmpm_tpu's jitted ``run_substeps`` from the same
  numpy-seeded state, carried across with models/convert.py;
- (c) the caches: a new model or BC set is a new substep graph, a new
  logE / y reuses the fitting window's graphs;
- (d) ``_golden_window`` against the checkpointed golden loop (forward bit
  for bit, gradients within GRAD_REL) and against gsmpm_tpu's
  ``value_and_grad`` of its checkpointed golden ``run_substeps``;
- (e) on 2 gloo ranks: the psum body (incremental_cov, the dense grid
  all-reduced) and the window with a group against the eager loops on the
  same ranks, the single-device port and gsmpm_tpu; ``_drop_group_graphs``
  frees the golden caches' group entries.

The ranks import no JAX: the parent runs gsmpm_tpu (~60 s of XLA
compile) and the single-device port while they work.
tests/test_torch_cuda.py holds the replayed graphs against the eager loops
on the GPU.
"""

import dataclasses
import functools
import multiprocessing
import os
import pickle
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gsmpm_tpu_torch.config import BoundaryConditionConfig as TBC
from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.models.convert import state_from_numpy
from gsmpm_tpu_torch.parallel import mesh as tmesh
from gsmpm_tpu_torch.sim import boundary as tb
from gsmpm_tpu_torch.sim import solver as so
from gsmpm_tpu_torch.sim.kernels import (
    soa_from_state,
    state_from_soa,
    substep_soa,
)
from gsmpm_tpu_torch.sim.state import GridConfig as TGridConfig
from gsmpm_tpu_torch.sim.state import init_model as t_init_model
from gsmpm_tpu_torch.sim.state import mu_lam_from_logE_y as t_mu_lam
from gsmpm_tpu_torch.sim.tiles import _advance, _drop_group_graphs

WORLD = 2
JOIN_TIMEOUT_S = 240
# a box thrown along +x on the 16^3 grid, one frame of 20 substeps
N, STEPS, DT = 4000, 20, 2e-3
KW = dict(E=2e4, nu=0.3, material="jelly", n_grid=16, grid_extent=2.0,
          substep_dt=DT, frame_dt=STEPS * DT, density=200.0)
# an impulse along +y over substeps 4-7 and a fixed cube over substeps
# 12-15: the device clock decides both
BCS = [
    dict(type="impulse", center=[0.8, 1.0, 1.2], size=[0.15, 0.3, 0.3],
         force=[0.0, 2.0, 0.0], start_time=4 * DT, num_dt=4),
    dict(type="fixed_cube", center=[1.3, 1.0, 1.0], size=[0.2, 0.2, 0.2],
         start_time=12 * DT, num_dt=4),
]
# (incremental_cov, fitting) of each frame
MODES = {"plain": (False, False), "incremental_cov": (True, False),
         "fitting": (False, True)}
FIELDS = ("x", "v", "C", "F", "F_trial", "cov")
# against gsmpm_tpu: test_torch_golden_route.py's tolerances, of each
# field's max (index_add_ against XLA's scatter-add, another order)
JAX_RTOL = dict(x=1e-5, v=1e-5, C=1e-4, F=1e-5, F_trial=1e-5, cov=1e-5)
# the window's gradients against the checkpointed loop's: the same
# float32 operations, summed in another order (dmu / dlam over the
# substeps, autograd's input buffers), of each gradient's largest
GRAD_REL = 1e-6
# the window against gsmpm_tpu's value_and_grad: test_torch_fit_graph.py's
JAX_FIELD_REL, JAX_GRAD_REL = 1e-4, 2e-4
# the sharded runs against the single-device ones: the grid summed over
# the ranks in another order (test_torch_mesh_graph.py's RTOL, of each
# field's max, at least 1)
MESH_RTOL = dict(x=1e-5, v=1e-5, C=1e-4, F=1e-5, F_trial=1e-5, cov=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# inputs, made with numpy from a seed
# ---------------------------------------------------------------------------

def frame_inputs(seed=7):
    """The box thrown along +x at ~3 m/s with a seeded spread, seeded
    anisotropic covariances (incremental_cov moves them)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0.6, 1.4, size=(N, 3)).astype(np.float32)
    A = 0.01 * rng.normal(size=(N, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].astype(np.float32)
    vol = np.full(N, 1e-4, np.float32)
    v0 = (np.float32([3.0, 0.0, 0.0])
          + 0.5 * rng.normal(size=(N, 3))).astype(np.float32)
    return xyz, cov6, vol, v0


def j_problem():
    """gsmpm_tpu's (state, model, bcs, grid) on frame_inputs()."""
    import jax.numpy as jnp

    from gsmpm_tpu.config import BoundaryConditionConfig, MPMConfig
    from gsmpm_tpu.sim.boundary import build_boundary_conditions
    from gsmpm_tpu.sim.state import GridConfig, init_model, init_state

    xyz, cov6, vol, v0 = (jnp.asarray(a) for a in frame_inputs())
    cfg = MPMConfig(**KW)
    state = init_state(xyz, cov6, vol, cfg, v0)
    bcs, state, model = build_boundary_conditions(
        [BoundaryConditionConfig.from_dict(b) for b in BCS], cfg, state,
        init_model(cfg, N))
    return state, model, bcs, GridConfig(cfg.n_grid, cfg.grid_extent)


@functools.lru_cache(maxsize=1)
def state_arrays():
    """gsmpm_tpu's initial state as numpy arrays: what the port's runs
    (and the ranks) start from."""
    state = j_problem()[0]
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def t_problem(arrays):
    """The port's (state, model, bcs, grid): the state carried across from
    gsmpm_tpu's, the model and BCs built from the same configuration."""
    cfg = TMPMConfig(**KW)
    state = state_from_numpy(arrays)
    bcs, state, model = tb.build_boundary_conditions(
        [TBC.from_dict(b) for b in BCS], cfg, state,
        t_init_model(cfg, N, "cpu"))
    return state, model, bcs, TGridConfig(cfg.n_grid, cfg.grid_extent)


def _loss(st):
    """A sum over particles, so the ranks' losses of their shards add up to
    the single-device loss."""
    return (torch.sum(st.x * torch.sin(st.x)) + torch.sum(st.F * st.F)
            + 0.1 * torch.sum(st.v * st.v) + 0.01 * torch.sum(st.C * st.C))


def _np(st):
    return {f: getattr(st, f).detach().numpy() for f in FIELDS}


def _equal(a, b):
    """The fields of two MPMStates that differ in any bit."""
    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name).detach(),
                               getattr(b, f.name).detach())]


def _close(got, want, rtol, what):
    for f in FIELDS:
        scale = max(1.0, float(np.abs(want[f]).max()))
        err = float(np.abs(got[f] - want[f]).max()) / scale
        assert err <= rtol[f], f"{what}: {f} off by {err:.3g} of max"


# ---------------------------------------------------------------------------
# the port's runs
# ---------------------------------------------------------------------------

def graph_frame(state, model, bcs, grid, inc, fit, group=None):
    """STEPS substeps of the cached golden substep graph (its body run
    eagerly here), as run_substeps drives it on CUDA.  Returns (state, host
    clock, the graph)."""
    with torch.no_grad():
        graph = so._golden_graph(state, model, bcs, grid, DT, inc, fit,
                                 group)
        graph.load(state, 0.0)
        t = 0.0
        for _ in range(STEPS):
            graph.step()
            t = _advance(t, DT)
        return graph.state(), t, graph


def eager_frame(state, model, bcs, grid, inc, fit, group=None):
    """The plain loop over substep_soa at the host clock."""
    with torch.no_grad():
        soa, t = soa_from_state(state), 0.0
        for _ in range(STEPS):
            soa = substep_soa(soa, model, bcs, t, grid, DT,
                              incremental_cov=inc, group=group, fitting=fit)
            t = _advance(t, DT)
        return state_from_soa(soa), t


@functools.lru_cache(maxsize=None)
def port_frames(mode):
    """(graph state, host clock, device clock bits, eager state, eager
    clock, the graph state once more after STEPS more substeps)."""
    inc, fit = MODES[mode]
    state, model, bcs, grid = t_problem(state_arrays())
    got, t, graph = graph_frame(state, model, bcs, grid, inc, fit)
    bits = graph.clock.numpy().copy().view(np.uint32)
    held = {f.name: getattr(got, f.name).clone()
            for f in dataclasses.fields(got)}
    with torch.no_grad():
        for _ in range(STEPS):
            graph.step()
    want, t_want = eager_frame(state, model, bcs, grid, inc, fit)
    return got, t, bits, want, t_want, held


def window_run(state, model, bcs, grid, window: bool, group=None):
    """(state', loss, (d logE, d y, d x0), host clock) through
    _golden_window (window) or run_substeps' checkpointed golden loop."""
    logE = model.logE.clone().requires_grad_(True)
    y = model.y.clone().requires_grad_(True)
    x0 = state.x.clone().requires_grad_(True)
    mu, lam = t_mu_lam(logE, y)
    m = dataclasses.replace(model, logE=logE, y=y, mu=mu, lam=lam)
    s0 = dataclasses.replace(state, x=x0)
    with torch.enable_grad():
        if window:
            st, t = so._golden_window(s0, m, bcs, 0.0, STEPS, grid, DT,
                                      group=group)
        else:
            st, t = so.run_substeps(s0, m, bcs, 0.0, STEPS, grid, DT,
                                    group=group, fitting=True,
                                    checkpoint_policy="substep")
        loss = _loss(st)
    grads = torch.autograd.grad(loss, (logE, y, x0))
    return st, loss.detach(), grads, t


@functools.lru_cache(maxsize=None)
def port_windows():
    state, model, bcs, grid = t_problem(state_arrays())
    return dict(window=window_run(state, model, bcs, grid, True),
                checkpointed=window_run(state, model, bcs, grid, False))


# ---------------------------------------------------------------------------
# gsmpm_tpu's runs
# ---------------------------------------------------------------------------

def _jax_frames():
    """gsmpm_tpu's jitted run_substeps of the plain and incremental_cov
    frames: {mode: (fields, clock)}."""
    import jax
    import jax.numpy as jnp

    from gsmpm_tpu.sim.solver import run_substeps

    state, model, bcs, grid = j_problem()
    frames = {}
    for mode in ("plain", "incremental_cov"):
        inc, fit = MODES[mode]
        run = jax.jit(lambda s, t, inc=inc, fit=fit: run_substeps(
            s, model, bcs, t, STEPS, grid, DT, incremental_cov=inc,
            fitting=fit, checkpoint_policy=None))
        st, t = run(state, jnp.float32(0.0))
        frames[mode] = ({f: np.asarray(getattr(st, f)) for f in FIELDS},
                        float(t))
    return frames


def _jax_fit():
    """gsmpm_tpu's jitted value_and_grad of its checkpointed golden fitting
    window (fitting.py's golden route): (loss, grads, fields, clock); its
    forward is the fitting frame."""
    import jax
    import jax.numpy as jnp

    from gsmpm_tpu.sim.solver import run_substeps
    from gsmpm_tpu.sim.state import mu_lam_from_logE_y

    state, model, bcs, grid = j_problem()

    def jloss(logE, y, x0):
        mu, lam = mu_lam_from_logE_y(logE, y)
        m = dataclasses.replace(model, logE=logE, y=y, mu=mu, lam=lam)
        st, t = run_substeps(dataclasses.replace(state, x=x0), m, bcs,
                             jnp.float32(0.0), STEPS, grid, DT, fitting=True,
                             checkpoint_policy="substep")
        return (jnp.sum(st.x * jnp.sin(st.x)) + jnp.sum(st.F * st.F)
                + 0.1 * jnp.sum(st.v * st.v)
                + 0.01 * jnp.sum(st.C * st.C)), (st, t)

    (loss, (st, t)), grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(model.logE, model.y,
                                                 state.x)
    return (float(loss), [np.asarray(g) for g in grads],
            {f: np.asarray(getattr(st, f)) for f in FIELDS}, float(t))


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _case_psum(mesh, arrays):
    """The psum body (incremental_cov) on this rank's shard against the
    eager run_substeps(group=) loop on the same ranks."""
    state, model, bcs, grid = t_problem(arrays)
    st, md = tmesh.shard((state, model), mesh)
    got, t, graph = graph_frame(st, md, bcs, grid, True, False, mesh.group)
    with torch.no_grad():
        want, t_want = so.run_substeps(st, md, bcs, 0.0, STEPS, grid, DT,
                                       incremental_cov=True,
                                       group=mesh.group,
                                       checkpoint_policy=None)
    return dict(differ=_equal(got, want), t=(t, t_want),
                clock=graph.clock.numpy().copy().view(np.uint32),
                entry_group=graph.group is mesh.group,
                state=_np(tmesh.gather(got, mesh)))


def _case_fit(mesh, arrays):
    """The window with the group against the checkpointed
    run_substeps(fitting=True, group=) loop on the same ranks."""
    state, model, bcs, grid = t_problem(arrays)
    st, md = tmesh.shard((state, model), mesh)
    w = window_run(st, md, bcs, grid, True, mesh.group)
    c = window_run(st, md, bcs, grid, False, mesh.group)
    rel = {}
    for name, a, b in zip(("logE", "y", "x0"), w[2], c[2]):
        scale = float(b.abs().max())
        rel[name] = float((a - b).abs().max()) / scale if scale else None
    loss = w[1].clone()
    dist.all_reduce(loss, group=mesh.group)
    gather = lambda t: tmesh.all_gather_cat(t.detach().contiguous(), mesh)
    return dict(differ=_equal(w[0], c[0]), equal_loss=torch.equal(w[1], c[1]),
                t=(w[3], c[3]), grad_rel=rel, loss=float(loss),
                grads=[gather(g).numpy() for g in w[2]],
                state={f: gather(getattr(w[0], f)).numpy() for f in FIELDS})


def _case_cache(mesh, arrays):
    """The golden caches' group entries (the two cases' and a
    single-device entry beside them): _drop_group_graphs removes exactly
    the group's."""
    state, model, bcs, grid = t_problem(arrays)
    single = so._golden_graph(state, model, bcs, grid, DT, False, False)
    golden = lambda: (list(so._GOLDEN_GRAPHS.values())
                      + list(so._GOLDEN_FIT_GRAPHS.values()))
    grouped = [e for e in golden() if e.group is mesh.group]
    return dict(grouped=len(grouped), dropped=_drop_group_graphs(mesh.group),
                left=all(e.group is None for e in golden()),
                single_kept=any(e is single for e in golden()))


def _worker(rank, world, port, out_path, arrays):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        mesh = tmesh.make_mesh((("data", world),), "cpu")
        res = dict(psum=_case_psum(mesh, arrays), fit=_case_fit(mesh, arrays),
                   cache=_case_cache(mesh, arrays))
        every = [None] * world
        dist.all_gather_object(every, res)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(every, f)
    finally:
        _drop_group_graphs()
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(procs, out, deadline):
    """Join procs by deadline (killing what still runs); the list each
    wrote to out."""
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} of {len(procs)} processes still " \
                     f"running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2 ranks' results (started first); gsmpm_tpu's runs and the
    single-device port's frames and windows computed here meanwhile."""
    arrays = state_arrays()
    out = str(tmp_path_factory.mktemp("golden_graph") / "ranks.pkl")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, WORLD, port, out, arrays))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        frames = _jax_frames()
        loss, grads, fit_state, t = _jax_fit()
        for mode in MODES:
            port_frames(mode)
        port_windows()
    finally:
        ranks = _join(procs, out, deadline)
    return dict(ranks=ranks, jax_frames=dict(frames, fitting=(fit_state, t)),
                jax_fit=(loss, grads, fit_state))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_psum_body_matches_eager_loop_single_and_jax(runs):
    """(e) Each rank's psum body (the dense grid all-reduced over the
    group, incremental_cov) against the eager run_substeps(group=) loop on
    the same ranks, bit for bit, the device clock holding the host clock's
    bits; the gathered state against the single-device graph frame and
    gsmpm_tpu's jitted run_substeps (MESH_RTOL)."""
    ranks = runs["ranks"]
    for r, res in enumerate(ranks):
        got = res["psum"]
        assert got["differ"] == [], (r, got["differ"])
        t, t_want = got["t"]
        assert t == t_want and got["entry_group"]
        assert got["clock"] == np.float32(t).view(np.uint32)
    state = ranks[0]["psum"]["state"]
    single = _np(port_frames("incremental_cov")[0])
    _close(state, single, MESH_RTOL, "psum x2 vs the single-device body")
    jax_state, _ = runs["jax_frames"]["incremental_cov"]
    _close(state, jax_state, MESH_RTOL, "psum x2 vs gsmpm_tpu")


def test_window_with_group_matches_checkpointed(runs):
    """(e) The window with the group: forward bit for bit against the
    checkpointed run_substeps(fitting=True, group=) loop on the same
    ranks, d logE / d y / d x0 within GRAD_REL of its gradients'."""
    for r, res in enumerate(runs["ranks"]):
        got = res["fit"]
        assert got["differ"] == [] and got["equal_loss"], (r, got["differ"])
        assert got["t"][0] == got["t"][1]
        for name, rel in got["grad_rel"].items():
            assert rel is not None and rel <= GRAD_REL, (r, name, rel)


def test_window_with_group_matches_single_and_jax(runs):
    """(e) The ranks' window, losses summed and gradients gathered, against
    the single-device window and gsmpm_tpu's value_and_grad of the whole
    box (JAX_FIELD_REL / JAX_GRAD_REL)."""
    got = runs["ranks"][0]["fit"]
    st_s, loss_s, g_s, _ = port_windows()["window"]
    loss_j, g_j, st_j = runs["jax_fit"]
    for want, loss, grads, who in ((_np(st_s), float(loss_s),
                                    [g.numpy() for g in g_s], "port"),
                                   (st_j, loss_j, g_j, "gsmpm_tpu")):
        for f in ("x", "v", "C", "F"):
            scale = np.abs(want[f]).max() + 1e-12
            err = np.abs(got["state"][f] - want[f]).max() / scale
            assert err < JAX_FIELD_REL, (who, f, err)
        assert got["loss"] == pytest.approx(loss, rel=1e-5), who
        for name, a, b in zip(("d_logE", "d_y", "d_x0"), got["grads"],
                              grads):
            err = np.abs(a - b).max() / (np.abs(b).max() + 1e-12)
            assert err < JAX_GRAD_REL, (who, name, err)


def test_drop_group_graphs_frees_the_golden_group_entries(runs):
    """(e) The psum graph and the window's graphs are cached under the
    group; _drop_group_graphs(group) frees those two and keeps the
    single-device entry."""
    for r, res in enumerate(runs["ranks"]):
        got = res["cache"]
        assert got["grouped"] == 2 and got["dropped"] == 2, (r, got)
        assert got["left"] and got["single_kept"], (r, got)


@pytest.mark.parametrize("mode", list(MODES))
def test_body_at_device_clock_matches_plain_loop(mode):
    """(a) The captured body run eagerly (substep_soa at the 0-d float32
    clock, planes copied back in place, clock += dt) against the plain
    loop over substep_soa at the host clock: every field bit for bit, the
    same host clock, the device clock holding its bits; the returned
    state owns its tensors (more substeps leave it)."""
    got, t, bits, want, t_want, held = port_frames(mode)
    assert _equal(got, want) == []
    assert t == t_want
    assert bits == np.float32(t).view(np.uint32)
    for name, h in held.items():
        assert torch.equal(getattr(got, name), h), name


@pytest.mark.parametrize("mode", list(MODES))
def test_body_matches_jax_run_substeps(runs, mode):
    """(b) The graph frame against gsmpm_tpu's jitted run_substeps from the
    same state: JAX_RTOL of each field's max, the same float32 clock; the
    windows did act (the impulse moved v, incremental_cov moved cov)."""
    got, t, _, _, _, _ = port_frames(mode)
    want, t_jax = runs["jax_frames"][mode]
    assert np.float32(t) == np.float32(t_jax)
    _close(_np(got), want, JAX_RTOL, f"{mode} vs gsmpm_tpu")
    start = state_arrays()
    moved = np.abs(want["cov"] - start["cov"]).max()
    assert (moved > 0) == MODES[mode][0], moved


def test_impulse_and_cube_windows_act_inside_the_frame():
    """The BCs' windows open and close inside the frame on the device
    clock: without them the plain frame differs."""
    got = port_frames("plain")[0]
    state, model, _, grid = t_problem(state_arrays())
    bare, _, _ = graph_frame(state, model, tb.BCSet(), grid, False, False)
    assert float((got.v - bare.v).abs().max()) > 1e-3


def test_device_clock_equals_advance_each_substep():
    """(a) The body's clock after every substep, from an odd start time,
    holds the bits of _advance's host clock."""
    state, model, bcs, grid = t_problem(state_arrays())
    graph = so._GoldenGraph(state, model, bcs, grid, DT, False, False)
    t = 0.0123
    with torch.no_grad():
        graph.load(state, t)
        for _ in range(5):
            graph.step()
            t = _advance(t, DT)
            clock = graph.clock
            assert clock.dtype == torch.float32 and clock.shape == ()
            assert clock.numpy().view(np.uint32) == np.float32(t).view(
                np.uint32)


def test_golden_graph_cache_keys_model_and_bcs_by_identity():
    """(c) The same model and BC set reuse the cached graph; a new model
    (other tensors) or a new BC set (even of equal values) builds a new
    one, and so do another mode and another dt."""
    state, model, bcs, grid = t_problem(state_arrays())
    first = so._golden_graph(state, model, bcs, grid, DT, False, False)
    assert so._golden_graph(state, model, bcs, grid, DT, False,
                            False) is first
    other = dataclasses.replace(model, gravity=model.gravity.clone())
    assert so._golden_graph(state, other, bcs, grid, DT, False,
                            False) is not first
    _, _, bcs2, _ = t_problem(state_arrays())
    assert so._golden_graph(state, model, bcs2, grid, DT, False,
                            False) is not first
    assert so._golden_graph(state, model, bcs, grid, DT, True,
                            False) is not first
    assert so._golden_graph(state, model, bcs, grid, 1e-3, False,
                            False) is not first


def test_fitting_graphs_cache_keys_gravity_and_bcs_by_value():
    """(c) A new logE / y and a new BC set of the same values reuse the
    window's graphs (no capture on CUDA); another gravity or BC box does
    not, and the graphs own copies of what they were built with."""
    state, model, bcs, grid = t_problem(state_arrays())
    first = so._golden_fitting_graphs(state, model, bcs, grid, DT)
    logE = model.logE + 0.5
    mu, lam = t_mu_lam(logE, model.y)
    model2 = dataclasses.replace(model, logE=logE, mu=mu, lam=lam)
    assert so._golden_fitting_graphs(state, model2, bcs, grid, DT) is first
    _, _, bcs2, _ = t_problem(state_arrays())
    assert so._golden_fitting_graphs(state, model, bcs2, grid, DT) is first
    gravity = dataclasses.replace(
        model, gravity=torch.tensor([0.0, -1.0, 0.0]))
    assert so._golden_fitting_graphs(state, gravity, bcs, grid,
                                     DT) is not first
    wider = tb.BCSet(grid_ops=(tb.FixedCubeBC(
        torch.tensor([1.3, 1.0, 1.0]), torch.tensor([0.3, 0.2, 0.2]),
        12 * DT, 16 * DT),))
    assert so._golden_fitting_graphs(state, model, wider, grid,
                                     DT) is not first
    assert first.bcs.grid_ops[0].center is not bcs.grid_ops[0].center
    assert first.gravity is not model.gravity


def test_window_forward_matches_checkpointed_bit_for_bit():
    """(d) The window's forward (the forward body on the static buffers)
    gives the checkpointed golden loop's state, loss and clock bit for
    bit."""
    runs = port_windows()
    st_w, loss_w, _, t_w = runs["window"]
    st_c, loss_c, _, t_c = runs["checkpointed"]
    assert _equal(st_w, st_c) == []
    assert torch.equal(loss_w, loss_c) and t_w == t_c


def test_window_grads_match_checkpointed():
    """(d) d logE, d y and d x0 through the window's backward (the adjoint
    body per substep) against autograd through the checkpointed substeps:
    GRAD_REL of each gradient's largest magnitude."""
    runs = port_windows()
    for name, a, b in zip(("logE", "y", "x0"), runs["window"][2],
                          runs["checkpointed"][2]):
        scale = float(b.abs().max())
        assert scale > 0, name
        assert float((a - b).abs().max()) <= GRAD_REL * scale, name


def test_window_matches_jax_value_and_grad(runs):
    """(d) The window's state, loss and gradients against gsmpm_tpu's
    value_and_grad of its checkpointed golden run_substeps
    (test_torch_fit_graph.py's tolerances)."""
    st_w, loss_w, g_w, _ = port_windows()["window"]
    loss_j, g_j, st_j = runs["jax_fit"]
    got = _np(st_w)
    for f in ("x", "v", "C", "F"):
        scale = np.abs(st_j[f]).max() + 1e-12
        assert np.abs(got[f] - st_j[f]).max() / scale < JAX_FIELD_REL, f
    assert float(loss_w) == pytest.approx(loss_j, rel=1e-5)
    for name, a, b in zip(("d_logE", "d_y", "d_x0"), g_w, g_j):
        err = np.abs(a.numpy() - b).max() / (np.abs(b).max() + 1e-12)
        assert err < JAX_GRAD_REL, (name, err)


def test_window_rejects_gradients_it_does_not_carry():
    """The window differentiates x, v, C, F (cov) and mu / lam; a mass that
    requires grad is refused rather than silently given no gradient."""
    state, model, bcs, grid = t_problem(state_arrays())
    s = dataclasses.replace(state, mass=state.mass.clone().requires_grad_())
    with pytest.raises(ValueError, match="mass"):
        so._golden_window(s, model, bcs, 0.0, 1, grid, DT)


def test_run_substeps_on_cpu_keeps_the_eager_loop():
    """On the CPU run_substeps runs its loop: no graph cached, nothing
    captured or replayed, the body's frame bit for bit."""
    state, model, bcs, grid = t_problem(state_arrays())
    counts = (so.run_substeps.captures, so.run_substeps.replays)
    cached = len(so._GOLDEN_GRAPHS) + len(so._GOLDEN_FIT_GRAPHS)
    with torch.no_grad():
        st, t = so.run_substeps(state, model, bcs, 0.0, STEPS, grid, DT,
                                checkpoint_policy=None)
    assert (so.run_substeps.captures, so.run_substeps.replays) == counts
    assert len(so._GOLDEN_GRAPHS) + len(so._GOLDEN_FIT_GRAPHS) == cached
    got, t_got = port_frames("plain")[:2]
    assert _equal(st, got) == [] and t == t_got
