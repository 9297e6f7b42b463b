"""The mesh paths' captured bodies (sim/tiles.py with a process group) on
2 gloo ranks.

On CUDA the chunk-sharded tiled frame (parallel/tiled_sharded.py) replays
one captured substep graph per segment substep, the grid's NCCL all-reduce
inside, and the data-sharded fit step runs ``tiles._FittingWindow`` whose
forward and adjoint graphs hold the all-reduces.  Here the ranks are CPU
processes (``multiprocessing`` spawn, a free localhost port, a join
timeout) and the same bodies run eagerly on the kernels' plain twins:

- (a) the sharded frame against the eager ``substep_tiled(group=)`` loop
  on the same ranks (bit for bit), against the single-device
  ``frame_tiled`` and gsmpm_tpu's tiled frame (test_torch_parallel.py's
  RTOL), with an impulse and a fixed cube that open and close inside it;
- (b) ``tiles._fitting_window(..., group=)`` against the checkpointed
  ``substep_tiled_fitting(group=)`` loop (forward bit for bit, gradients
  within GRAD_REL) and against gsmpm_tpu's single-device ``value_and_grad``
  (rebuckets inside the window);
- (c) the graph caches name the group: a new group builds anew, and
  ``tiles._drop_group_graphs`` removes exactly its entries.

The ranks import no JAX: the parent runs gsmpm_tpu while they work.
tests/test_torch_cuda.py holds the replayed graphs against the eager
loops on a one-rank NCCL group on the GPU.
"""

import dataclasses
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
from gsmpm_tpu_torch.parallel import mesh as tmesh
from gsmpm_tpu_torch.sim import boundary as tb
from gsmpm_tpu_torch.sim import tiles as tt

WORLD = 2
JOIN_TIMEOUT_S = 120
# the frame: a thrown box on the 16^3 grid, 2 segments of 10 substeps
N, STEPS, SEG, DT = 2000, 20, 10, 2e-3
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
FIELDS = ("x", "v", "C", "F", "F_trial")
# the sharded frame against the single-device frames: the grid summed in
# another order, rebucketed per segment instead of on drift
# (test_torch_parallel.py's RTOL: of each field's max, at least 1)
RTOL = dict(x=1e-5, v=1e-5, C=1e-4, F=1e-5, F_trial=1e-5)
# the fit: test_torch_fit_graph.py's substeps and tolerances
FIT_SUB = 7
GRAD_REL = 1e-6
JAX_FIELD_REL, JAX_GRAD_REL = 1e-4, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# inputs, made with numpy from seeds
# ---------------------------------------------------------------------------

def frame_inputs(seed=7):
    """The box thrown along +x at ~7 m/s with a seeded spread."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0.5, 1.5, size=(N, 3)).astype(np.float32)
    cov6 = np.tile(np.float32([1e-4, 0, 0, 1e-4, 0, 1e-4]), (N, 1))
    vol = np.full(N, 1e-4, np.float32)
    v0 = (np.float32([7.0, 0.0, 0.0])
          + 0.5 * rng.normal(size=(N, 3))).astype(np.float32)
    return xyz, cov6, vol, v0


def t_frame_problem():
    """The port's (state, model, bcs, grid) on frame_inputs()."""
    from gsmpm_tpu_torch.sim.state import GridConfig, init_model, init_state

    xyz, cov6, vol, v0 = (torch.from_numpy(a) for a in frame_inputs())
    cfg = TMPMConfig(**KW)
    state = init_state(xyz, cov6, vol, cfg, v0)
    bcs, state, model = tb.build_boundary_conditions(
        [TBC.from_dict(b) for b in BCS], cfg, state,
        init_model(cfg, N, "cpu"))
    return state, model, bcs, GridConfig(cfg.n_grid, cfg.grid_extent)


def _fit_bcs():
    return tb.BCSet(grid_ops=(tb.sticky_ground("cpu"),))


def _fit_loss(st):
    """test_torch_fit_graph.py's loss: a sum over particles, so the ranks'
    losses of their shards add up to the single-device loss."""
    return (torch.sum(st.x * torch.sin(st.x)) + torch.sum(st.F * st.F)
            + 0.1 * torch.sum(st.v * st.v) + 0.01 * torch.sum(st.C * st.C))


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _eager_frame(mesh, ts_loc, time, model, bcs, grid, tc):
    """The sharded frame as the eager substep_tiled(group=) loop: per
    segment the gathered rebucket, SEG substeps, the hard-drift flag."""
    from gsmpm_tpu_torch.parallel.tiled_sharded import (
        _hard_drift, gather_tiled, shard_tiled,
    )

    ok = ts_loc.ok
    for _ in range(STEPS // SEG):
        ts_loc = shard_tiled(tt.rebucket(gather_tiled(ts_loc, mesh), grid,
                                         tc), mesh, tc)
        ok = ok & ts_loc.ok
        for _ in range(SEG):
            ts_loc = tt.substep_tiled(ts_loc, model, bcs, time, grid, tc, DT,
                                      group=mesh.group,
                                      rebucket_on_drift=False)
            time = tt._advance(time, DT)
        bad = _hard_drift(ts_loc.q, grid, tc,
                          ts_loc.chunk_tile).to(torch.int32).reshape(1)
        dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=mesh.group)
        ok = ok & (bad[0] == 0)
    ts_loc = dataclasses.replace(ts_loc, ok=ok)
    q_full = tt.to_original_order(ts_loc, tc.n_particles).contiguous()
    dist.all_reduce(q_full, group=mesh.group)
    return ts_loc, q_full, time


def _frame_setup(mesh):
    from gsmpm_tpu_torch.parallel.tiled_sharded import (
        shard_tiled, sharded_tile_config,
    )
    from gsmpm_tpu_torch.sim.kernels import soa_from_state

    state, model, bcs, grid = t_frame_problem()
    st, md, _, _ = tmesh.pad_particles(state, model, mesh.world_size)
    tc = sharded_tile_config(grid.n_grid, st.x.shape[0], mesh.world_size)
    ts = shard_tiled(tt.bootstrap(soa_from_state(st), md, grid, tc), mesh,
                     tc)
    return ts, md, bcs, grid, tc


def _case_frame(mesh):
    from gsmpm_tpu_torch.parallel.tiled_sharded import (
        make_sharded_frame_tiled,
    )

    ts0, md, bcs, grid, tc = _frame_setup(mesh)
    fn = make_sharded_frame_tiled(mesh, model=md, bcs=bcs, grid=grid, tc=tc,
                                  dt=DT, n_substeps=STEPS,
                                  rebucket_every=SEG)
    f = tt.frame_tiled
    before = (f.host_reads, f.rebuckets, f.captures, f.replays)
    ts_g, q_g, t_g = fn(ts0, 0.0)
    counters = [a - b for a, b in zip(
        (f.host_reads, f.rebuckets, f.captures, f.replays), before)]
    ts_e, q_e, t_e = _eager_frame(mesh, ts0, 0.0, md, bcs, grid, tc)
    entry = next(reversed(tt._GRAPHS.values()))
    return dict(
        equal_q=torch.equal(q_g, q_e),
        equal_ts={k: torch.equal(a, b) for k, a, b in zip(
            [f.name for f in dataclasses.fields(ts_g)], tt._tensors(ts_g),
            tt._tensors(ts_e))},
        t=(t_g, t_e), ok=(bool(ts_g.ok), bool(ts_e.ok)), counters=counters,
        clock=entry.clock.numpy().copy(), entry_group=entry.group is
        mesh.group, q=q_g.numpy())


def _case_fit(mesh, arrays):
    from gsmpm_tpu_torch.models.convert import state_from_numpy
    from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa
    from gsmpm_tpu_torch.sim.state import GridConfig, init_model
    from gsmpm_tpu_torch.sim.state import mu_lam_from_logE_y

    kw = dict(material="jelly", E=1e4, nu=0.3, n_grid=24, grid_extent=2.0,
              gravity=[0.0, -9.81, 0.0], fitting=True)
    state = state_from_numpy(arrays)
    n = state.x.shape[0]
    model0 = init_model(TMPMConfig(**kw), n, "cpu")
    st_l, md_l = tmesh.shard((state, model0), mesh)
    nl = st_l.x.shape[0]
    grid = GridConfig(24, 2.0)
    tc = tt.TileConfig(grid.n_grid, nl, S=256, n_occ_cap=8)
    dt = 0.03 / 30
    f = tt.run_substeps_tiled_fitting

    def run(window: bool):
        logE = md_l.logE.clone().requires_grad_(True)
        y = md_l.y.clone().requires_grad_(True)
        x0 = st_l.x.clone().requires_grad_(True)
        mu, lam = mu_lam_from_logE_y(logE, y)
        model = dataclasses.replace(md_l, logE=logE, y=y, mu=mu, lam=lam)
        soa = soa_from_state(dataclasses.replace(st_l, x=x0))
        ts = tt.bootstrap(soa, model, grid, tc)
        before = (f.host_reads, f.rebuckets)
        if window:
            ts = tt._fitting_window(ts, model, _fit_bcs(), 0.0, FIT_SUB,
                                    grid, tc, dt, group=mesh.group)
        else:
            t = 0.0
            for _ in range(FIT_SUB):
                ts = tt.substep_tiled_fitting(ts, model, _fit_bcs(), t, grid,
                                              tc, dt, group=mesh.group)
                t = tt._advance(t, dt)
        counts = (f.host_reads - before[0], f.rebuckets - before[1])
        st = state_from_soa(tt.unpack_q(tt.to_original_order(ts, nl), soa))
        loss = _fit_loss(st)
        grads = torch.autograd.grad(loss, (logE, y, x0))
        return ts, st, loss.detach(), grads, counts

    ts_w, st_w, loss_w, g_w, counts_w = run(True)
    ts_c, st_c, loss_c, g_c, _ = run(False)
    rel = {}
    for name, a, b in zip(("logE", "y", "x0"), g_w, g_c):
        scale = float(b.abs().max())
        rel[name] = float((a - b).abs().max()) / scale if scale else None
    loss = loss_w.clone()
    dist.all_reduce(loss, group=mesh.group)
    gather = lambda t: tmesh.all_gather_cat(t.detach().contiguous(), mesh)
    return dict(
        equal_ts={k.name: torch.equal(a.detach(), b.detach()) for k, a, b in
                  zip(dataclasses.fields(ts_w), tt._tensors(ts_w),
                      tt._tensors(ts_c))},
        equal_loss=torch.equal(loss_w, loss_c), grad_rel=rel,
        counts=counts_w, ok=bool(ts_w.ok), loss=float(loss),
        grads=[gather(g).numpy() for g in g_w],
        state={k: gather(getattr(st_w, k)).numpy() for k in FIELDS})


def _case_cache(mesh):
    """Cache entries by group, without a capture (the CPU builds none)."""
    ts, md, bcs, grid, tc = _frame_setup(mesh)
    other = dist.new_group(list(range(mesh.world_size)))
    sub = lambda g: tt._substep_graph(ts, md, bcs, grid, tc, DT, g)
    fit = lambda g: tt._fitting_graphs(ts, md, bcs, grid, tc, DT, g)
    a, fa = sub(mesh.group), fit(mesh.group)
    b, fb = sub(other), fit(other)
    c, fc = sub(None), fit(None)
    res = dict(same=sub(mesh.group) is a and fit(mesh.group) is fa,
               other_new=b is not a and fb is not fa,
               groups=(b.group is other and fb.group is other
                       and c.group is None and fc.group is None))
    res["dropped_other"] = tt._drop_group_graphs(other)
    cached = lambda: (list(tt._GRAPHS.values())
                      + list(tt._FIT_GRAPHS.values()))
    res["other_gone"] = not any(e in (b, fb) for e in cached())
    res["rest_kept"] = all(any(e is x for x in cached())
                           for e in (a, fa, c, fc))
    res["other_anew"] = sub(other) is not b and fit(other) is not fb
    res["dropped_all"] = tt._drop_group_graphs()
    res["single_kept"] = (all(any(e is x for x in cached()) for e in (c, fc))
                          and all(e.group is None for e in cached()))
    return res


def _worker(rank, world, port, out_path, fit_arrays):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        mesh = tmesh.make_mesh((("data", world),), "cpu")
        res = dict(frame=_case_frame(mesh), fit=_case_fit(mesh, fit_arrays),
                   cache=_case_cache(mesh))
        every = [None] * world
        dist.all_gather_object(every, res)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(every, f)
    finally:
        tt._drop_group_graphs()
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the parent: the ranks, the single-device port and gsmpm_tpu
# ---------------------------------------------------------------------------

def _jax_fit(scene):
    """gsmpm_tpu's value_and_grad of its tiled fitting window on the whole
    blob (test_torch_fit_graph.py's, FIT_SUB substeps), on the XLA adjoint
    it takes on the CPU (test_torch_fit_graph.py holds the port's window
    against the Pallas adjoint, ~10 s more of compile)."""
    import jax
    import jax.numpy as jnp

    from gsmpm_tpu.sim import tiles as jt
    from gsmpm_tpu.sim.boundary import BCSet, StickyGroundBC
    from gsmpm_tpu.sim.kernels import soa_from_state, state_from_soa
    from gsmpm_tpu.sim.state import mu_lam_from_logE_y

    state, model, grid = scene
    bcs = BCSet(grid_ops=(StickyGroundBC(),))

    def jloss(logE, y, x0):
        mu, lam = mu_lam_from_logE_y(logE, y)
        m = dataclasses.replace(model, logE=logE, y=y, mu=mu, lam=lam)
        soa, _, ok = jt.run_substeps_tiled_fitting(
            soa_from_state(dataclasses.replace(state, x=x0)), m, bcs,
            jnp.float32(0.0), FIT_SUB, grid, 0.03 / 30, chunk_impl="vjp")
        st = state_from_soa(soa)
        return (jnp.sum(st.x * jnp.sin(st.x)) + jnp.sum(st.F * st.F)
                + 0.1 * jnp.sum(st.v * st.v)
                + 0.01 * jnp.sum(st.C * st.C)), (st, ok)

    (loss, (st, ok)), grads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(model.logE, model.y, state.x)
    return (float(loss), [np.asarray(g) for g in grads],
            {k: np.asarray(getattr(st, k)) for k in FIELDS}, bool(ok))


def _jax_frame():
    """gsmpm_tpu's tiled frame (impl="ref") on frame_inputs()."""
    import jax.numpy as jnp

    from gsmpm_tpu.config import BoundaryConditionConfig, MPMConfig
    from gsmpm_tpu.sim import tiles as jt
    from gsmpm_tpu.sim.boundary import build_boundary_conditions
    from gsmpm_tpu.sim.kernels import soa_from_state, state_from_soa
    from gsmpm_tpu.sim.state import GridConfig, init_model, init_state

    xyz, cov6, vol, v0 = (jnp.asarray(a) for a in frame_inputs())
    cfg = MPMConfig(**KW)
    state = init_state(xyz, cov6, vol, cfg, v0)
    bcs, state, model = build_boundary_conditions(
        [BoundaryConditionConfig.from_dict(b) for b in BCS], cfg, state,
        init_model(cfg, N))
    grid = GridConfig(cfg.n_grid, cfg.grid_extent)
    tc = jt.default_tile_config(grid.n_grid, N)
    ts = jt.bootstrap(soa_from_state(state), model, grid, tc)
    ts, soa, t = jt.frame_tiled(ts, soa_from_state(state), model, bcs,
                                jnp.float32(0.0), STEPS, grid, tc, DT,
                                impl="ref")
    assert bool(ts.ok)
    st = state_from_soa(soa)
    return {k: np.asarray(getattr(st, k)) for k in FIELDS}, float(t)


def _single_frame():
    """The single-device port's frame_tiled on frame_inputs()."""
    from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa

    state, model, bcs, grid = t_frame_problem()
    tc = tt.default_tile_config(grid.n_grid, N)
    ts = tt.bootstrap(soa_from_state(state), model, grid, tc)
    ts, soa, t = tt.frame_tiled(ts, soa_from_state(state), model, bcs, 0.0,
                                STEPS, grid, tc, DT)
    assert bool(ts.ok)
    st = state_from_soa(soa)
    return {k: getattr(st, k).numpy() for k in FIELDS}, t


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2 ranks' results (started first), gsmpm_tpu's fit and frame and
    the single-device port's frame, computed in the parent meanwhile."""
    from test_torch_fit_graph import _scene

    (j_state, j_model, j_grid), (t_state, _, _, _) = _scene()
    fit_arrays = {f.name: getattr(t_state, f.name).numpy()
                  for f in dataclasses.fields(t_state)}
    out = str(tmp_path_factory.mktemp("mesh_graph") / "ranks.pkl")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, WORLD, port, out, fit_arrays))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        jax_fit = _jax_fit((j_state, j_model, j_grid))
        jax_frame = _jax_frame()
        single = _single_frame()
    finally:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    assert not hung, f"{len(hung)} of {WORLD} ranks still running after " \
                     f"{JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    with open(out, "rb") as f:
        ranks = pickle.load(f)
    return dict(ranks=ranks, jax_fit=jax_fit, jax_frame=jax_frame,
                single=single)


def _state_of(q):
    """FIELDS of (QROWS, N) packed rows in original order."""
    from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa

    template = soa_from_state(t_frame_problem()[0])
    st = state_from_soa(tt.unpack_q(torch.from_numpy(q), template))
    return {k: getattr(st, k).numpy() for k in FIELDS}


def _close(got, want, what):
    for f in FIELDS:
        scale = max(1.0, float(np.abs(want[f]).max()))
        err = float(np.abs(got[f] - want[f]).max()) / scale
        assert err <= RTOL[f], f"{what}: {f} off by {err:.3g} of max"


def test_sharded_frame_matches_eager_loop_bit_for_bit(runs):
    """(a) Each rank's frame (segments of the cached substep graph, no host
    read inside a segment) against the eager substep_tiled(group=) loop on
    the same ranks: the replicated rows, every field of the rank's slice,
    the clock and ok, bit for bit; the device clock holds the host clock's
    bits."""
    for r, res in enumerate(runs["ranks"]):
        got = res["frame"]
        assert got["equal_q"], r
        assert all(got["equal_ts"].values()), (r, got["equal_ts"])
        t_g, t_e = got["t"]
        assert t_g == t_e and got["ok"] == (True, True)
        host_reads, rebuckets, captures, replays = got["counters"]
        # the CPU runs the bodies: nothing captured or replayed, and the
        # rebucket is the frame's own (gathered), not the graph's
        assert host_reads == rebuckets == captures == replays == 0
        assert got["entry_group"]
        assert got["clock"].view(np.uint32) == np.float32(t_g).view(
            np.uint32)


def test_sharded_frame_matches_single_and_jax(runs):
    """(a) The sharded frame's rows against the single-device frame_tiled
    and gsmpm_tpu's tiled frame from the same state (RTOL)."""
    got = _state_of(runs["ranks"][0]["frame"]["q"])
    single, t_single = runs["single"]
    jax_state, t_jax = runs["jax_frame"]
    assert runs["ranks"][0]["frame"]["t"][0] == t_single
    assert np.float32(t_single) == np.float32(t_jax)
    _close(got, single, "sharded frame vs the port's frame_tiled")
    _close(got, jax_state, "sharded frame vs gsmpm_tpu's frame_tiled")


def test_fitting_window_with_group_matches_checkpointed(runs):
    """(b) The window with the group: forward bit for bit against the
    checkpointed substep_tiled_fitting(group=) loop (one host read a
    substep, a rebucket inside the window), d logE / d y / d x0 within
    GRAD_REL of the checkpointed path's."""
    rebuckets = 0
    for r, res in enumerate(runs["ranks"]):
        got = res["fit"]
        assert got["ok"], r
        assert all(got["equal_ts"].values()), (r, got["equal_ts"])
        assert got["equal_loss"], r
        host_reads, rb = got["counts"]
        assert host_reads == FIT_SUB, r
        rebuckets += rb
        for name, rel in got["grad_rel"].items():
            assert rel is not None and rel <= GRAD_REL, (r, name, rel)
    assert rebuckets >= 1


def test_fitting_window_with_group_matches_jax(runs):
    """(b) The ranks' window, their losses summed and their gradients
    gathered, against gsmpm_tpu's single-device value_and_grad of the
    whole blob (test_torch_fit_graph.py's tolerances)."""
    from test_torch_transfer_vjp import _close as rel_close

    got = runs["ranks"][0]["fit"]
    loss_j, grads_j, state_j, ok_j = runs["jax_fit"]
    assert ok_j
    for name in ("x", "v", "C", "F"):
        rel_close(got["state"][name], state_j[name], JAX_FIELD_REL, name)
    assert got["loss"] == pytest.approx(loss_j, rel=1e-5)
    for name, a, b in zip(("d_logE", "d_y", "d_x0"), got["grads"], grads_j):
        rel_close(a, b, JAX_GRAD_REL, name)


def test_graph_caches_name_the_group(runs):
    """(c) A new group is a new entry in both caches; dropping a group's
    graphs removes its two entries and keeps the rest, a later call for
    it builds anew; dropping every group's keeps the single-device
    entries."""
    for r, res in enumerate(runs["ranks"]):
        got = res["cache"]
        assert got["same"] and got["other_new"] and got["groups"], (r, got)
        assert got["dropped_other"] == 2 and got["other_gone"], (r, got)
        assert got["rest_kept"] and got["other_anew"], (r, got)
        # the group entries left: the frame's substep graph (a), the fit
        # window's pair (b), and this case's mesh-group pair and rebuilt
        # other-group pair
        assert got["dropped_all"] == 6 and got["single_kept"], (r, got)
