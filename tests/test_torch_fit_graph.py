"""The fitting window's graphs (sim/tiles.py: ``_FittingWindow``) on the CPU.

On CUDA, with autograd recording and no process group,
``run_substeps_tiled_fitting`` runs its window through ``_FittingWindow``:
a forward graph of one fitting substep replayed N times, and in the
backward pass an adjoint graph (the substep recomputed from its kept input
rows, then its VJP) replayed for k = N-1 ... 0.  Here the same Function
runs its bodies eagerly on the kernels' plain twins and is held against
the checkpointed ``run_substeps_tiled_fitting`` (the CPU's path), against
gsmpm_tpu's ``jax.value_and_grad`` of its ``run_substeps_tiled_fitting``
and against ``_advance``'s host clock.  The scene is
tests/test_torch_transfer_vjp.py's falling blob thrown sideways, so that
a rebucket happens inside the window.  tests/test_torch_cuda.py holds the
replayed graphs against the checkpointed window on the GPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_transfer_vjp import DT, KW, _close, _fit_state, _pallas_adjoint

from gsmpm_tpu.sim import tiles as jt
from gsmpm_tpu.sim.boundary import BCSet, StickyGroundBC
from gsmpm_tpu.sim.kernels import soa_from_state, state_from_soa
from gsmpm_tpu.sim.state import mu_lam_from_logE_y

from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.models.convert import state_from_numpy
from gsmpm_tpu_torch.sim import boundary as tb
from gsmpm_tpu_torch.sim import tiles as tt
from gsmpm_tpu_torch.sim.kernels import soa_from_state as t_soa_from_state
from gsmpm_tpu_torch.sim.kernels import state_from_soa as t_state_from_soa
from gsmpm_tpu_torch.sim.state import GridConfig as TGridConfig
from gsmpm_tpu_torch.sim.state import init_model as t_init_model
from gsmpm_tpu_torch.sim.state import mu_lam_from_logE_y as t_mu_lam

N_SUB = 7
# the blob thrown along +x (world units a second) with a seeded spread:
# its particles leave their tiles' safe windows within 5 substeps
THROW = (30.0, -2.0, 0.0)
FIELDS = ("x", "v", "C", "F", "F_trial")
# the window's gradients against the checkpointed path's: the same
# float32 operations, summed in another order (daux over the substeps,
# autograd's input buffers); 1e-6 of each gradient's largest magnitude
GRAD_REL = 1e-6
# against gsmpm_tpu: test_fitting_substeps_and_grads_match_jax's
JAX_FIELD_REL, JAX_GRAD_REL = 1e-4, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on the machine's cores; torch's
    own thread pool per worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    """(JAX state, model, grid), (port state, model, grid, tile config):
    the same thrown blob for both packages.  The port's tile cap is 8
    tiles (the blob occupies 3), which keeps the twins' chunk loops short;
    the original-order rows do not depend on it."""
    state, model, grid = _fit_state()
    n = state.x.shape[0]
    rng = np.random.default_rng(13)
    v = (np.float32(THROW) + 0.5 * rng.normal(size=(n, 3))).astype(
        np.float32)
    state = dataclasses.replace(state, v=jnp.asarray(v))
    t_state = state_from_numpy({f.name: np.asarray(getattr(state, f.name))
                                for f in dataclasses.fields(state)})
    t_model = t_init_model(TMPMConfig(**KW), n, "cpu")
    t_grid = TGridConfig(*grid)
    tc = tt.TileConfig(t_grid.n_grid, n, S=256, n_occ_cap=8)
    return (state, model, grid), (t_state, t_model, t_grid, tc)


def _bcs():
    return tb.BCSet(grid_ops=(tb.sticky_ground("cpu"),))


def _loss(st):
    return (torch.sum(st.x * torch.sin(st.x)) + torch.sum(st.F * st.F)
            + 0.1 * torch.sum(st.v * st.v) + 0.01 * torch.sum(st.C * st.C))


def _port_run(window: bool):
    """(state', loss, (d logE, d y, d x0), host time, ok, counter deltas)
    through the window Function (window) or the checkpointed
    run_substeps_tiled_fitting."""
    _, (t_state, t_model, grid, tc) = _scene()
    n = t_state.x.shape[0]
    logE = t_model.logE.clone().requires_grad_(True)
    y = t_model.y.clone().requires_grad_(True)
    x0 = t_state.x.clone().requires_grad_(True)
    mu, lam = t_mu_lam(logE, y)
    model = dataclasses.replace(t_model, logE=logE, y=y, mu=mu, lam=lam)
    soa = t_soa_from_state(dataclasses.replace(t_state, x=x0))
    f = tt.run_substeps_tiled_fitting
    before = (f.host_reads, f.rebuckets)
    if window:
        ts = tt.bootstrap(soa, model, grid, tc)
        ts = tt._fitting_window(ts, model, _bcs(), 0.0, N_SUB, grid, tc, DT)
        out = tt.unpack_q(tt.to_original_order(ts, n), soa)
        t, ok = 0.0, ts.ok
        for _ in range(N_SUB):
            t = tt._advance(t, DT)
    else:
        out, t, ok = tt.run_substeps_tiled_fitting(soa, model, _bcs(), 0.0,
                                                   N_SUB, grid, DT, tc)
    counts = (f.host_reads - before[0], f.rebuckets - before[1])
    st = t_state_from_soa(out)
    loss = _loss(st)
    grads = torch.autograd.grad(loss, (logE, y, x0))
    return st, loss.detach(), grads, t, bool(ok), counts


@pytest.fixture(scope="module")
def runs():
    return dict(window=_port_run(True), checkpointed=_port_run(False))


@pytest.fixture(scope="module")
def jax_run():
    """gsmpm_tpu's value_and_grad of its run_substeps_tiled_fitting
    (chunk_impl="vjp", the Pallas adjoint in interpret mode), as
    tests/test_torch_transfer_vjp.py runs it."""
    (state, model, grid), _ = _scene()
    bcs = BCSet(grid_ops=(StickyGroundBC(),))

    def jloss(logE, y, x0):
        mu, lam = mu_lam_from_logE_y(logE, y)
        m = dataclasses.replace(model, logE=logE, y=y, mu=mu, lam=lam)
        soa, _, ok = jt.run_substeps_tiled_fitting(
            soa_from_state(dataclasses.replace(state, x=x0)), m, bcs,
            jnp.float32(0.0), N_SUB, grid, DT, chunk_impl="vjp")
        st = state_from_soa(soa)
        return (jnp.sum(st.x * jnp.sin(st.x)) + jnp.sum(st.F * st.F)
                + 0.1 * jnp.sum(st.v * st.v)
                + 0.01 * jnp.sum(st.C * st.C)), (st, ok)

    with _pallas_adjoint():
        (loss, (st, ok)), grads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(model.logE, model.y,
                                                    state.x)
    return st, float(loss), grads, bool(ok)


def test_window_forward_matches_checkpointed_bit_for_bit(runs):
    """(a) The window's forward (host part, then the forward body on the
    static buffers) gives the checkpointed path's state bit for bit, with
    one host read a substep and a rebucket inside the window."""
    st_w, loss_w, _, t_w, ok_w, (reads_w, rebuckets_w) = runs["window"]
    st_c, loss_c, _, t_c, ok_c, _ = runs["checkpointed"]
    assert reads_w == N_SUB and rebuckets_w >= 1
    assert ok_w and ok_c and t_w == t_c
    for name in FIELDS:
        got, want = getattr(st_w, name), getattr(st_c, name)
        assert torch.equal(got.detach(), want.detach()), name
    assert torch.equal(loss_w, loss_c)


def test_window_grads_match_checkpointed(runs):
    """(b) d logE, d y and d x0 through the window's backward (the adjoint
    body per substep, the rebucket's VJP between) against autograd through
    the checkpointed substeps: GRAD_REL of each gradient's largest
    magnitude (summation order only)."""
    g_w, g_c = runs["window"][2], runs["checkpointed"][2]
    for name, a, b in zip(("logE", "y", "x0"), g_w, g_c):
        scale = float(b.abs().max())
        assert scale > 0, name
        assert float((a - b).abs().max()) <= GRAD_REL * scale, name


def test_window_matches_jax_value_and_grad(runs, jax_run):
    """(c) The window's state, loss and gradients against gsmpm_tpu's
    value_and_grad of its fitting window (rebucket inside the window),
    with test_fitting_substeps_and_grads_match_jax's tolerances."""
    st_w, loss_w, g_w, _, _, _ = runs["window"]
    st_j, loss_j, g_j, ok_j = jax_run
    assert ok_j
    for name in ("x", "v", "C", "F"):
        _close(getattr(st_w, name).detach().numpy(), getattr(st_j, name),
               JAX_FIELD_REL, name)
    assert float(loss_w) == pytest.approx(loss_j, rel=1e-5)
    for name, a, b in zip(("d_logE", "d_y", "d_x0"), g_w, g_j):
        _close(a.numpy(), b, JAX_GRAD_REL, name)


def test_rebucket_vjp_matches_index_select_autograd():
    """(d) ``_unpermute`` on a real rebucket's permutation equals autograd's
    cotangent through ``rebucket``'s gathers of q and aux, bit for bit."""
    _, (t_state, t_model, grid, tc) = _scene()
    ts = tt.bootstrap(t_soa_from_state(t_state), t_model, grid, tc)
    # move every real particle one tile along +x: a rebucket with a
    # permutation that is not the identity
    live = ts.q[tt.RMASS] > 0
    q = ts.q.clone()
    q[tt.RX] = torch.where(live, q[tt.RX] + tt.T_TILE * grid.dx, q[tt.RX])
    q.requires_grad_(True)
    aux = ts.aux.clone().requires_grad_(True)
    new, src_c, has_src = tt._rebucket(
        dataclasses.replace(ts, q=q, aux=aux), grid, tc)
    assert not torch.equal(src_c, torch.arange(tc.np_rows))
    rng = np.random.default_rng(4)
    dq = torch.from_numpy(rng.normal(size=tuple(q.shape)).astype(np.float32))
    daux = torch.from_numpy(rng.normal(size=tuple(aux.shape))
                            .astype(np.float32))
    want_q, want_aux = torch.autograd.grad((new.q, new.aux), (q, aux),
                                           (dq, daux))
    assert torch.equal(tt._unpermute(dq, src_c, has_src), want_q)
    assert torch.equal(tt._unpermute(daux, src_c, has_src), want_aux)


def test_device_clock_equals_advance():
    """(e) The forward body's float32 clock holds the bits of _advance's
    host clock after every substep, rebucket included."""
    _, (t_state, t_model, grid, tc) = _scene()
    ts = tt.bootstrap(t_soa_from_state(t_state), t_model, grid, tc)
    graphs = tt._FittingGraphs(ts, t_model, _bcs(), grid, tc, DT)
    t0 = 0.0123
    graphs.load(ts, t0)
    t, rebuckets = t0, 0
    with torch.no_grad():
        for _ in range(N_SUB):
            rebuckets += graphs.prepare()[1] is not None
            graphs.step()
            t = tt._advance(t, DT)
            clock = graphs.clock
            assert clock.dtype == torch.float32 and clock.shape == ()
            assert clock.numpy().view(np.uint32) == np.float32(t).view(
                np.uint32)
    assert rebuckets >= 1


def test_graph_cache_keys_gravity_and_bcs_by_value():
    """A new logE / y and a new BC set of the same values reuse the cached
    graphs (no capture on CUDA); another gravity or BC box does not, and
    the graphs own copies of what they were built with."""
    _, (t_state, t_model, grid, tc) = _scene()
    ts = tt.bootstrap(t_soa_from_state(t_state), t_model, grid, tc)
    first = tt._fitting_graphs(ts, t_model, _bcs(), grid, tc, DT)
    logE = t_model.logE + 0.5
    mu, lam = t_mu_lam(logE, t_model.y)
    model2 = dataclasses.replace(t_model, logE=logE, mu=mu, lam=lam)
    assert tt._fitting_graphs(ts, model2, _bcs(), grid, tc, DT) is first
    gravity = dataclasses.replace(
        t_model, gravity=torch.tensor([0.0, -1.0, 0.0]))
    assert tt._fitting_graphs(ts, gravity, _bcs(), grid, tc, DT) is not first
    wider = tb.BCSet(grid_ops=(tb.StickyGroundBC(
        torch.tensor([1.0, 0.6, 1.0]), torch.tensor([1.0, 0.2, 1.0])),))
    assert tt._fitting_graphs(ts, t_model, wider, grid, tc, DT) is not first
    bcs = _bcs()
    graphs = tt._fitting_graphs(ts, t_model, bcs, grid, tc, DT)
    assert graphs.bcs.grid_ops[0].center is not bcs.grid_ops[0].center
    assert graphs.model.gravity is not t_model.gravity
