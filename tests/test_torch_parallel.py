"""The port's parallel/ package on 2 and 3 gloo ranks vs the single-device
port and gsmpm_tpu.

Each world size is one group of CPU processes (``multiprocessing`` spawn,
a free localhost port, a join timeout so that a hang fails the test): the
ranks run every case below, rank 0 writes the results to a file, and the
parent runs the single-device port and the JAX package on the same
numpy-seeded inputs.  Particle counts are odd, so the padding is used.

- the psum frame (golden engine per shard, dense grid all-reduced);
- the chunk-sharded tiled frame (K1 / K2 twins per rank, blocked grid
  all-reduced, gathered rebucket);
- the tile-sharded render (render_block_rows, K4's twin);
- ``MeshSimEngine`` with a tile cap too small: the frame is redone on psum;
- ``apps.simulate --mesh data=N`` against the run without a mesh.
"""

import dataclasses
import json
import multiprocessing
import os
import pickle
import socket
import time

import numpy as np
import pytest
import torch

from gsmpm_tpu_torch.config import MPMConfig as TMPMConfig
from gsmpm_tpu_torch.parallel import mesh as tmesh
from gsmpm_tpu_torch.render.camera import make_camera as t_make_camera
from gsmpm_tpu_torch.render.renderer import RasterConfig as TRasterConfig
from gsmpm_tpu_torch.sim import boundary as tb
from gsmpm_tpu_torch.sim.state import GridConfig as TGridConfig

N_SIM = 301
N_RENDER = 299
G = 16
DT = 1e-3
SUBSTEPS = 30
RES = 64
JOIN_TIMEOUT_S = 120
KW = dict(E=2e4, nu=0.3, material="jelly", n_grid=G, grid_extent=2.0,
          substep_dt=DT, frame_dt=SUBSTEPS * DT, density=200.0)
STATE_FIELDS = ("x", "v", "F", "F_trial", "C", "cov")


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

def sim_inputs(n=N_SIM, seed=4):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0.6, 1.4, size=(n, 3)).astype(np.float32)
    cov6 = np.tile(np.asarray([1e-4, 0, 0, 1e-4, 0, 1e-4], np.float32), (n, 1))
    # a body thrown at 14 m/s: its particles cross into the next tiles and
    # the single-device tiled engine rebuckets on drift mid-frame (at
    # substep 20 of 30)
    v = (np.asarray([11.0, 8.0, 3.0]) + rng.normal(size=(n, 3)))
    return xyz, cov6, v.astype(np.float32)


def render_inputs(n=N_RENDER, seed=1):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    means[:, 2] += 4.0
    A = 0.05 * rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    cov6 = np.ascontiguousarray(cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]])
    opacity = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)
    shs = (0.3 * rng.normal(size=(n, 4, 3))).astype(np.float32)
    return means, cov6, opacity, shs


def cam_args():
    return (RES, RES, 0.9, 0.9, np.eye(3), np.zeros(3))


def t_problem():
    """The port's (state, model, bcs, grid) on sim_inputs()."""
    from gsmpm_tpu_torch.sim.state import init_model, init_state
    from gsmpm_tpu_torch.sim.volume import particle_volume

    xyz, cov6, v = (torch.from_numpy(a) for a in sim_inputs())
    cfg = TMPMConfig(**KW)
    state = init_state(xyz, cov6, particle_volume(xyz, G, 2.0), cfg, v)
    bcs = tb.BCSet(grid_ops=(tb.make_surface_collider((0, 0, 0.4),
                                                      (0, 0, 1)),))
    return state, init_model(cfg, xyz.shape[0], "cpu"), bcs, TGridConfig(G, 2.0)


def t_rcfg():
    return TRasterConfig(block=16, chunk=32)


def _np_state(st):
    return {f: getattr(st, f).numpy() for f in STATE_FIELDS}


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _case_psum(mesh):
    from gsmpm_tpu_torch.parallel.sharded import make_sharded_frame_fn

    state, model, bcs, grid = t_problem()
    n = state.x.shape[0]
    st, md, _, _ = tmesh.pad_particles(state, model, mesh.world_size)
    st, md = tmesh.shard((st, md), mesh)
    fn = make_sharded_frame_fn(mesh, bcs=bcs, grid=grid, dt=DT,
                               n_substeps=SUBSTEPS)
    st, t, _ = fn(st, md, 0.0)
    return dict(state=_np_state(tmesh.unpad(tmesh.gather(st, mesh), n)), t=t)


def _tiled_setup(mesh):
    from gsmpm_tpu_torch.parallel.tiled_sharded import sharded_tile_config

    state, model, bcs, grid = t_problem()
    n = state.x.shape[0]
    st, md, _, _ = tmesh.pad_particles(state, model, mesh.world_size)
    tc = sharded_tile_config(G, st.x.shape[0], mesh.world_size)
    return n, st, md, bcs, grid, tc


def _case_tiled(mesh):
    from gsmpm_tpu_torch.parallel.tiled_sharded import (
        make_sharded_frame_tiled, shard_tiled,
    )
    from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa
    from gsmpm_tpu_torch.sim.solver import postprocess
    from gsmpm_tpu_torch.sim.tiles import bootstrap, unpack_q

    from gsmpm_tpu_torch.parallel import tiled_sharded

    n, st, md, bcs, grid, tc = _tiled_setup(mesh)
    ts = bootstrap(soa_from_state(st), md, grid, tc)
    fn = make_sharded_frame_tiled(mesh, model=md, bcs=bcs, grid=grid, tc=tc,
                                  dt=DT, n_substeps=SUBSTEPS,
                                  rebucket_every=10)
    rebuckets = []
    plain = tiled_sharded.rebucket
    tiled_sharded.rebucket = lambda *a: rebuckets.append(1) or plain(*a)
    try:
        ts, q, t = fn(shard_tiled(ts, mesh, tc), 0.0)
    finally:
        tiled_sharded.rebucket = plain
    out = state_from_soa(unpack_q(q, soa_from_state(st)))
    out = dataclasses.replace(out, cov=postprocess(out)[0])
    return dict(state=_np_state(tmesh.unpad(out, n)), t=t, ok=bool(ts.ok),
                rebuckets=len(rebuckets),
                nchunk_local=int(ts.chunk_tile.shape[0]), nchunk=tc.nchunk)


def _case_render(mesh):
    from gsmpm_tpu_torch.parallel.sharded import make_sharded_render_fn

    arrs = tuple(torch.from_numpy(a) for a in render_inputs())
    n = arrs[0].shape[0]
    k = (-n) % mesh.world_size
    # padded gaussians: opacity 0 at the camera centre (culled by z_near)
    padded = [torch.cat([a, torch.zeros((k,) + a.shape[1:])]) for a in arrs]
    fn = make_sharded_render_fn(mesh, camera=t_make_camera(*cam_args()),
                                bg=torch.zeros(3), sh_degree=1, rcfg=t_rcfg())
    img = fn(*tmesh.shard(tuple(padded), mesh))
    return dict(image=img.numpy())


def _case_overflow(mesh):
    from gsmpm_tpu_torch.parallel.engines import MeshSimEngine

    from gsmpm_tpu_torch.parallel import tiled_sharded

    n, st, md, bcs, grid, _ = _tiled_setup(mesh)
    # an occupied-tile cap below the 8 tiles the particles occupy (plus
    # the chunks that make nchunk a multiple of the ranks): bootstrap
    # overflows and the frame is redone on psum
    real, caps = tiled_sharded.sharded_tile_config, []

    def small_cap(n_grid, n_particles, ndev):
        tc = real(n_grid, n_particles, ndev)._replace(n_occ_cap=1)
        tc = tc._replace(n_occ_cap=1 + (-tc.nchunk) % ndev)
        caps.append(tc.occ_cap)
        return tc

    tiled_sharded.sharded_tile_config = small_cap
    try:
        eng = MeshSimEngine(mesh, bcs=bcs, grid=grid, substep_dt=DT,
                            n_steps=SUBSTEPS, prefer="tiled")
        st_l, md_l = tmesh.shard((st, md), mesh)
        out, t, _ = eng.frame(st_l, md_l, 0.0)
    finally:
        tiled_sharded.sharded_tile_config = real
    return dict(engine=eng.engine, caps=caps,
                state=_np_state(tmesh.unpad(tmesh.gather(out, mesh), n)))


def _case_app(mesh, out_dir):
    from gsmpm_tpu_torch.apps import simulate as tsim
    from gsmpm_tpu_torch.config import SimConfig

    res = {}
    for engine in ("psum", "tiled"):
        path = os.path.join(out_dir, f"cfg_{engine}.json")
        stats = {}
        frames = tsim.simulate(SimConfig.from_json(path), synthetic=512,
                               frames=2, quiet=True, synthetic_res=64,
                               device="cpu", stats=stats,
                               mesh=f"data={mesh.world_size},engine={engine}")
        res[engine] = dict(frames=frames, engine=stats["engine"],
                           n_dropped=stats["n_dropped"])
    return res


CASES = dict(psum=_case_psum, tiled=_case_tiled, render=_case_render,
             overflow=_case_overflow)


def _worker(rank, world, port, out_path, app_dir):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", rank=rank, world_size=world)
    try:
        mesh = tmesh.make_mesh((("data", world),), "cpu")
        res = {name: fn(mesh) for name, fn in CASES.items()}
        res["app"] = _case_app(mesh, app_dir)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, tmp_path, app_dir: str) -> dict:
    """Run every case on ``world`` gloo ranks; rank 0's results."""
    out = str(tmp_path / f"ranks{world}.pkl")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, out, app_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} of {world} ranks still running after " \
                     f"{JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * world
    with open(out, "rb") as f:
        return pickle.load(f)


def _app_configs(root):
    """tests/test_torch_simulate.py's CONFIG, one output directory per run."""
    base = {"mpm": {"n_grid": 16, "E": 2e5, "nu": 0.3, "material": "jelly",
                    "density": 200.0, "substep_dt": 1e-3, "frame_dt": 1e-2,
                    "gravity": [0.0, 0.0, -9.8]}}
    for name in ("psum", "tiled", "single"):
        cfg = dict(base, render={"output_path": str(root / name)})
        (root / f"cfg_{name}.json").write_text(json.dumps(cfg))
    return str(root)


@pytest.fixture(scope="module", params=[2, 3], ids=["ranks2", "ranks3"])
def ranks(request, tmp_path_factory):
    world = request.param
    root = tmp_path_factory.mktemp(f"mesh{world}")
    return world, root, run_ranks(world, root, _app_configs(root))


# ---------------------------------------------------------------------------
# the single-device sides
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single():
    """The single-device port: golden frame, tiled frame and render."""
    from gsmpm_tpu_torch.parallel.sharded import _render_tile_sharded
    from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa
    from gsmpm_tpu_torch.sim.solver import postprocess, run_substeps
    from gsmpm_tpu_torch.sim.tiles import (
        bootstrap, default_tile_config, frame_tiled,
    )

    state, model, bcs, grid = t_problem()
    st, t = run_substeps(state, model, bcs, 0.0, SUBSTEPS, grid, DT,
                         checkpoint_policy=None)
    cov6, _ = postprocess(st)
    golden = _np_state(dataclasses.replace(st, cov=cov6))
    tc = default_tile_config(G, state.x.shape[0])
    ts = bootstrap(soa_from_state(state), model, grid, tc)
    ts, soa, _ = frame_tiled(ts, soa_from_state(state), model, bcs, 0.0,
                             SUBSTEPS, grid, tc, DT)
    assert bool(ts.ok)
    st = state_from_soa(soa)
    tiled = _np_state(dataclasses.replace(st, cov=postprocess(st)[0]))
    img, nd = _render_tile_sharded(
        *(torch.from_numpy(a) for a in render_inputs()),
        t_make_camera(*cam_args()), torch.zeros(3), 1, t_rcfg())
    assert int(nd) == 0
    return dict(golden=golden, tiled=tiled, t=t, image=img.numpy())


@pytest.fixture(scope="module")
def jax_golden():
    """gsmpm_tpu's golden frame on the same inputs (its sharded frame is
    held to it by tests/test_parallel.py)."""
    import jax.numpy as jnp

    from gsmpm_tpu.config import MPMConfig
    from gsmpm_tpu.sim.boundary import BCSet, make_surface_collider
    from gsmpm_tpu.sim.solver import postprocess, run_substeps
    from gsmpm_tpu.sim.state import GridConfig, init_model, init_state
    from gsmpm_tpu.sim.volume import particle_volume

    xyz, cov6, v = (jnp.asarray(a) for a in sim_inputs())
    cfg = MPMConfig(**KW)
    state = init_state(xyz, cov6, particle_volume(xyz, G, 2.0), cfg, v)
    bcs = BCSet(grid_ops=(make_surface_collider((0, 0, 0.4), (0, 0, 1)),))
    st, _ = run_substeps(state, init_model(cfg, xyz.shape[0]), bcs,
                         jnp.float32(0.0), SUBSTEPS, GridConfig(G, 2.0), DT,
                         checkpoint_policy=None)
    cov, _ = postprocess(st)
    st = dataclasses.replace(st, cov=cov)
    return {f: np.asarray(getattr(st, f)) for f in STATE_FIELDS}


# float32 sums in another order over 30 substeps of a body moving at 14
# m/s: 1e-5 of each field's max (at least 1); C, the velocity field's
# moments scaled by 4 / dx^2, 1e-4
RTOL = dict(x=1e-5, v=1e-5, F=1e-5, F_trial=1e-5, C=1e-4, cov=1e-5)


def _close(got, want, what):
    for f in STATE_FIELDS:
        scale = max(1.0, float(np.abs(want[f]).max()))
        err = float(np.abs(got[f] - want[f]).max()) / scale
        assert err <= RTOL[f], f"{what}: {f} off by {err:.3g} of max"


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_pad_particles_matches_jax():
    import jax.numpy as jnp

    from gsmpm_tpu.config import MPMConfig
    from gsmpm_tpu.parallel.mesh import pad_particles
    from gsmpm_tpu.sim.state import init_model, init_state
    from gsmpm_tpu.sim.volume import particle_volume

    xyz, cov6, v = sim_inputs()
    cfg = MPMConfig(**KW)
    js = init_state(jnp.asarray(xyz), jnp.asarray(cov6),
                    particle_volume(jnp.asarray(xyz), G, 2.0), cfg,
                    jnp.asarray(v))
    opac = np.linspace(0.1, 0.9, N_SIM, dtype=np.float32)
    js, jm, jx, n = pad_particles(js, init_model(cfg, N_SIM), 4,
                                  {"opacity": jnp.asarray(opac)})
    state, model, _, _ = t_problem()
    ts, tm, tx, tn = tmesh.pad_particles(state, model, 4,
                                         {"opacity": torch.from_numpy(opac)})
    assert n == tn == N_SIM and ts.x.shape[0] == 304
    for f in dataclasses.fields(ts):
        np.testing.assert_allclose(getattr(ts, f.name).numpy(),
                                   np.asarray(getattr(js, f.name)), rtol=1e-6,
                                   err_msg=f.name)
    for name in ("material", "logE", "y", "mu", "lam", "viscosity"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(tx["opacity"].numpy(),
                                  np.asarray(jx["opacity"]))
    back = tmesh.unpad((ts, tx), N_SIM)
    np.testing.assert_array_equal(back[0].x.numpy(), state.x.numpy())
    assert back[1]["opacity"].shape == (N_SIM,)


def test_make_mesh_without_a_group_is_an_error(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.make_mesh((("data", -1),), "cpu")


def test_psum_frame_matches_single_and_jax(ranks, single, jax_golden):
    world, _, res = ranks
    got = res["psum"]
    assert got["t"] == single["t"]
    # the same golden engine; the all-reduce adds the shards' grids in
    # another order than one index_add_ over all particles
    _close(got["state"], single["golden"], f"psum x{world} vs port")
    _close(got["state"], jax_golden, f"psum x{world} vs gsmpm_tpu")


def test_tiled_sharded_frame_matches_single(ranks, single, jax_golden):
    world, _, res = ranks
    got = res["tiled"]
    # one gathered rebucket at the start of each 10-substep segment, as in
    # gsmpm_tpu's engine
    assert got["ok"] and got["t"] == single["t"]
    assert got["rebuckets"] == SUBSTEPS // 10
    assert got["nchunk_local"] * world == got["nchunk"]
    # K1 / K2 twins per rank, rebucketed per segment instead of on drift:
    # the grid sums in another order
    _close(got["state"], single["tiled"], f"tiled x{world} vs port")
    _close(got["state"], jax_golden, f"tiled x{world} vs gsmpm_tpu")


def test_tile_sharded_render_matches_single(ranks, single):
    world, _, res = ranks
    # the same rows through the same K4 twin, rank by rank
    np.testing.assert_allclose(res["render"]["image"], single["image"],
                               atol=1e-6)
    assert float(np.abs(single["image"]).max()) > 0.1


def test_render_block_rows_matches_jax(single):
    import jax.numpy as jnp

    from gsmpm_tpu.render import renderer as jr
    from gsmpm_tpu.render.camera import make_camera

    means, cov6, opacity, shs = (jnp.asarray(a) for a in render_inputs())
    img, nd = jr.render_with_aux(means, cov6, opacity, shs,
                                 make_camera(*cam_args()), jnp.zeros(3), 1,
                                 jr.RasterConfig(block=16, chunk=32))
    assert int(nd) == 0
    # XLA blend (opacity * exp(power)) vs K4's twin (exp(power + log
    # opacity), F rows in block-local monomials)
    np.testing.assert_allclose(single["image"], np.asarray(img), atol=2e-4)


def test_forced_cap_overflow_redoes_the_frame_on_psum(ranks):
    world, _, res = ranks
    got = res["overflow"]
    assert got["engine"] == "psum"
    assert len(got["caps"]) == 1 and got["caps"][0] < 8
    # redone from the same start state: the psum engine's frame exactly
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(got["state"][f],
                                      res["psum"]["state"][f], err_msg=f)


def test_app_mesh_writes_the_single_run_frames(ranks):
    """apps.simulate --mesh data=N,engine=psum|tiled on N ranks."""
    world, root, res = ranks
    from gsmpm_tpu_torch.apps import simulate as tsim
    from gsmpm_tpu_torch.config import SimConfig

    stats = {}
    want = tsim.simulate(SimConfig.from_json(str(root / "cfg_single.json")),
                         synthetic=512, frames=2, quiet=True,
                         synthetic_res=64, device="cpu", stats=stats,
                         mesh="none")
    assert stats["engine"] == ["tiled", "tiled"]
    for engine, got in res["app"].items():
        assert got["engine"] == [engine, engine]
        assert got["n_dropped"] == [0, 0, 0]
        assert len(got["frames"]) == len(want) == 3
        for a, b in zip(got["frames"], want):
            # the stream render (K3) vs the tile-sharded render (K4), the
            # engines' sums in other orders over 20 substeps
            np.testing.assert_allclose(a, b, atol=2e-4, err_msg=engine)
        pngs = sorted((root / engine / "images").glob("*.png"))
        assert [p.name for p in pngs] == ["0000.png", "0001.png", "0002.png"]
