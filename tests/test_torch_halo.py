"""The port's halo engines (parallel/halo.py, halo_tiled.py,
halo_tiled2d.py) on 2 and 4 gloo ranks vs the single-device port and
gsmpm_tpu.

Each world size is one group of CPU processes (``multiprocessing`` spawn,
a free localhost port, a join timeout so that a hang fails the test): the
ranks run every case of their world size and rank 0 writes every rank's
results to a file.  Meanwhile the parent runs the JAX package's engines
on a JAX mesh of the same number of its 8 host devices, and the
single-device port, on the same numpy-seeded inputs.

- the quantile starts, ``partition_slots`` and the bootstraps: equal to
  gsmpm_tpu's (one process);
- the strip exchanges (``_exchange_accum``, ``_exchange_edges``,
  ``_exchange_accum_tiles``, ``_fetch_edges_stacked``) on seeded arrays,
  along x on 2 and 4 ranks and along y on 2 x 2: bit-equal to gsmpm_tpu's
  under ``shard_map``;
- two ``MeshSimEngine`` frames of halo (2 ranks), halo_tiled (2 and 4) and
  halo_tiled2d (2 x 2) against 20 golden substeps of the single-device
  port and against gsmpm_tpu's engine (tests/test_halo.py's tolerance);
- halo_tiled on a scene whose one rank drifts past its tile windows'
  margin within a segment: that rank rebuckets as gsmpm_tpu does, against
  the single device and gsmpm_tpu;
- neighbour migration forced by a bulk drift, and the gathered fallback:
  mass and momentum conserved, every particle kept;
- the selection order, and its fall-through on a scene too narrow;
- a tile cap that only rank 1 overflows: the port redoes the frame on
  psum on every rank, where gsmpm_tpu's frame reports ok;
- ``apps.simulate --mesh data=2`` at n_grid 64 picks ``halo`` and writes
  the frames of the run without a mesh;
- ``dryrun_multichip(4)``.
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

JOIN_TIMEOUT_S = 240
SUBSTEPS = 10  # a frame; every engine case runs 2 frames
DT = 2e-4
FIELDS = ("x", "v", "F_trial")
# tests/test_halo.py:96-107, (rtol, atol) per field
TOL = dict(x=(2e-4, 2e-5), v=(5e-3, 5e-4), F_trial=(5e-4, 5e-5))
# scene name -> (particles, n_grid, spread along y too, seed)
SCENES = dict(halo=(1024, 64, False, 0), tiled32=(1024, 32, False, 1),
              tiled64=(1024, 64, False, 2), tiled2d=(1024, 32, True, 3),
              drift=(1024, 32, False, 4))
TILE_CAP = 40  # occupied tiles a rank, for CPU speed (the scenes use <= 33)
FAULT_CAP = 10  # rank 0's box fits in it, rank 1's spread does not
APP_TILE_CAP = 80  # the app scene occupies 65 tiles at n_grid 64
ENGINE_CASES = {2: (("halo", "halo"), ("halo_tiled", "tiled32")),
                4: (("halo_tiled", "tiled64"), ("halo_tiled2d", "tiled2d"))}


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

def scene_arrays(name):
    """(x, cov6, v) of a scene: spread along x (and y), a bulk velocity;
    "drift" is drift_arrays()."""
    n, _, spread_y, seed = SCENES[name]
    rng = np.random.default_rng(seed)
    if name == "drift":
        return drift_arrays(n, rng)
    ext = 2.0
    x = np.stack([
        rng.uniform(0.05 * ext, 0.95 * ext, n),
        rng.uniform(0.05 * ext, 0.95 * ext, n) if spread_y
        else rng.uniform(0.4 * ext, 0.6 * ext, n),
        rng.uniform(0.45 * ext, 0.70 * ext, n),
    ], axis=1).astype(np.float32)
    cov = np.tile(np.array([1e-4, 0, 0, 1e-4, 0, 1e-4], np.float32), (n, 1))
    v = np.tile(np.array([[0.8, -0.6 if spread_y else 0.0, -0.5]],
                         np.float32), (n, 1))
    return x, cov, v


def drift_arrays(n, rng):
    """Two blobs at n_grid 32, one in each x-slab of 2 ranks: the upper one
    moves +z at 110-130 m/s (up to 0.42 cells a substep of 2e-4 s),
    stretching along z, so that its particles leave their tile windows'
    drift margin within a segment and would leave the windows' support
    before its end without a rebucket (a particle's transfer then clamped
    to the window reads the velocity of another z); the lower one rests."""
    h = n // 2
    lo = rng.uniform((0.3, 0.9, 0.9), (0.7, 1.1, 1.1), (h, 3))
    hi = rng.uniform((1.3, 0.9, 0.9), (1.7, 1.1, 1.1), (n - h, 3))
    x = np.concatenate([lo, hi]).astype(np.float32)
    cov = np.tile(np.array([1e-4, 0, 0, 1e-4, 0, 1e-4], np.float32), (n, 1))
    v = np.zeros_like(x)
    v[h:, 2] = 120.0 + 100.0 * (x[h:, 2] - 1.0)
    return x, cov, v


def migrate_arrays():
    """tests/test_halo.py:146's scene: a +x drift of 10 m/s over 15
    substeps of 5e-4 s (2.4 cells) moves particles across the slab
    boundary; no gravity and no BCs, so mass and momentum are invariants."""
    n = 2048
    rng = np.random.default_rng(1)
    x = np.stack([rng.uniform(0.2, 1.6, n), rng.uniform(0.8, 1.2, n),
                  rng.uniform(0.8, 1.2, n)], axis=1).astype(np.float32)
    cov = np.tile(np.array([1e-4, 0, 0, 1e-4, 0, 1e-4], np.float32), (n, 1))
    v = np.tile(np.array([[10.0, 0.0, 0.0]], np.float32), (n, 1))
    return x, cov, v


def fault_arrays():
    """Two halves along x at n_grid 32 (tiles of 0.5 grid units): below the
    median a compact box in 4 tiles, above it a spread over 2 x 2 x 3 = 12
    tiles, each with fewer particles than a chunk holds, so that a layout
    of 10 occupied tiles overflows but drops no particle."""
    rng = np.random.default_rng(7)
    h = 512
    box = np.stack([rng.uniform(0.62, 0.9, h), rng.uniform(0.92, 1.08, h),
                    rng.uniform(0.92, 1.08, h)], axis=1)
    spread = np.stack([rng.uniform(1.1, 1.9, h), rng.uniform(0.55, 1.45, h),
                       rng.uniform(0.35, 1.45, h)], axis=1)
    x = np.concatenate([box, spread]).astype(np.float32)
    cov = np.tile(np.array([1e-4, 0, 0, 1e-4, 0, 1e-4], np.float32),
                  (2 * h, 1))
    return x, cov, np.zeros_like(x)


MPM_KW = dict(E=2e4, nu=0.3, material="jelly", grid_extent=2.0,
              substep_dt=DT, density=300.0, gravity=[0.0, 0.0, -9.8])
MIGRATE_KW = dict(MPM_KW, E=1e3, n_grid=64, substep_dt=5e-4,
                  gravity=[0.0, 0.0, 0.0])


def t_problem(arrays, n_grid=None, kw=MPM_KW, collider=True):
    """The port's (state, model, bcs, grid, dt) on numpy arrays."""
    from gsmpm_tpu_torch.config import MPMConfig
    from gsmpm_tpu_torch.sim import boundary as tb
    from gsmpm_tpu_torch.sim.state import GridConfig, init_model, init_state
    from gsmpm_tpu_torch.sim.volume import particle_volume

    kw = dict(kw, **({"n_grid": n_grid} if n_grid else {}))
    x, cov, v = (torch.from_numpy(a) for a in arrays)
    cfg = MPMConfig(**kw)
    g = cfg.n_grid
    state = init_state(x, cov, particle_volume(x, g, 2.0), cfg, v)
    bcs = tb.BCSet(grid_ops=(tb.make_surface_collider((0, 0, 0.3), (0, 0, 1)),)
                   if collider else ())
    return (state, init_model(cfg, x.shape[0], "cpu"), bcs,
            GridConfig(g, 2.0), cfg.substep_dt)


def j_problem(arrays, n_grid=None, kw=MPM_KW, collider=True):
    """gsmpm_tpu's (state, model, bcs, grid, dt) on the same arrays."""
    import jax.numpy as jnp

    from gsmpm_tpu.config import MPMConfig
    from gsmpm_tpu.sim.boundary import BCSet, make_surface_collider
    from gsmpm_tpu.sim.state import GridConfig, init_model, init_state
    from gsmpm_tpu.sim.volume import particle_volume

    kw = dict(kw, **({"n_grid": n_grid} if n_grid else {}))
    x, cov, v = (jnp.asarray(a) for a in arrays)
    cfg = MPMConfig(**kw)
    g = cfg.n_grid
    state = init_state(x, cov, particle_volume(x, g, 2.0), cfg, v)
    bcs = BCSet(grid_ops=(make_surface_collider((0, 0, 0.3), (0, 0, 1)),)
                if collider else ())
    return (state, init_model(cfg, x.shape[0]), bcs, GridConfig(g, 2.0),
            cfg.substep_dt)


def exchange_inputs(world, rank, T=5, G=32):
    """Seeded per-rank arrays of the four exchanges (small trailing dims:
    the exchanges move whole slabs along one axis)."""
    rng = np.random.default_rng(100 * world + rank)
    return dict(
        acc=rng.normal(size=(T, T, T, 4, 8)).astype(np.float32),
        gv=rng.normal(size=(3, T, T, T, 2, 8)).astype(np.float32),
        cells=rng.normal(size=(4, G, G, G)).astype(np.float32),
    )


# tile starts (nt = T - 1) and cell starts of each exchange case: uneven
# slabs, the first and the last rank at the domain's edges
TSTARTS = {2: (0, 3, 4), 4: (0, 2, 5, 6, 8)}
CSTARTS = {2: (0, 13, 32), 4: (0, 6, 14, 25, 32)}
T_OF = {2: 5, 4: 9}


def _np_state(st):
    return {f: getattr(st, f).numpy() for f in FIELDS}


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _case_exchanges(mesh):
    from gsmpm_tpu_torch.parallel import halo, halo_tiled
    from gsmpm_tpu_torch.parallel.mesh import reshape_mesh

    world, r = mesh.world_size, mesh.rank
    d = {k: torch.from_numpy(a) for k, a in
         exchange_inputs(world, r, T_OF[world]).items()}
    ts, cs = TSTARTS[world], CSTARTS[world]
    hc = halo.HaloConfig(ndev=world, n_grid=32, cap=128)
    out = dict(
        acc=halo_tiled._exchange_accum_tiles(d["acc"].clone(), ts[r],
                                             ts[r + 1], mesh, None).numpy(),
        gv=halo_tiled._fetch_edges_stacked(d["gv"].clone(), ts[r], ts[r + 1],
                                           mesh, None).numpy(),
        cells_accum=halo._exchange_accum(d["cells"].clone(), cs[r],
                                         cs[r + 1], mesh, None,
                                         hc).numpy(),
        cells_edges=halo._exchange_edges(d["cells"].clone(), cs[r],
                                         cs[r + 1], mesh, None,
                                         hc).numpy(),
    )
    if world == 4:  # along y on 2 x 2 (the tys of the 2 x 1 case)
        mesh2 = reshape_mesh(mesh, (("hx", 2), ("hy", 2)))
        iy = mesh2.axis_index("hy")
        ty = TSTARTS[2]
        d2 = {k: torch.from_numpy(a) for k, a in
              exchange_inputs(world, r, T_OF[2]).items()}
        out["acc_y"] = halo_tiled._exchange_accum_tiles(
            d2["acc"].clone(), ty[iy], ty[iy + 1], mesh2, "hy",
            adim=1).numpy()
        out["gv_y"] = halo_tiled._fetch_edges_stacked(
            d2["gv"].clone(), ty[iy], ty[iy + 1], mesh2, "hy",
            adim=1).numpy()
    return out


def _small_tile_cap(cap):
    """Patch the engines' tile configs to an occupied-tile cap."""
    from gsmpm_tpu_torch.parallel import halo_tiled, halo_tiled2d

    real1, real2 = halo_tiled.quantile_tile_starts, \
        halo_tiled2d.quantile_tile_starts_2d

    def one(*a, **k):
        r = real1(*a, **k)
        return r and (*r[:2], r[2]._replace(n_occ_cap=cap))

    def two(*a, **k):
        r = real2(*a, **k)
        return r and (*r[:3], r[3]._replace(n_occ_cap=cap))

    halo_tiled.quantile_tile_starts = one
    halo_tiled2d.quantile_tile_starts_2d = two
    return lambda: (setattr(halo_tiled, "quantile_tile_starts", real1),
                    setattr(halo_tiled2d, "quantile_tile_starts_2d", real2))


def _engine_frames(mesh, engine, scene):
    """Two frames of MeshSimEngine(prefer=engine), the rank's shard;
    returns the gathered states and the bytes the rank sent."""
    from gsmpm_tpu_torch.parallel import mesh as tmesh
    from gsmpm_tpu_torch.parallel.engines import MeshSimEngine

    st, md, bcs, grid, dt = t_problem(scene_arrays(scene), SCENES[scene][1])
    st, md = tmesh.shard((st, md), mesh)
    restore = _small_tile_cap(TILE_CAP)
    try:
        eng = MeshSimEngine(mesh, bcs=bcs, grid=grid, substep_dt=dt,
                            n_steps=SUBSTEPS, prefer=engine, state=st)
        tmesh.neighbor_ppermute.bytes_sent = 0
        t = 0.0
        for _ in range(2):
            st, t, _ = eng.frame(st, md, t)
    finally:
        restore()
    return dict(engine=eng.engine, t=t,
                bytes=tmesh.neighbor_ppermute.bytes_sent,
                state=_np_state(tmesh.gather(st, mesh)))


def _case_drift(mesh):
    """halo_tiled's frames on the drift scene, counting the rank's
    rebuckets (one a segment bootstraps, the rest on drift)."""
    from gsmpm_tpu_torch.sim import tiles

    real, calls = tiles.rebucket, []
    tiles.rebucket = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        out = _engine_frames(mesh, "halo_tiled", "drift")
    finally:
        tiles.rebucket = real
    return dict(out, rebuckets=len(calls))


def _case_migrate(mesh):
    """make_halo_frame on the drifting scene: neighbour migration, and the
    gathered fallback (buffers of one row)."""
    from gsmpm_tpu_torch.parallel import halo
    from gsmpm_tpu_torch.sim.kernels import state_from_soa

    st, md, bcs, grid, dt = t_problem(migrate_arrays(), kw=MIGRATE_KW,
                                      collider=False)
    res = halo.quantile_slab_starts(st.x[:, 0].numpy(), 64, 2.0,
                                    mesh.world_size)
    starts, hc = res

    class OneRow(halo.HaloConfig):
        mcap = 1

    out = {}
    gathered = halo.migrate_gathered_slots
    for mode, cfg in (("neighbor", hc), ("fallback", OneRow(*hc))):
        calls = []
        halo.migrate_gathered_slots = \
            lambda *a, **k: calls.append(1) or gathered(*a, **k)
        try:
            *slots, ok0 = halo.bootstrap_slots(st, md, starts, grid, cfg)
            frame = halo.make_halo_frame(mesh, None, bcs, grid, cfg, dt, 15,
                                         migrate_every=5)
            _, _, _, orig, full, t, ok = frame(
                *halo.rank_segment(slots, mesh.rank, cfg.cap), starts, md,
                0.0)
        finally:
            halo.migrate_gathered_slots = gathered
        got = state_from_soa(halo.original_view(full, st.x.shape[0]))
        out[mode] = dict(ok=ok and bool(ok0), gathered_calls=len(calls),
                         orig=orig.numpy(), mass=got.mass.numpy(),
                         state=_np_state(got))
    out["starts"] = starts
    return out


def _case_fault(mesh):
    """A tile cap that only rank 1's bootstrap overflows: the frame is
    redone on psum on every rank (a psum frame of the same state beside
    it)."""
    from gsmpm_tpu_torch.parallel import halo_tiled
    from gsmpm_tpu_torch.parallel import mesh as tmesh
    from gsmpm_tpu_torch.parallel.engines import MeshSimEngine
    from gsmpm_tpu_torch.sim.tiles import bootstrap

    st, md, bcs, grid, dt = t_problem(fault_arrays(), 32)
    tstarts, hc, tc = halo_tiled.quantile_tile_starts(st.x[:, 0].numpy(), 32,
                                                      2.0, mesh.world_size)
    # this rank's occupied tiles at bootstrap (its slots, dead ones parked)
    (*slots, _), _ = halo_tiled.bootstrap_slots_tiled(st, md, tstarts, grid,
                                                      hc)
    from gsmpm_tpu_torch.parallel.halo import rank_segment

    soa, aux, mat, orig = rank_segment(slots, mesh.rank, hc.cap)
    ts = bootstrap(soa, dataclasses.replace(md, mu=aux[0], lam=aux[1],
                                            viscosity=aux[2], material=mat),
                   grid, tc)
    occupied = int(torch.unique(ts.chunk_tile[ts.chunk_live == 1]).numel())
    sl, ml = tmesh.shard((st, md), mesh)
    restore = _small_tile_cap(FAULT_CAP)
    try:
        eng = MeshSimEngine(mesh, bcs=bcs, grid=grid, substep_dt=dt,
                            n_steps=SUBSTEPS, prefer="halo_tiled", state=sl)
        out, _, _ = eng.frame(sl, ml, 0.0)
    finally:
        restore()
    psum = MeshSimEngine(mesh, bcs=bcs, grid=grid, substep_dt=dt,
                         n_steps=SUBSTEPS, prefer="psum")
    want, _, _ = psum.frame(sl, ml, 0.0)
    return dict(tstarts=tstarts, occupied=occupied, engine=eng.engine,
                state=_np_state(tmesh.gather(out, mesh)),
                psum=_np_state(tmesh.gather(want, mesh)))


def _case_select(mesh):
    """MeshSimEngine's choice with no engine= on the CPU."""
    from gsmpm_tpu_torch.parallel import mesh as tmesh
    from gsmpm_tpu_torch.parallel.engines import MeshSimEngine

    out = {}
    for name, n_grid, inc, arrays in (
            ("g64", 64, False, scene_arrays("halo")),
            ("g32", 32, False, scene_arrays("halo")),
            ("g64_inc", 64, True, scene_arrays("halo")),
            # every particle in the last x-cell: no slabs, halo falls through
            ("narrow", 64, False, tuple(
                np.where(np.arange(3) == 0, np.float32(1.99), a)
                if k == 0 else a
                for k, a in enumerate(scene_arrays("halo"))))):
        st, md, bcs, grid, dt = t_problem(arrays, n_grid)
        eng = MeshSimEngine(mesh, bcs=bcs, grid=grid, substep_dt=dt,
                            n_steps=SUBSTEPS, incremental_cov=inc,
                            state=tmesh.shard(st, mesh))
        out[name] = eng.engine
    return out


def _case_app(mesh, root):
    from gsmpm_tpu_torch.apps import simulate as tsim
    from gsmpm_tpu_torch.config import SimConfig

    stats = {}
    frames = tsim.simulate(SimConfig.from_json(os.path.join(root,
                                                            "mesh.json")),
                           synthetic=512, frames=2, quiet=True,
                           synthetic_res=64, device="cpu", stats=stats,
                           mesh=f"data={mesh.world_size}")
    return dict(frames=frames, engine=stats["engine"],
                n_dropped=stats["n_dropped"])


def _worker(rank, world, port, out_path, root):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dist = torch.distributed
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        from gsmpm_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh((("data", world),), "cpu")
        res = {"exchanges": _case_exchanges(mesh)}
        for engine, scene in ENGINE_CASES[world]:
            res[engine] = _engine_frames(mesh, engine, scene)
        res["select"] = _case_select(mesh)
        if world == 2:
            res["drift"] = _case_drift(mesh)
            res["migrate"] = _case_migrate(mesh)
            res["fault"] = _case_fault(mesh)
            res["app"] = _case_app(mesh, root)
        every = [None] * world
        dist.all_gather_object(every, res)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(every, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world, out_path, root):
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, out_path,
                                               root))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, out_path, deadline):
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} of {len(procs)} ranks still running " \
                     f"after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    with open(out_path, "rb") as f:
        return pickle.load(f)


def _app_configs(root):
    """n_grid 64 (auto picks halo on the CPU), 10 substeps a frame."""
    cfg = {"mpm": {"n_grid": 64, "E": 2e4, "nu": 0.3, "material": "jelly",
                   "density": 300.0, "substep_dt": 2e-4, "frame_dt": 2e-3,
                   "gravity": [0.0, 0.0, -9.8]}}
    for name in ("mesh", "single"):
        (root / f"{name}.json").write_text(json.dumps(
            dict(cfg, render={"output_path": str(root / name)})))


# ---------------------------------------------------------------------------
# the other sides, computed while the ranks run
# ---------------------------------------------------------------------------

def _jax_exchanges(world):
    """gsmpm_tpu's exchanges under shard_map on world host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from gsmpm_tpu.parallel import halo, halo_tiled

    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    devs = np.array(jax.devices()[:world])
    hc = halo.HaloConfig(ndev=world, n_grid=32, cap=128)

    def run(mesh, axis, fn, key, starts, T):
        """fn(a, start, end) on each device's array of exchange_inputs,
        the device's index along axis picking its [start, end)."""
        per = [exchange_inputs(world, r, T)[key] for r in range(world)]
        names = mesh.axis_names
        stacked = jnp.asarray(np.stack(per).reshape(
            *mesh.devices.shape, *per[0].shape))
        lead = (0,) * len(names)

        def local(a, st):
            i = jax.lax.axis_index(axis)
            return fn(a[lead], st[i], st[i + 1])[(None,) * len(names)]

        out = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(*names), P()),
                                out_specs=P(*names), check_vma=False))(
            stacked, jnp.asarray(starts, jnp.int32))
        return np.asarray(out).reshape(world, *per[0].shape)

    mesh = Mesh(devs, ("x",))
    ts, cs, T = TSTARTS[world], CSTARTS[world], T_OF[world]
    res = dict(
        acc=run(mesh, "x", lambda a, t0, t1: halo_tiled.
                _exchange_accum_tiles(a, t0, t1, "x", world), "acc", ts, T),
        gv=run(mesh, "x", lambda a, t0, t1: halo_tiled.
               _fetch_edges_stacked(a, t0, t1, "x", world), "gv", ts, T),
        cells_accum=run(mesh, "x", lambda a, x0, x1: halo._exchange_accum(
            a, x0, x1, "x", hc), "cells", cs, T),
        cells_edges=run(mesh, "x", lambda a, x0, x1: halo._exchange_edges(
            a, x0, x1, "x", hc), "cells", cs, T),
    )
    if world == 4:
        mesh2 = Mesh(devs.reshape(2, 2), ("hx", "hy"))
        ty = TSTARTS[2]
        res["acc_y"] = run(mesh2, "hy", lambda a, t0, t1: halo_tiled.
                           _exchange_accum_tiles(a, t0, t1, "hy", 2, adim=1),
                           "acc", ty, T_OF[2])
        res["gv_y"] = run(mesh2, "hy", lambda a, t0, t1: halo_tiled.
                          _fetch_edges_stacked(a, t0, t1, "hy", 2, adim=1),
                          "gv", ty, T_OF[2])
    return res


def _jax_engine_frames(world, engine, scene):
    """gsmpm_tpu's engine on the scene: two frames of SUBSTEPS with the slot
    state carried, as its MeshSimEngine runs them (migrate_every 10)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from gsmpm_tpu.parallel import halo, halo_tiled, halo_tiled2d
    from gsmpm_tpu.sim.kernels import state_from_soa

    st, md, bcs, grid, dt = j_problem(scene_arrays(scene), SCENES[scene][1])
    n, g = st.x.shape[0], SCENES[scene][1]
    devs = np.array(jax.devices()[:world])
    x = np.asarray(st.x)
    if engine == "halo":
        starts, hc = halo.quantile_slab_starts(x[:, 0], g, 2.0, world)
        mesh = Mesh(devs, ("x",))
        fn = halo.make_halo_frame(mesh, "x", bcs, grid, hc, dt, SUBSTEPS)
        boot = halo.bootstrap_slots(st, md, starts, grid, hc)
        extra = (jnp.asarray(starts, jnp.int32),)
    elif engine == "halo_tiled":
        starts, hc, tc = halo_tiled.quantile_tile_starts(x[:, 0], g, 2.0,
                                                         world)
        mesh = Mesh(devs, ("x",))
        fn = halo_tiled.make_halo_tiled_frame(
            mesh, "x", bcs, grid, hc, tc._replace(n_occ_cap=TILE_CAP), dt,
            SUBSTEPS)
        boot = halo_tiled.bootstrap_slots_tiled(st, md, starts, grid, hc)[0]
        extra = (jnp.asarray(starts, jnp.int32),)
    else:
        txs, tys, hc, tc = halo_tiled2d.quantile_tile_starts_2d(
            x[:, :2], g, 2.0, 2, 2)
        mesh = Mesh(devs.reshape(2, 2), ("hx", "hy"))
        fn = halo_tiled2d.make_halo_tiled2d_frame(
            mesh, "hx", "hy", bcs, grid, hc, tc._replace(n_occ_cap=TILE_CAP),
            dt, SUBSTEPS)
        boot = halo_tiled2d.bootstrap_slots_2d(st, md, txs, tys, grid, hc,
                                               2, 2)
        extra = (jnp.asarray(txs, jnp.int32), jnp.asarray(tys, jnp.int32))
    fn = jax.jit(fn)
    *slots, ok0 = boot
    assert bool(ok0)
    t = jnp.float32(0.0)
    with mesh:
        for _ in range(2):
            *slots, full, t, ok = fn(*slots, *extra, md, t)
            assert bool(ok), f"gsmpm_tpu {engine} x{world}: not ok"
    out = state_from_soa(halo.original_view(full, n))
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


def _jax_fault():
    """gsmpm_tpu's halo_tiled frame on the fault scene with FAULT_CAP on 2
    devices: (ok it returns, its mass sum)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from gsmpm_tpu.parallel import halo, halo_tiled

    st, md, bcs, grid, dt = j_problem(fault_arrays(), 32)
    starts, hc, tc = halo_tiled.quantile_tile_starts(
        np.asarray(st.x[:, 0]), 32, 2.0, 2)
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    fn = jax.jit(halo_tiled.make_halo_tiled_frame(
        mesh, "x", bcs, grid, hc, tc._replace(n_occ_cap=FAULT_CAP), dt,
        SUBSTEPS))
    (*slots, ok0), _ = halo_tiled.bootstrap_slots_tiled(st, md, starts, grid,
                                                        hc)
    with mesh:
        *_, full, _, ok = fn(*slots, jnp.asarray(starts, jnp.int32), md,
                             jnp.float32(0.0))
    mass = np.asarray(halo.original_view(full, st.x.shape[0]).mass)
    return dict(ok=bool(ok), boot_ok=bool(ok0), mass=float(mass.sum()),
                mass0=float(np.asarray(st.mass).sum()))


def _port_single(root):
    """The single-device port: 20 golden substeps of every engine scene
    and of the fault scene, the drifting scene's 15, and the app without
    a mesh."""
    from gsmpm_tpu_torch.apps import simulate as tsim
    from gsmpm_tpu_torch.config import SimConfig
    from gsmpm_tpu_torch.sim.solver import run_substeps

    out = {}
    for name, (_, g, _, _) in SCENES.items():
        st, md, bcs, grid, dt = t_problem(scene_arrays(name), g)
        st, t = run_substeps(st, md, bcs, 0.0, 2 * SUBSTEPS, grid, dt,
                             checkpoint_policy=None)
        out[name] = dict(_np_state(st), t=t)
    st, md, bcs, grid, dt = t_problem(migrate_arrays(), kw=MIGRATE_KW,
                                      collider=False)
    out["migrate0"] = dict(mass=st.mass.numpy(), v=st.v.numpy(),
                           x=st.x.numpy())
    st, _ = run_substeps(st, md, bcs, 0.0, 15, grid, dt,
                         checkpoint_policy=None)
    out["migrate"] = _np_state(st)
    # the tiled engine's CPU twins at an occupied-tile cap that the box
    # fits (the default, 512 at n_grid 64, costs ~50 s a frame here)
    stats, default_tc = {}, tsim.default_tile_config
    tsim.default_tile_config = \
        lambda g, m: default_tc(g, m)._replace(n_occ_cap=APP_TILE_CAP)
    try:
        out["app"] = dict(frames=tsim.simulate(
            SimConfig.from_json(str(root / "single.json")), synthetic=512,
            frames=2, quiet=True, synthetic_res=64, device="cpu",
            stats=stats, mesh="none"), engine=stats["engine"])
    finally:
        tsim.default_tile_config = default_tc
    return out


# the JAX package's share, split over two processes (XLA compiles on one
# core): name -> (function, arguments)
JAX_JOBS = (
    {"exchanges2": (_jax_exchanges, (2,)),
     "exchanges4": (_jax_exchanges, (4,)),
     "halo2": (_jax_engine_frames, (2, "halo", "halo")),
     "fault": (_jax_fault, ()),
     "drift2": (_jax_engine_frames, (2, "halo_tiled", "drift"))},
    {f"{e}{w}": (_jax_engine_frames, (w, e, s))
     for w, cases in ENGINE_CASES.items() for e, s in cases if e != "halo"},
)


def _jax_worker(job, out_path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    res = {name: fn(*args) for name, (fn, args) in JAX_JOBS[job].items()}
    with open(out_path, "wb") as f:
        pickle.dump([res], f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both world sizes' ranks and the JAX package's two processes started
    together; the single-device port computed here while they run."""
    root = tmp_path_factory.mktemp("halo")
    _app_configs(root)
    outs = {w: str(root / f"ranks{w}.pkl") for w in (2, 4)}
    procs = {w: _start(w, outs[w], str(root)) for w in (4, 2)}
    mp = multiprocessing.get_context("spawn")
    for job in range(len(JAX_JOBS)):
        outs[f"jax{job}"] = str(root / f"jax{job}.pkl")
        procs[f"jax{job}"] = [mp.Process(target=_jax_worker,
                                         args=(job, outs[f"jax{job}"]))]
        procs[f"jax{job}"][0].start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        single = _port_single(root)
    finally:
        done = {k: _join(p, outs[k], deadline) for k, p in procs.items()}
    jx = {}
    for job in range(len(JAX_JOBS)):
        jx.update(done[f"jax{job}"][0])
    return dict(ranks={w: done[w] for w in (2, 4)}, jax=jx, single=single,
                root=root)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _close(got, want, what):
    for f in FIELDS:
        rtol, atol = TOL[f]
        np.testing.assert_allclose(got[f], want[f], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {f}")


def _jax_state(arrays, n_grid):
    """The JAX state and model and the port's built from its arrays."""
    from gsmpm_tpu_torch.models.convert import state_from_numpy

    jst, jmd, _, jgrid, _ = j_problem(arrays, n_grid)
    tst = state_from_numpy({f: np.asarray(getattr(jst, f))
                            for f in jst.__dataclass_fields__})
    _, tmd, _, tgrid, _ = t_problem(arrays, n_grid)
    return jst, jmd, jgrid, tst, tmd, tgrid


def _equal_slots(got, want, what):
    soa_t, aux_t, mat_t, orig_t, ok_t = got
    soa_j, aux_j, mat_j, orig_j, ok_j = want
    for name, pt, pj in zip(soa_t._fields, soa_t, soa_j):
        for a, b in zip(pt if isinstance(pt, tuple) else (pt,),
                        pj if isinstance(pj, tuple) else (pj,)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(aux_t.numpy(), np.asarray(aux_j))
    np.testing.assert_array_equal(mat_t.numpy(), np.asarray(mat_j))
    np.testing.assert_array_equal(orig_t.numpy(), np.asarray(orig_j))
    assert bool(ok_t) == bool(ok_j), what


def test_quantile_starts_match_jax():
    from gsmpm_tpu.parallel import halo as jh
    from gsmpm_tpu.parallel import halo_tiled as jht
    from gsmpm_tpu.parallel import halo_tiled2d as jh2

    from gsmpm_tpu_torch.parallel import halo, halo_tiled, halo_tiled2d

    rng = np.random.default_rng(11)
    xs = [scene_arrays(s)[0] for s in SCENES] + [
        fault_arrays()[0], migrate_arrays()[0],
        np.full((512, 3), 0.51, np.float32),  # 3 cells wide: degenerate
        rng.uniform(0.0, 2.0, (4096, 3)).astype(np.float32)]
    checked = 0
    for x in xs:
        for g in (32, 64, 100, 128):
            for nd in (1, 2, 4, 8):
                for slack in (1.5, 4.0):
                    a = halo.quantile_slab_starts(x[:, 0], g, 2.0, nd,
                                                  cap_slack=slack)
                    assert a == jh.quantile_slab_starts(
                        x[:, 0], g, 2.0, nd, cap_slack=slack)
                    b = halo_tiled.quantile_tile_starts(x[:, 0], g, 2.0, nd,
                                                        cap_slack=slack)
                    assert b == jht.quantile_tile_starts(
                        x[:, 0], g, 2.0, nd, cap_slack=slack)
                    checked += (a is not None) + (b is not None)
            for dx, dy in ((1, 1), (2, 1), (2, 2), (4, 2), (8, 1)):
                c = halo_tiled2d.quantile_tile_starts_2d(x[:, :2], g, 2.0,
                                                         dx, dy)
                assert c == jh2.quantile_tile_starts_2d(x[:, :2], g, 2.0,
                                                        dx, dy)
                checked += c is not None
    assert checked > 200
    assert halo.quantile_slab_starts(xs[-2][:, 0], 32, 2.0, 8) is None
    assert halo_tiled.quantile_tile_starts(xs[-1][:, 0], 64, 2.0, 8) is None


@pytest.mark.parametrize("kind", ["slabs", "tiles", "rects", "moved_y"])
def test_bootstrap_and_partition_match_jax(kind):
    """The same slots, slot for slot, as gsmpm_tpu's (stable sorts)."""
    import jax.numpy as jnp

    from gsmpm_tpu.parallel import halo as jh
    from gsmpm_tpu.parallel import halo_tiled as jht
    from gsmpm_tpu.parallel import halo_tiled2d as jh2

    from gsmpm_tpu_torch.parallel import halo, halo_tiled, halo_tiled2d

    scene = "tiled2d" if kind == "rects" else "halo"
    arrays = scene_arrays(scene)
    g = SCENES[scene][1]
    jst, jmd, jgrid, tst, tmd, tgrid = _jax_state(arrays, g)
    x = arrays[0]
    if kind in ("slabs", "moved_y"):
        starts, hc = halo.quantile_slab_starts(x[:, 0], g, 2.0, 4)
        got = halo.bootstrap_slots(tst, tmd, starts, tgrid, hc)
        want = jh.bootstrap_slots(jst, jmd, starts, jgrid, hc)
    elif kind == "tiles":
        starts, hc, _ = halo_tiled.quantile_tile_starts(x[:, 0], g, 2.0, 4)
        got, cells = halo_tiled.bootstrap_slots_tiled(tst, tmd, starts,
                                                      tgrid, hc)
        want, jcells = jht.bootstrap_slots_tiled(jst, jmd, starts, jgrid, hc)
        assert cells == jcells
    else:
        txs, tys, hc, _ = halo_tiled2d.quantile_tile_starts_2d(x[:, :2], g,
                                                               2.0, 2, 2)
        got = halo_tiled2d.bootstrap_slots_2d(tst, tmd, txs, tys, tgrid, hc,
                                              2, 2)
        want = jh2.bootstrap_slots_2d(jst, jmd, txs, tys, jgrid, hc, 2, 2)
    _equal_slots(got, want, kind)
    assert bool(got[-1])
    if kind == "moved_y":
        # repartition the slots (dead ones included) along y after a seeded
        # move, as a gathered migration does
        dy = np.random.default_rng(5).normal(
            scale=0.2, size=x.shape[0] * 0 + got[0].x[1].shape[0]
        ).astype(np.float32)
        ystarts = (0, 30, 33, 36, 64)
        soa_t = got[0]._replace(x=(got[0].x[0], got[0].x[1]
                                   + torch.from_numpy(dy), got[0].x[2]))
        soa_j = want[0]._replace(x=(want[0].x[0], want[0].x[1]
                                    + jnp.asarray(dy), want[0].x[2]))
        got = halo.partition_slots(soa_t, *got[1:4], ystarts, tgrid, hc,
                                   coord=1)
        want = jh.partition_slots(soa_j, *want[1:4],
                                  jnp.asarray(ystarts, jnp.int32), jgrid, hc,
                                  coord=1)
        _equal_slots(got, want, "moved_y")


@pytest.mark.parametrize("world", [2, 4])
def test_exchanges_bit_equal_to_jax(runs, world):
    want = runs["jax"][f"exchanges{world}"]
    for r, res in enumerate(runs["ranks"][world]):
        for key, got in res["exchanges"].items():
            np.testing.assert_array_equal(got, want[key][r],
                                          err_msg=f"rank {r}: {key}")
    assert set(want) == set(runs["ranks"][world][0]["exchanges"])


ENGINE_PARAMS = [(w, e, s) for w, cases in ENGINE_CASES.items()
                 for e, s in cases]


@pytest.mark.parametrize("world,engine,scene", ENGINE_PARAMS,
                         ids=[f"{e}-x{w}" for w, e, _ in ENGINE_PARAMS])
def test_engine_frames_match_single_and_jax(runs, world, engine, scene):
    got = runs["ranks"][world][0][engine]
    assert got["engine"] == engine, "fell back"
    assert got["t"] == runs["single"][scene]["t"]
    _close(got["state"], runs["single"][scene], f"{engine} x{world} vs port")
    _close(got["state"], runs["jax"][f"{engine}{world}"],
           f"{engine} x{world} vs gsmpm_tpu")
    # every rank exchanged strips each substep: an inner rank sends both
    # ways, an edge rank one
    sent = [res[engine]["bytes"] for res in runs["ranks"][world]]
    assert min(sent) > 0


def test_halo_tiled_rebuckets_on_drift_within_a_segment(runs):
    """Only rank 1's blob drifts past its tile windows' margin: rank 1
    rebuckets inside its segments, rank 0 only at each segment's
    bootstrap, and the frames match the single device and gsmpm_tpu's
    engine (without the rebucket, the transfers clamped to the windows
    miss them)."""
    res = runs["ranks"][2]
    got = res[0]["drift"]
    assert got["engine"] == "halo_tiled", "fell back"
    assert got["t"] == runs["single"]["drift"]["t"]
    segments = 2  # two frames of SUBSTEPS, migrate_every 10
    rebuckets = [r["drift"]["rebuckets"] for r in res]
    assert rebuckets[0] == segments < rebuckets[1], rebuckets
    _close(got["state"], runs["single"]["drift"], "drift vs port")
    _close(got["state"], runs["jax"]["drift2"], "drift vs gsmpm_tpu")


def test_neighbor_migration_and_fallback_conserve(runs):
    """tests/test_halo.py:146 and :227 on 2 ranks: the drift moves
    particles across the slab boundary; neighbour buffers and the gathered
    fallback (buffers of one row) keep every particle once, conserve mass
    and momentum, match the single device and each other."""
    res = runs["ranks"][2]
    m = res[0]["migrate"]
    s0 = runs["single"]["migrate0"]
    want = runs["single"]["migrate"]
    inv_dx = 32.0
    own0 = np.searchsorted(np.asarray(m["starts"][1:-1]), s0["x"][:, 0]
                           * inv_dx, side="right")
    own1 = np.searchsorted(np.asarray(m["starts"][1:-1]), want["x"][:, 0]
                           * inv_dx, side="right")
    assert (own0 != own1).sum() > 100, "the drift must change owners"
    n = s0["mass"].shape[0]
    p0 = (s0["mass"][:, None] * s0["v"]).sum(0)
    for mode in ("neighbor", "fallback"):
        per = [r["migrate"][mode] for r in res]
        assert all(p["ok"] for p in per), mode
        calls = [p["gathered_calls"] for p in per]
        # 3 migrations a frame on every rank, one branch for the axis
        assert calls == ([0, 0] if mode == "neighbor" else [3, 3]), \
            (mode, calls)
        orig = np.concatenate([p["orig"] for p in per])
        assert np.array_equal(np.sort(orig[orig >= 0]), np.arange(n)), mode
        got = per[0]["state"]
        np.testing.assert_allclose(per[0]["mass"].sum(), s0["mass"].sum(),
                                   rtol=1e-6, err_msg=mode)
        p1 = (per[0]["mass"][:, None] * got["v"]).sum(0)
        np.testing.assert_allclose(p1, p0, rtol=2e-5,
                                   atol=2e-6 * np.abs(p0).max(),
                                   err_msg=mode)
        _close(got, want, f"migration {mode} vs port")
    a, b = res[0]["migrate"]["neighbor"], res[0]["migrate"]["fallback"]
    np.testing.assert_allclose(a["state"]["x"], b["state"]["x"], rtol=1e-5,
                               atol=1e-6)


def test_engine_order():
    from gsmpm_tpu_torch.parallel.engines import engine_order, mesh_2d_shape

    assert engine_order("halo_tiled2d", "cuda", 100, False) == \
        ["halo_tiled2d"]
    # CUDA keeps tiled first where gsmpm_tpu's TPU order starts with
    # halo_tiled (n_grid >= 96): slower than tiled on H100s (ROADMAP C)
    assert engine_order(None, "cuda", 100, False) == ["tiled", "psum"]
    assert engine_order(None, "cuda", 96, False) == ["tiled", "psum"]
    assert engine_order(None, "cuda", 95, False) == ["tiled", "psum"]
    assert engine_order(None, "cuda", 100, True) == ["psum"]
    assert engine_order(None, "cpu", 100, False) == \
        ["halo", "halo_tiled2d", "psum"]
    assert engine_order(None, "cpu", 64, False)[0] == "halo"
    assert engine_order(None, "cpu", 63, False) == ["psum"]
    assert engine_order(None, "cpu", 64, True) == ["psum"]
    with pytest.raises(ValueError):
        engine_order("halo3d", "cpu", 64, False)
    # the 2-D mesh: dy the largest divisor <= sqrt(n); a prime n > 2 none
    shapes = {n: mesh_2d_shape(n) for n in (1, 2, 3, 4, 6, 8, 9, 12)}
    assert shapes == {1: (1, 1), 2: (2, 1), 3: None, 4: (2, 2), 6: (3, 2),
                      8: (4, 2), 9: (3, 3), 12: (4, 3)}


@pytest.mark.parametrize("world", [2, 4])
def test_selection_on_the_cpu_mesh(runs, world):
    """No engine=: halo at n_grid 64, psum below or with incremental_cov,
    halo_tiled2d when no x-slabs fit (the quantile returned None), the
    same on every rank."""
    picks = [res["select"] for res in runs["ranks"][world]]
    assert all(p == picks[0] for p in picks)
    assert picks[0] == dict(g64="halo", g32="psum", g64_inc="psum",
                            narrow="halo_tiled2d")


def test_tile_cap_overflow_on_rank_1_only_is_redone_on_psum(runs):
    """The JAX fault (ROADMAP C): gsmpm_tpu's halo_tiled frame ANDs each
    device's own tile-cap flag into ok and returns ok under a replicated
    out_spec without reducing it, so it reports device 0's flag.  On this
    scene rank 0's box fits the cap and rank 1's spread does not (without
    dropping a particle, which the reduced drift check would see), and
    gsmpm_tpu's frame returns ok True.  The port reduces ok with MIN:
    every rank redoes the frame on psum."""
    res = runs["ranks"][2]
    occ = [r["fault"]["occupied"] for r in res]
    assert occ[0] <= FAULT_CAP < occ[1], occ
    jx = runs["jax"]["fault"]
    assert jx["boot_ok"] and jx["ok"], "gsmpm_tpu's frame reports ok"
    assert jx["mass"] == pytest.approx(jx["mass0"], rel=1e-6)
    for r in res:
        assert r["fault"]["engine"] == "psum"
    got = res[0]["fault"]
    for f in FIELDS:  # redone from the same start state: psum's frame
        np.testing.assert_array_equal(got["state"][f], got["psum"][f],
                                      err_msg=f)


def test_app_mesh_picks_halo_and_writes_the_single_run_frames(runs):
    got = runs["ranks"][2][0]["app"]
    want = runs["single"]["app"]
    assert got["engine"] == ["halo", "halo"]
    assert want["engine"] == ["tiled", "tiled"]
    assert got["n_dropped"] == [0, 0, 0]
    assert len(got["frames"]) == len(want["frames"]) == 3
    for a, b in zip(got["frames"], want["frames"]):
        # the tile-sharded render (K4's twin) vs the stream render (K3's),
        # the golden engine per slab vs the tiled engine: sums in other
        # orders over 20 substeps
        np.testing.assert_allclose(a, b, atol=2e-4)
    pngs = sorted((runs["root"] / "mesh" / "images").glob("*.png"))
    assert [p.name for p in pngs] == ["0000.png", "0001.png", "0002.png"]


def test_parse_mesh_accepts_the_halo_engines(monkeypatch):
    from gsmpm_tpu_torch.apps.simulate import parse_mesh

    monkeypatch.setenv("WORLD_SIZE", "4")
    for e in ("halo", "halo_tiled", "halo_tiled2d", "tiled", "psum"):
        assert parse_mesh(f"data=4,engine={e}") == (4, e)
    assert parse_mesh("auto") == (4, None)
    with pytest.raises(ValueError):
        parse_mesh("data=4,engine=halo3d")


def test_dryrun_multichip_4():
    from gsmpm_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(4, timeout_s=JOIN_TIMEOUT_S)
    assert res["fit_step"]["mesh"] == "data=2 x tile=2"
    assert np.isfinite(res["fit_step"]["loss"])
    assert {"tiled", "halo", "halo_tiled", "halo_tiled2d", "app"} <= set(res)
