"""Multi-process dry run of parallel/: every mesh engine once, tiny.

Counterpart of gsmpm_tpu's ``__graft_entry__.dryrun_multichip``:

    python -c "from gsmpm_tpu_torch.parallel.dryrun import dryrun_multichip; \\
               print(dryrun_multichip(4))"

spawns n gloo ranks on the CPU (a free localhost port, a join timeout) and
runs tiny instances of the sharded fit step (data x tile, tile 2 when n is
even), the chunk-sharded tiled frame, the halo, halo_tiled and (n even and
>= 4) halo_tiled2d frames, and apps.simulate on the mesh; each must give
finite outputs and ``ok``.  Returns rank 0's summary.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch


def _tiny_problem(n_particles: int = 256, n_grid: int = 16, img: int = 32,
                  fitting: bool = False):
    """A synthetic box (seed 0) in grid space, its model, a ground collider
    at z 0.4 and a camera 2.5 in front of it."""
    from gsmpm_tpu_torch.config import MPMConfig
    from gsmpm_tpu_torch.models.synthetic import synthetic_box_scene
    from gsmpm_tpu_torch.render.camera import make_camera
    from gsmpm_tpu_torch.sim.boundary import BCSet, make_surface_collider
    from gsmpm_tpu_torch.sim.coupling import world2grid
    from gsmpm_tpu_torch.sim.state import GridConfig, init_model, init_state
    from gsmpm_tpu_torch.sim.volume import particle_volume

    cfg = MPMConfig(E=2e4, nu=0.3, material="jelly", n_grid=n_grid,
                    grid_extent=2.0, substep_dt=1e-4, frame_dt=1e-2,
                    density=200.0, fitting=fitting)
    scene = synthetic_box_scene(n=n_particles, lo=(-0.4, -0.4, 0.2),
                                hi=(0.4, 0.4, 1.0))
    g_xyz, pos_center, scaling = world2grid(scene.xyz, cfg.grid_extent)
    g_cov = scene.get_covariance() * (scaling * scaling)
    vol = particle_volume(g_xyz, cfg.n_grid, cfg.grid_extent)
    state = init_state(g_xyz, g_cov, vol, cfg)
    model = init_model(cfg, n_particles, "cpu")
    bcs = BCSet(grid_ops=(make_surface_collider((0, 0, 0.4), (0, 0, 1)),))
    camera = make_camera(img, img, 0.9, 0.9, np.eye(3),
                         np.array([0.0, 0.0, -2.5]))
    return (cfg, scene, state, model, bcs,
            GridConfig(cfg.n_grid, cfg.grid_extent), camera, scaling,
            pos_center)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dry run: {what}")


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tree)


def _fit_step(n: int) -> dict:
    from gsmpm_tpu_torch.parallel.mesh import make_mesh, pad_particles, shard
    from gsmpm_tpu_torch.parallel.sharded import make_sharded_fit_step

    tile = 2 if n % 2 == 0 and n > 1 else 1
    data = n // tile
    mesh = make_mesh((("data", data), ("tile", tile)), "cpu")
    cfg, scene, state, model, bcs, grid, camera, scaling, pos_center = \
        _tiny_problem(n_particles=16 * data, n_grid=8, img=16, fitting=True)
    st, md, extras, _ = pad_particles(
        state, model, data, {"opacity": scene.get_opacity().reshape(-1),
                             "features": scene.get_features()})
    step = make_sharded_fit_step(
        mesh, example_model=md, bcs=bcs, grid=grid, frame_dt=cfg.frame_dt,
        n_substeps=3, camera=camera, bg=torch.ones(3),
        opacity=shard(extras["opacity"], mesh, "data"),
        features=shard(extras["features"], mesh, "data"),
        sh_degree=scene.sh_degree, scaling=scaling, pos_center=pos_center,
        grid_extent=cfg.grid_extent)
    logE, y, st_l = shard((md.logE, md.y, st), mesh, "data")
    out = step(logE, y, st_l, 0.0,
               torch.zeros((camera.height, camera.width, 3)))
    _check(out.sim_ok and np.isfinite(float(out.loss)), "fit step")
    return dict(mesh=f"data={data} x tile={tile}", loss=float(out.loss))


def _tiled_frame(mesh) -> dict:
    from gsmpm_tpu_torch.parallel.tiled_sharded import (
        make_sharded_frame_tiled, shard_tiled, sharded_tile_config,
    )
    from gsmpm_tpu_torch.sim.kernels import soa_from_state
    from gsmpm_tpu_torch.sim.tiles import bootstrap

    cfg, _, state, model, bcs, grid, *_ = _tiny_problem(256, 16, 16)
    tc = sharded_tile_config(cfg.n_grid, 256, mesh.world_size)
    ts = bootstrap(soa_from_state(state), model, grid, tc)
    frame = make_sharded_frame_tiled(mesh, model=model, bcs=bcs, grid=grid,
                                     tc=tc, dt=cfg.substep_dt, n_substeps=10,
                                     rebucket_every=5)
    ts, q, _ = frame(shard_tiled(ts, mesh, tc), 0.0)
    _check(bool(ts.ok) and _finite([q]), "tiled frame")
    return dict(ok=True)


def _halo_frames(mesh) -> dict:
    from gsmpm_tpu_torch.parallel import halo, halo_tiled, halo_tiled2d
    from gsmpm_tpu_torch.parallel.mesh import reshape_mesh

    n = mesh.world_size
    out = {}
    cfg, _, state, model, bcs, grid, *_ = _tiny_problem(512, 8 * n, 16)
    res = halo.quantile_slab_starts(state.x[:, 0].numpy(), cfg.n_grid,
                                    cfg.grid_extent, n)
    _check(res is not None, "halo: the scene must admit slabs")
    starts, hc = res
    *slots, ok0 = halo.bootstrap_slots(state, model, starts, grid, hc)
    _check(bool(ok0), "slot capacity at bootstrap")
    frame = halo.make_halo_frame(mesh, None, bcs, grid, hc, cfg.substep_dt,
                                 10, migrate_every=5)
    *_, full, _, ok = frame(*halo.rank_segment(slots, mesh.rank, hc.cap),
                            starts, model, 0.0)
    _check(ok and _finite(halo.original_view(full, 512).x), "halo")
    out["halo"] = dict(starts=starts)

    # cap_slack 4: the tiny box spans half the tiles, so the slabs the
    # quantiles are pushed to hold unequal counts (as gsmpm_tpu's dry run)
    cfg, _, state, model, bcs, grid, *_ = _tiny_problem(512, 16 * n, 16)
    res = halo_tiled.quantile_tile_starts(state.x[:, 0].numpy(), cfg.n_grid,
                                          cfg.grid_extent, n, cap_slack=4.0)
    _check(res is not None, "halo_tiled: the scene must admit tile slabs")
    tstarts, hc, tc = res
    tc = tc._replace(n_occ_cap=min(tc.occ_cap, 64))
    (*slots, ok0), _ = halo_tiled.bootstrap_slots_tiled(state, model,
                                                        tstarts, grid, hc)
    _check(bool(ok0), "slot capacity at bootstrap")
    frame = halo_tiled.make_halo_tiled_frame(
        mesh, None, bcs, grid, hc, tc, cfg.substep_dt, 10, migrate_every=5)
    *_, full, _, ok = frame(*halo.rank_segment(slots, mesh.rank, hc.cap),
                            tstarts, model, 0.0)
    _check(ok and _finite(halo.original_view(full, 512).x), "halo_tiled")
    out["halo_tiled"] = dict(tile_starts=tstarts)

    if n % 2 == 0 and n >= 4:
        dx, dy = n // 2, 2
        cfg, _, state, model, bcs, grid, *_ = _tiny_problem(
            512, 8 * max(2 * dx, 2 * dy), 16)
        res = halo_tiled2d.quantile_tile_starts_2d(
            state.x[:, :2].numpy(), cfg.n_grid, cfg.grid_extent, dx, dy,
            cap_slack=4.0)
        _check(res is not None, "halo_tiled2d: the scene needs rectangles")
        txs, tys, hc2, tc = res
        tc = tc._replace(n_occ_cap=min(tc.occ_cap, 64))
        mesh2 = reshape_mesh(mesh, (("hx", dx), ("hy", dy)))
        *slots, ok0 = halo_tiled2d.bootstrap_slots_2d(
            state, model, txs, tys, grid, hc2, dx, dy)
        _check(bool(ok0), "slot capacity at bootstrap")
        frame = halo_tiled2d.make_halo_tiled2d_frame(
            mesh2, "hx", "hy", bcs, grid, hc2, tc, cfg.substep_dt, 10,
            migrate_every=5)
        *_, full, _, ok = frame(
            *halo.rank_segment(slots, mesh2.rank, hc2.cap), txs, tys, model,
            0.0)
        _check(ok and _finite(halo.original_view(full, 512).x),
               "halo_tiled2d")
        out["halo_tiled2d"] = dict(txs=txs, tys=tys)
    return out


def _app(n: int) -> dict:
    from gsmpm_tpu_torch.apps.simulate import simulate
    from gsmpm_tpu_torch.config import MPMConfig, RenderConfig, SimConfig

    cfg = SimConfig()
    cfg.mpm = MPMConfig(
        material="jelly", E=2e4, nu=0.3, n_grid=16, grid_extent=2.0,
        substep_dt=2e-4, frame_dt=2e-3, density=300.0,
        gravity=[0.0, 0.0, -9.8], sim_area=[[-10, -10, -10], [10, 10, 10]])
    stats = {}
    with tempfile.TemporaryDirectory() as td:
        cfg.render = RenderConfig(output_path=td, num_frames=1)
        frames = simulate(cfg, synthetic=16 * n, frames=1, quiet=True,
                          synthetic_res=32, device="cpu", stats=stats,
                          mesh=f"data={n}")
    _check(len(frames) == 2 and np.isfinite(frames[-1]).all(), "app")
    return dict(engine=stats["engine"])


def _rank(rank: int, world: int, port: int, out: str) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", rank=rank, world_size=world)
    try:
        from gsmpm_tpu_torch.parallel.mesh import make_mesh

        res = {"fit_step": _fit_step(world)}
        mesh = make_mesh((("data", world),), "cpu")
        res["tiled"] = _tiled_frame(mesh)
        res.update(_halo_frames(mesh))
        res["app"] = _app(world)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, timeout_s: float = 300.0) -> dict:
    """Run every parallel/ engine once on n_devices spawned gloo ranks;
    raises if a rank fails or any is still running after timeout_s."""
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "rank0.pkl")
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        procs = [ctx.Process(target=_rank, args=(r, n_devices, port, out))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        if hung or any(p.exitcode for p in procs):
            raise RuntimeError(
                f"dry run on {n_devices} ranks: exit codes "
                f"{[p.exitcode for p in procs]} ({len(hung)} killed after "
                f"{timeout_s} s)")
        with open(out, "rb") as f:
            return pickle.load(f)
