"""Entry point: simulate a 3DGS scene as MPM particles and re-render it.

Port of gsmpm_tpu/apps/simulate.py.  Pipeline: load gaussians -> sim_area
mask -> world2grid -> volumes -> MPM substeps per frame -> cov = F Sigma0
F^T -> grid2world -> rasterize -> PNG -> video (an mp4 when ffmpeg exists,
else an MJPEG AVI from the native IO tier, io/_native.py).

On one device it takes the JAX app's TPU route on every device: the tiled
transfer engine (sim/tiles.py, kernels K1 and K2) and the drop-free stream
renderer (render/stream_raster.py, kernel K3).  As in the JAX app, a frame
whose occupied tiles overflow the tile cap (at bootstrap or mid-frame) is
redone from its start state on the golden engine (sim/solver.py), which
then runs the rest of the simulation, and ``incremental_cov`` takes the
golden engine throughout; the switch is announced.

``--mesh data=N`` (under ``torchrun --nproc_per_node N``) shards the
particles over N processes, one GPU each (parallel/), with the engine
picked in gsmpm_tpu's order or named by ``engine=``: ``halo_tiled`` /
``halo_tiled2d`` (slabs or rectangles of tiles owned per rank, K1 / K2 on
each rank's particles, boundary slabs exchanged with the neighbours),
``tiled`` (K1 / K2 on each rank's chunks, the grid all-reduced), ``halo``
(cell slabs, the golden engine per rank) or ``psum`` (the golden engine
per shard, the grid all-reduced); the render is tile-sharded (kernel K4).
Rank 0 writes the images, point clouds, video and checkpoints.

``--checkpoint_interval K`` saves the full state (state, material model,
clock; unpadded) every K frames under <output_path>/checkpoints, and
``--resume`` continues from the latest one, under any mesh.

Runs on CUDA unless ``device="cpu"`` (``--device cpu``) is given; on the
CPU the kernels' plain twins run.

Usage:
    python -m gsmpm_tpu_torch.apps.simulate --config_path cfg.json \
        [--output_path out] [--synthetic N] [--frames K] [--device cpu] \
        [--checkpoint_interval K] [--resume] [--mesh none|data=N[,engine=E]]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from gsmpm_tpu_torch.config import SimConfig
from gsmpm_tpu_torch.io import _native
from gsmpm_tpu_torch.io.cameras import load_cameras
from gsmpm_tpu_torch.io.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from gsmpm_tpu_torch.io.video import encode_video, save_frame
from gsmpm_tpu_torch.models.gaussians import GaussianScene, load_gaussians
from gsmpm_tpu_torch.models.synthetic import synthetic_box_scene
from gsmpm_tpu_torch.render.camera import make_camera, orbit_camera
from gsmpm_tpu_torch.render.renderer import (
    RasterConfig,
    bump_caps_for_dropfree,
    render_with_aux,
)
from gsmpm_tpu_torch.render.sh import rotate_sh
from gsmpm_tpu_torch.sim.boundary import (
    BCSet,
    build_boundary_conditions,
    make_surface_collider,
)
from gsmpm_tpu_torch.sim.coupling import (
    apply_cov_rotations,
    apply_inverse_cov_rotations,
    apply_inverse_rotations,
    apply_rotations,
    get_center_view_worldspace_and_observant_coordinate,
    grid2world,
    rotation_matrices,
    world2grid,
)
from gsmpm_tpu_torch.sim.kernels import soa_from_state, state_from_soa
from gsmpm_tpu_torch.sim.solver import postprocess, run_substeps
from gsmpm_tpu_torch.sim.state import GridConfig, init_model, init_state
from gsmpm_tpu_torch.sim.tiles import (
    _drop_group_graphs,
    bootstrap,
    default_tile_config,
    frame_tiled,
)
from gsmpm_tpu_torch.sim.volume import particle_volume
from gsmpm_tpu_torch.utils import resolve_device
from gsmpm_tpu_torch.utils.spans import span

_MAX_DROPFREE_REBUILDS = 6


def load_scene(cfg: SimConfig, synthetic: Optional[int],
               device="cuda") -> GaussianScene:
    if synthetic:
        return synthetic_box_scene(n=synthetic, lo=(-0.5, -0.5, 0.2),
                                   hi=(0.5, 0.5, 1.2), device=device)
    try:
        return load_gaussians(cfg.model.model_path, cfg.model.loaded_iter,
                              device=device)
    except FileNotFoundError as e:
        raise SystemExit(
            f"Could not load {cfg.model.model_path}: {e}\n"
            "(pass --synthetic N to run on a generated scene)"
        )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class SimSetup:
    """Everything the frame loop needs, built once per run."""

    scene: GaussianScene
    sim_idx: torch.Tensor
    mats: list
    scaling: torch.Tensor
    pos_center: torch.Tensor
    camera: object
    state: object
    model: object
    bcs: BCSet
    grid: GridConfig
    tc: object
    bg: torch.Tensor
    opacity: torch.Tensor
    features: torch.Tensor
    grid_extent: float

    def world(self, x, cov):
        """Grid-space means and 6-packed covs -> world space."""
        with span("render.world"):
            w_xyz, w_cov = grid2world(x, cov, self.scaling, self.pos_center,
                                      self.grid_extent)
            return (apply_inverse_rotations(w_xyz, self.mats),
                    apply_inverse_cov_rotations(w_cov, self.mats))


def prepare(cfg: SimConfig, synthetic: Optional[int] = None,
            synthetic_res: int = 800, device: Optional[str] = "cuda",
            quiet: bool = False) -> SimSetup:
    """Load the scene, map it to the grid, and build the camera, the solver
    state, the material model and the boundary conditions."""
    dev = resolve_device(device)
    mpm = cfg.mpm
    scene = load_scene(cfg, synthetic, dev)

    # rotation pre-transform (identity by default)
    if any(d != 0 for d in mpm.rotation_degree):
        mats = rotation_matrices(
            list(mpm.rotation_degree)[: len(mpm.rotation_axis)],
            list(mpm.rotation_axis), dev,
        )
    else:
        mats = rotation_matrices([0.0], [0], dev)
    rotated_xyz = apply_rotations(scene.xyz, mats)

    # sim_area mask
    area = torch.tensor(np.asarray(mpm.sim_area, np.float32), device=dev)
    sim_mask = torch.all((rotated_xyz >= area[0]) & (rotated_xyz <= area[1]),
                         dim=1)
    sim_idx = torch.nonzero(sim_mask).squeeze(1)
    n_sim = int(sim_idx.shape[0])
    if not quiet:
        print(f"Number of simulatable Gaussians: {n_sim} / "
              f"{scene.num_gaussians}")

    sim_means = rotated_xyz[sim_idx]
    sim_covs = apply_cov_rotations(scene.get_covariance()[sim_idx], mats)
    g_xyz, pos_center, scaling = world2grid(sim_means, mpm.grid_extent)
    g_cov = sim_covs * (scaling * scaling)

    # camera: orbit re-aim with azimuth 130, elevation 10, radius 5.75
    # around the grid center (the reference's modify_cam)
    center_w, obs = get_center_view_worldspace_and_observant_coordinate(
        np.array([0.5, 0.5, 0.5], np.float32),
        np.array([0.0, 0.0, 1.0], np.float32),
        mats, scaling, pos_center, mpm.grid_extent,
    )
    if synthetic:
        template = make_camera(synthetic_res, synthetic_res, 0.8, 0.8,
                               np.eye(3), np.zeros(3))
    else:
        template = load_cameras(cfg.model.model_path)[0]
    camera = orbit_camera(template, 130.0, 10.0, 5.75, center_w, obs)

    # volumes + solver state
    vol = particle_volume(g_xyz, mpm.n_grid, mpm.grid_extent)
    model = init_model(mpm, n_sim, dev)
    state = init_state(g_xyz, g_cov, vol, mpm)
    bcs, state, model = build_boundary_conditions(
        mpm.boundary_conditions, mpm, state, model
    )
    # unconditional ground collider at z=0.4 (the reference's quirk)
    bcs = BCSet(
        particle_ops=bcs.particle_ops,
        grid_ops=bcs.grid_ops + (
            make_surface_collider((0, 0, 0.4), (0, 0, 1), device=dev),),
    )
    bg = (torch.ones(3, device=dev) if cfg.render.white_background
          else torch.zeros(3, device=dev))
    return SimSetup(
        scene=scene, sim_idx=sim_idx, mats=mats, scaling=scaling,
        pos_center=pos_center, camera=camera, state=state, model=model,
        bcs=bcs, grid=GridConfig(mpm.n_grid, mpm.grid_extent),
        tc=default_tile_config(mpm.n_grid, n_sim), bg=bg,
        opacity=scene.get_opacity()[sim_idx].reshape(-1),
        features=scene.get_features()[sim_idx],
        grid_extent=mpm.grid_extent,
    )


def parse_mesh(mesh: Optional[str]):
    """--mesh auto | none | data=N[,engine=halo|halo_tiled|halo_tiled2d|
    tiled|psum] -> (N, engine or None).  ``auto`` is the torchrun world
    size (1 outside torchrun); N > 1 must equal it."""
    from gsmpm_tpu_torch.parallel.engines import ENGINES

    world = int(os.environ.get("WORLD_SIZE", 1))
    ndata, prefer = world, None
    for part in (mesh or "auto").lower().split(","):
        part = part.strip()
        if part.startswith("data="):
            ndata = int(part.split("=", 1)[1])
        elif part.startswith("engine="):
            prefer = part.split("=", 1)[1]
        elif part == "none":
            ndata = 1
        elif part not in ("auto", ""):
            raise ValueError(f"unknown --mesh component: {part!r}")
    if prefer is not None and prefer not in ENGINES:
        raise ValueError(f"unknown --mesh engine: {prefer!r}")
    if ndata > 1 and ndata != world:
        raise ValueError(f"--mesh data={ndata} needs {ndata} processes "
                         f"(torchrun --nproc_per_node {ndata}); this run has "
                         f"{world}")
    return ndata, prefer


def simulate(cfg: SimConfig, synthetic: Optional[int] = None,
             frames: Optional[int] = None, quiet: bool = False,
             checkpoint_interval: int = 0, resume: bool = False,
             mesh: Optional[str] = "auto", synthetic_res: int = 800,
             device: Optional[str] = "cuda", stats: Optional[dict] = None):
    """Simulate + render; returns the frames as (H, W, 3) float numpy arrays
    (the first is the initial or resumed state), on every rank.

    ``stats``, when a dict is given, receives per-frame host-clock times
    (``sim_s``, ``render_s``, each ended by a device synchronize), the
    per-frame ``n_dropped``, the engine of each simulated frame
    (``engine``: "tiled" | "golden", or the mesh engine's "tiled" |
    "psum"), ``substeps_per_frame`` and, on rank 0, the video written
    (``video``: its path or None, ``video_writer``) and the native IO
    tier's ``status()`` (``native_io``).
    """
    mpm = cfg.mpm
    t_start = time.time()
    ndata, prefer = parse_mesh(mesh)
    use_mesh = ndata > 1
    mesh_obj = None
    if use_mesh:
        from gsmpm_tpu_torch.parallel.mesh import make_mesh

        mesh_obj = make_mesh((("data", ndata),), device)
        device = mesh_obj.device
    rank0 = mesh_obj is None or mesh_obj.rank == 0
    quiet = quiet or not rank0
    su = prepare(cfg, synthetic, synthetic_res, device, quiet)
    dev = su.state.x.device
    scene, model, bcs, grid = su.scene, su.model, su.bcs, su.grid
    tc = su.tc
    state, opacity, features = su.state, su.opacity, su.features
    n_steps = mpm.steps_per_frame
    n_unpadded = state.x.shape[0]

    out_dir = cfg.render.output_path or "outputs/run"
    images_dir = os.path.join(out_dir, "images")
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    if rank0:
        os.makedirs(images_dir, exist_ok=True)
    num_frames = frames if frames is not None else cfg.render.num_frames
    if stats is not None:
        stats.update(sim_s=[], render_s=[], n_dropped=[], engine=[],
                     substeps_per_frame=n_steps)

    # full-state resume: state, material model and clock, unpadded
    t_sim, start_frame = 0.0, 1
    if resume and latest_step(ckpt_dir) is not None:
        (state, model, t_sim), fid0, _ = restore_checkpoint(
            ckpt_dir, (state, model, t_sim))
        start_frame = fid0 + 1
        if not quiet:
            print(f"resumed from checkpoint at frame {fid0}")

    if use_mesh:
        from gsmpm_tpu_torch.parallel.engines import (
            MeshSimEngine, make_mesh_render_fn,
        )
        from gsmpm_tpu_torch.parallel.mesh import (
            gather, pad_particles, shard, unpad,
        )

        state, model, extras, _ = pad_particles(
            state, model, ndata, {"opacity": opacity, "features": features})
        state, model, extras = shard((state, model, extras), mesh_obj)
        opacity, features = extras["opacity"], extras["features"]
        engine = MeshSimEngine(
            mesh_obj, bcs=bcs, grid=grid, substep_dt=mpm.substep_dt,
            n_steps=n_steps, incremental_cov=mpm.incremental_cov,
            rotate_sh=mpm.rotate_sh, prefer=prefer, quiet=quiet, state=state)
        if not quiet:
            print(f"mesh: data={ndata}, sim engine: {engine.engine}, "
                  "render: tile-sharded")

        def full(tree):
            """The unpadded full arrays of this rank's shards."""
            return unpad(gather(tree, mesh_obj), n_unpadded)
    else:
        engine = "golden" if mpm.incremental_cov else "tiled"

        def full(tree):
            return tree

    def splats(x, cov, R, opac, feats):
        """Grid-space particles -> world-space splats (the inverse
        transforms, SH rotated by R when rotate_sh)."""
        w_xyz, w_cov = su.world(x, cov)
        shs = feats
        if mpm.rotate_sh and R is not None:
            shs = rotate_sh(feats, R.transpose(-1, -2), scene.sh_degree)
        return w_xyz, w_cov, opac, shs

    # drop-free rendering: the stream rasterizer on one device; the
    # tile-sharded two-stage selection (k_row / k_block caps) on a mesh
    rcfg = RasterConfig(stream=not use_mesh)

    def render_fn(rc):
        if use_mesh:
            return make_mesh_render_fn(mesh_obj, camera=su.camera, bg=su.bg,
                                       sh_degree=scene.sh_degree, rcfg=rc,
                                       transform_fn=splats)
        return lambda *a: render_with_aux(*splats(*a), su.camera, su.bg,
                                          scene.sh_degree, rc)

    render_frame = render_fn(rcfg)

    def do_render(st, R):
        """Render; if any candidate was over the caps, measure the caps at
        this frame's geometry, resize and re-render the SAME frame, so no
        frame is saved truncated."""
        nonlocal rcfg, render_frame
        for attempt in range(_MAX_DROPFREE_REBUILDS + 1):
            img, nd = render_frame(st.x, st.cov, R, opacity, features)
            nd = int(nd)
            if nd == 0 or attempt == _MAX_DROPFREE_REBUILDS:
                return img, nd
            w_xyz, w_cov, opac, _ = splats(*full((st.x, st.cov)), None,
                                           full(opacity), None)
            rcfg = bump_caps_for_dropfree(rcfg, w_xyz, w_cov, opac, su.camera)
            render_frame = render_fn(rcfg)
            if not quiet:
                print(f"render: {nd} candidates over the caps — resizing for "
                      "a drop-free frame and re-rendering (stream_g2/g3/g4 "
                      f"{rcfg.stream_g2}/{rcfg.stream_g3}/{rcfg.stream_g4}, "
                      f"k_row {rcfg.k_row}, k_block {rcfg.k_block})")

    def emit(fid, st, R):
        with span("app.render", clock=True) as rendered:
            img, nd = do_render(st, R)
            frame = img.cpu().numpy()
        if stats is not None:
            stats["render_s"].append(rendered.seconds)
            stats["n_dropped"].append(nd)
        if nd and not quiet:
            print(f"WARNING: frame {fid}: {nd} candidates still dropped "
                  "after cap rebuilds")
        if rank0:
            save_frame(frame, images_dir, fid)
        return frame

    def golden_frame(st, t):
        st, t = run_substeps(st, model, bcs, t, n_steps, grid,
                             mpm.substep_dt, checkpoint_policy=None,
                             incremental_cov=mpm.incremental_cov)
        cov6, R = postprocess(st, rotate_sh=mpm.rotate_sh)
        return dataclasses.replace(st, cov=cov6), t, R

    def tiled_frame(st, t, ts):
        """(ts, state, t, R), or None on a tile-cap overflow."""
        if ts is None:
            ts = bootstrap(soa_from_state(st), model, grid, tc)
            if not bool(ts.ok):
                return None
        ts, soa, t = frame_tiled(ts, soa_from_state(st), model, bcs, t,
                                 n_steps, grid, tc, mpm.substep_dt)
        if not bool(ts.ok):
            return None
        st = state_from_soa(soa)
        cov6, R = postprocess(st, rotate_sh=mpm.rotate_sh)
        return ts, dataclasses.replace(st, cov=cov6), t, R

    frames_np = [emit(start_frame - 1, state, None)]
    ts = None  # the tiled engine's persistent state, bootstrapped lazily
    for fid in range(start_frame, num_frames + 1):
        with span("app.frame", clock=True) as whole:
            with span("sim.frame", clock=True,
                      request=True) as simulated:
                if use_mesh:
                    state, t_sim, R = engine.frame(state, model, t_sim)
                else:
                    out = (tiled_frame(state, t_sim, ts) if engine == "tiled"
                           else None)
                    if out is not None:
                        ts, state, t_sim, R = out
                    else:
                        if engine == "tiled" and not quiet:
                            print(f"frame {fid}: more occupied tiles than "
                                  f"the tile cap ({tc.occ_cap}); redoing the "
                                  "frame on the golden engine, which runs "
                                  "from here on", flush=True)
                        engine = "golden"
                        state, t_sim, R = golden_frame(state, t_sim)
                _sync(dev)
            sim_s = simulated.seconds
            if stats is not None:
                stats["sim_s"].append(sim_s)
                stats["engine"].append(engine.engine if use_mesh else engine)
            frames_np.append(emit(fid, state, R))

            if checkpoint_interval and fid % checkpoint_interval == 0:
                st_u, md_u = full((state, model))
                if rank0:
                    save_checkpoint(ckpt_dir, fid, (st_u, md_u, t_sim),
                                    extra={"frame": fid})
            if (cfg.render.save_pcd
                    and fid % cfg.render.save_pcd_interval == 0):
                w_xyz, _ = su.world(*full((state.x, state.cov)))
                if rank0:
                    scene.with_xyz_at(su.sim_idx, w_xyz).save_ply(
                        os.path.join(out_dir, "point_cloud",
                                     f"iteration_{fid}", "point_cloud.ply"))
        if not quiet:
            print(f"frame {fid}/{num_frames}  {whole.seconds:.2f}s "
                  f"(sim {sim_s:.3f}s, {n_steps / sim_s:.2f} substeps/s)",
                  flush=True)

    if rank0:
        video_path = encode_video(images_dir,
                                  os.path.join(out_dir, "simulated"))
        writer = {".mp4": "ffmpeg H.264", ".avi": "native MJPEG-AVI"}.get(
            os.path.splitext(video_path or "")[1], "none")
        native = _native.status()
        if stats is not None:
            stats.update(video=video_path, video_writer=writer,
                         native_io=native)
        if not quiet:
            print(f"io: video {video_path or '(not written)'} (writer "
                  f"{writer}); PLY codec "
                  f"{'native C++' if native == 'loaded' else 'numpy'} "
                  f"(native IO tier: {native})")
    if not quiet:
        print(f"Done in {time.time() - t_start:.1f}s.")
    return frames_np


def main(argv=None):
    parser = argparse.ArgumentParser(add_help=True)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--synthetic", type=int, default=None,
                        help="run on a generated scene with N gaussians")
    parser.add_argument("--frames", type=int, default=None,
                        help="override render.num_frames")
    parser.add_argument("--checkpoint_interval", type=int, default=0,
                        help="save full sim state every N frames")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in output_path")
    parser.add_argument("--mesh", type=str, default="auto",
                        help='"auto" | "none" | "data=N[,engine=halo|'
                             'halo_tiled|halo_tiled2d|tiled|psum]": shard '
                             "the particles over N processes (torchrun "
                             "--nproc_per_node N); auto is the torchrun "
                             "world size; without engine= the engine is "
                             "picked in gsmpm_tpu's order")
    parser.add_argument("--synthetic_res", type=int, default=800,
                        help="render resolution for --synthetic scenes")
    parser.add_argument("--device", type=str, default="cuda",
                        help='"cuda" (default) or "cpu" (the plain twins)')
    args, remaining = parser.parse_known_args(argv)
    try:
        parse_mesh(args.mesh)
    except ValueError as e:
        parser.error(str(e))
    cfg = SimConfig.from_json(args.config_path).override_from_args(remaining)
    simulate(cfg, synthetic=args.synthetic, frames=args.frames,
             synthetic_res=args.synthetic_res, device=args.device,
             checkpoint_interval=args.checkpoint_interval,
             resume=args.resume, mesh=args.mesh)
    if torch.distributed.is_initialized():
        _drop_group_graphs()  # before the communicators they captured go
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
