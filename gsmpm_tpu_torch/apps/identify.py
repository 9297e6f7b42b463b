"""Entry point: system identification, learn E and nu from video.

Port of gsmpm_tpu/apps/identify.py on one device.  Frame 0 of every
iteration refines the gaussians' appearance (Adam over the raw 3DGS
parameters); frames 1..N-1 backpropagate the photometric loss through
``substeps_per_frame`` differentiable MPM substeps and the render into
logE, y (clipped SGD).  Data comes from ``--data_path`` (observed
multi-camera frames, io/dataset.py) or, by default, from simulating the
scene at (--E_true, --nu_true) on a camera ring.

Runs on CUDA unless ``--device cpu`` is given; on the CPU the kernels'
plain twins run.

Under ``torchrun --nproc_per_node N`` (N > 1) ``--mesh auto`` (the
default) fits on N processes, one GPU each (NCCL; gloo with ``--device
cpu``), as the JAX app routes: camera-DP (parallel/sharded.py
``make_camera_dp_fit_step``: one observed camera per rank, every frame
trained against that many cameras, the loss their mean) when a
``--data_path`` dataset has at least 2 cameras, else the data x tile
sharded fit step (particles over the data axis, block rows over the tile
axis, tile = 2 when N is even).  Either update is the single-device one.
Rank 0 alone prints and writes metrics.csv.  ``--mesh none`` fits on one
device.

Usage:
    python -m gsmpm_tpu_torch.apps.identify --synthetic 2048 --iters 1 \
        --frames 3 --resolution 512 [--data_path DIR] [--device cpu]
    python -m torch.distributed.run --nproc_per_node 4 \
        -m gsmpm_tpu_torch.apps.identify --synthetic 2048 [--mesh auto]
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import random
import time
from typing import Optional

import numpy as np
import torch

from gsmpm_tpu_torch.config import MPMConfig
from gsmpm_tpu_torch.models.gaussians import GaussianScene
from gsmpm_tpu_torch.models.synthetic import synthetic_blob_scene
from gsmpm_tpu_torch.render.camera import make_camera
from gsmpm_tpu_torch.render.renderer import RasterConfig
from gsmpm_tpu_torch.sim.fitting import FitConfig, SystemIdentifier, cfl_dt_limit
from gsmpm_tpu_torch.sim.tiles import _drop_group_graphs
from gsmpm_tpu_torch.utils import resolve_device

MODEL_ROOT = "models_extra"
IMAGE_WH = 512
TRAIN_NUM_FRAMES = 20
TOTAL_ITERS = 300


def load_scene_and_velocity(scene_name: str, synthetic: Optional[int],
                            device="cuda"):
    model_path = os.path.join(MODEL_ROOT, scene_name)
    scene = None
    if not synthetic:
        ply = os.path.join(model_path, "static_gaussians", "point_cloud.ply")
        try:
            scene = GaussianScene.from_ply(ply, device=device)
        except (FileNotFoundError, ValueError):
            print(f"({ply} unavailable; using a synthetic blob scene)")
    if scene is None:
        scene = synthetic_blob_scene(n=synthetic or 2048, radius=0.4,
                                     center=(0.0, 0.8, 0.0), device=device)
    # thrown downward so it hits the sticky ground inside the training
    # window: free flight alone carries no stiffness signal
    v = [0.0, -2.0, 0.0]
    vel_path = os.path.join(model_path, "init_velocity.json")
    if os.path.exists(vel_path):
        with open(vel_path) as f:
            v = json.load(f)
    init_v = torch.tensor(v, dtype=torch.float32, device=device)[None, :] \
        .repeat(scene.num_gaussians, 1)
    return scene, init_v


def make_ring_cameras(scene, resolution: int):
    """A ring of 8 cameras around the scene (the synthetic-data stand-in
    for a dataset's camera.json)."""
    cameras = []
    center = scene.xyz.mean(dim=0).cpu().numpy()
    for az in range(0, 360, 45):
        a = np.deg2rad(az)
        pos = center + 3.0 * np.array([np.cos(a), 0.25, np.sin(a)])
        fwd = center - pos
        fwd = fwd / np.linalg.norm(fwd)
        down = np.array([0.0, -1.0, 0.0])
        y = down - np.dot(down, fwd) * fwd
        y = y / np.linalg.norm(y)
        x = np.cross(y, fwd)
        cameras.append(make_camera(resolution, resolution, 0.7, 0.7,
                                   np.column_stack([x, y, fwd]), pos))
    return cameras


def identify(args, stats: Optional[dict] = None):
    """Run the fit; returns the SystemIdentifier.  ``stats``, when a dict
    is given, receives per-frame rows (iteration, frame, loss, seconds
    ended by a device synchronize, n_dropped) and, under a mesh, the
    route ("sharded" | "camdp") and the mesh's axes."""
    dev = resolve_device(getattr(args, "device", "cuda"))
    dataset = None
    if args.data_path:
        from gsmpm_tpu_torch.io.dataset import load_observed_dataset

        dataset = load_observed_dataset(args.data_path, width=args.resolution,
                                        height=args.resolution,
                                        bg=np.ones(3, np.float32))

    # multi-device: camera-DP when multi-camera observations exist, else
    # the particle x pixel-row sharded fit step
    world = int(os.environ.get("WORLD_SIZE", 1))
    mesh, route = None, None
    if getattr(args, "mesh", "auto") != "none" and world > 1:
        from gsmpm_tpu_torch.parallel.engines import _largest_divisor_leq
        from gsmpm_tpu_torch.parallel.mesh import make_mesh

        n_cam = (_largest_divisor_leq(world, dataset.n_cameras)
                 if dataset is not None else 1)
        if n_cam >= 2:
            route = "camdp"
            mesh = make_mesh((("rep", world // n_cam), ("cam", n_cam)),
                             str(dev))
        else:
            route = "sharded"
            tile = 2 if world % 2 == 0 else 1
            mesh = make_mesh((("data", world // tile), ("tile", tile)),
                             str(dev))
        dev = mesh.device
        if stats is not None:
            stats.update(route=route, mesh=dict(zip(mesh.axis_names,
                                                    mesh.sizes)))
    rank0 = mesh is None or mesh.rank == 0
    with contextlib.ExitStack() as quiet:
        if not rank0:  # the ranks fit alike; rank 0 speaks for them
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        return _identify(args, stats, dev, dataset, mesh, route)


def _identify(args, stats, dev, dataset, mesh, route):
    rank0 = mesh is None or mesh.rank == 0
    if route == "camdp":
        print(f"mesh: camera-DP over {mesh.axis_size('cam')} ranks"
              + (f" x {mesh.axis_size('rep')} replicas"
                 if mesh.axis_size("rep") > 1 else ""))
    elif route == "sharded":
        print(f"mesh: data={mesh.axis_size('data')} x "
              f"tile={mesh.axis_size('tile')} sharded fit step")
    scene, init_v = load_scene_and_velocity(args.scene, args.synthetic, dev)

    # a single-material scene fits ONE (E, nu): per-particle SGD moves the
    # mean ~N times slower and cannot converge at this schedule
    if not args.tie_params and not getattr(args, "per_particle", False):
        args.tie_params = True
        print("note: fitting a single-material scene — using tied-scalar "
              "(E, nu) by default (per-particle SGD moves mean E ~N x slower "
              "and cannot converge at this schedule; pass --per_particle for "
              "reference learn() parity)")

    mpm_cfg = MPMConfig(material="jelly", E=args.E_init, nu=args.nu_init,
                        n_grid=50, grid_extent=2.0,
                        gravity=[0.0, -9.81, 0.0], fitting=True)
    fit_dt = FitConfig().frame_dt / FitConfig().substeps_per_frame
    E_max, nu_max = max(args.E_init, args.E_true), max(args.nu_init,
                                                       args.nu_true)
    dt_lim = cfl_dt_limit(E_max, nu_max, mpm_cfg.density,
                          mpm_cfg.grid_extent / mpm_cfg.n_grid)
    if fit_dt > dt_lim:
        print(f"WARNING: fitting dt {fit_dt:.2e} exceeds the CFL bound "
              f"{dt_lim:.2e} for E={E_max:g} at density "
              f"{mpm_cfg.density:g} — the forward sim will likely NaN and E "
              "will stay frozen (lower --E_init/--E_true)")

    rcfg = RasterConfig(block=64, k_block=min(512, scene.num_gaussians),
                        chunk=64)
    bg = torch.ones(3, device=dev)

    if dataset is not None:
        print(f"Loaded observations: {dataset.n_frames} frames x "
              f"{dataset.n_cameras} cameras from {args.data_path}")
        if dataset.physics:
            print(f"physical.json: {dataset.physics}")

    ident = SystemIdentifier(scene, mpm_cfg, init_velocity=init_v,
                             raster_cfg=rcfg,
                             fit_cfg=FitConfig(tie_params=args.tie_params),
                             bg=bg,
                             mesh=mesh if route == "sharded" else None)
    if dataset is not None:
        n_frames = min(args.frames, dataset.n_frames)
        cameras = dataset.cameras

        def gt_for(fid, cam_id):
            return torch.from_numpy(dataset.images[fid][cam_id]).to(dev)
    else:
        cameras = make_ring_cameras(scene, args.resolution)
        n_frames = args.frames
        print(f"Generating ground truth with E*={args.E_true:g}, "
              f"nu*={args.nu_true:g}")
        gt = ident.generate_ground_truth(args.E_true, args.nu_true, cameras,
                                         n_frames)
        if mesh is not None:
            from gsmpm_tpu_torch.parallel.mesh import broadcast_object

            # the caps a ground-truth resize chose, alike on every rank
            ident.raster_cfg = broadcast_object(ident.raster_cfg, mesh)

        def gt_for(fid, cam_id):
            return gt[fid]  # rendered with camera fid % len (one per frame)

    writer = log_file = tb = None
    if rank0:
        os.makedirs(args.output_path, exist_ok=True)
        log_file = open(os.path.join(args.output_path, "metrics.csv"), "w",
                        newline="")
        writer = csv.writer(log_file)
        writer.writerow(["iteration", "frame", "loss", "optimized_E",
                         "optimized_nu"])
    if rank0 and not os.environ.get("GSMPM_DISABLE_TB"):
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb = SummaryWriter(args.output_path)
        except ImportError:
            print("Tensorboard not available: not logging progress")

    opt = params = None
    if not args.no_appearance:
        opt, params = ident.make_appearance_optimizer()
    if stats is not None:
        stats.setdefault("frames", [])
    fit_camdp = (_camera_dp_fitter(ident, mesh, cameras, gt_for, bg)
                 if route == "camdp" else None)

    rng = random.Random(args.seed)
    for iteration in range(1, args.iters + 1):
        state = ident.reset_state()
        t = 0.0
        for fid in range(n_frames):
            cam_id = (rng.randrange(len(cameras)) if dataset is not None
                      else fid % len(cameras))
            t0 = time.perf_counter()
            if fid == 0:
                if args.no_appearance:
                    continue
                loss = ident.appearance_step(opt, params,
                                             camera=cameras[cam_id],
                                             gt_image=gt_for(0, cam_id))
                # appearance moved the gaussians: rebuild the sim state
                state = ident.reset_state()
            elif fit_camdp is not None:
                loss, state, t = fit_camdp(state, t, fid)
            else:
                loss, state, t, _ = ident.fit_frame(state, t, cameras[cam_id],
                                                    gt_for(fid, cam_id))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            E, nu = ident.optimized_E, ident.optimized_nu
            if writer is not None:
                writer.writerow([iteration, fid, float(loss), E, nu])
            step = iteration * (n_frames - 1) + fid
            if tb and fid > 0:
                tb.add_scalar("loss_total", float(loss), step)
                tb.add_scalar("optimized_E", E, step)
                tb.add_scalar("optimized_nu", nu, step)
            if stats is not None:
                stats["frames"].append(dict(
                    iteration=iteration, frame=fid, loss=float(loss), s=secs,
                    n_dropped=ident.n_dropped_last if fid else None))
            print(f"iter {iteration} frame {fid}: loss={float(loss):.5f} "
                  f"E={E:.4g} nu={nu:.4f} ({secs:.2f}s)", flush=True)
    if log_file is not None:
        log_file.close()
    print(f"Final: E={ident.optimized_E:.6g} nu={ident.optimized_nu:.4f}"
          + ("" if args.data_path else
             f" (true: {args.E_true:g}, {args.nu_true:g})"))
    return ident


def _camera_dp_fitter(ident: SystemIdentifier, mesh, cameras, gt_for, bg):
    """fit(state, t, fid) -> (loss, state, t): one camera-DP step per
    frame (parallel/sharded.make_camera_dp_fit_step) on the cam axis's
    cameras, rotated every frame so that every observed camera is used
    over the run, under the single-device policy for an engine overflow
    and for drops (SystemIdentifier._drop_free)."""
    from gsmpm_tpu_torch.parallel.sharded import (
        make_camera_dp_fit_step, stack_cameras,
    )

    n_cam = mesh.axis_size("cam")

    def fit(state, t, fid):
        fcfg = ident.fit_cfg
        sel = [((fid - 1) * n_cam + i) % len(cameras) for i in range(n_cam)]
        cams_b = stack_cameras([cameras[i] for i in sel])
        gts = torch.stack([gt_for(fid, i) for i in sel])
        opacity, features = ident._appearance()

        def attempt():
            step = make_camera_dp_fit_step(
                mesh, ident.model, ident.bcs, ident.grid, fcfg.frame_dt,
                fcfg.substeps_per_frame, bg, opacity, features,
                ident.scene.sh_degree, ident.scaling, ident.pos_center,
                ident.mpm_cfg.grid_extent, raster_cfg=ident.raster_cfg,
                lr_logE=fcfg.lr_logE, lr_y=fcfg.lr_y,
                grad_clip=fcfg.grad_clip, cam_axis="cam",
                tie_params=fcfg.tie_params, sim_engine=ident.sim_engine)
            out = step(ident.model.logE, ident.model.y, state, t, cams_b, gts)
            return out, out.sim_ok, out.n_dropped, out.state

        out = ident._drop_free(attempt, cameras[sel[0]], mesh)
        ident._set_params(out.logE, out.y)
        return out.loss, out.state, out.t

    return fit


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", type=str, default="torus")
    p.add_argument("--output_path", type=str,
                   default="outputs_extra/torus_debug")
    p.add_argument("--data_path", type=str, default=None,
                   help="directory of observed frames (camera.json layout)")
    p.add_argument("--synthetic", type=int, default=None)
    p.add_argument("--iters", type=int, default=TOTAL_ITERS)
    p.add_argument("--frames", type=int, default=TRAIN_NUM_FRAMES)
    p.add_argument("--resolution", type=int, default=IMAGE_WH)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_appearance", action="store_true",
                   help="skip the frame-0 appearance Adam refinement")
    p.add_argument("--tie_params", action="store_true",
                   help="fit one scalar (E, nu) shared by all particles "
                        "(the default; see --per_particle)")
    p.add_argument("--per_particle", action="store_true",
                   help="per-particle clipped SGD on logE, y (the "
                        "reference's learn()); mean E moves ~N x slower")
    p.add_argument("--E_true", type=float, default=1e5)
    p.add_argument("--nu_true", type=float, default=0.3)
    p.add_argument("--E_init", type=float, default=2e6)
    p.add_argument("--nu_init", type=float, default=0.4)
    p.add_argument("--mesh", type=str, default="auto",
                   choices=("auto", "none"),
                   help='"auto" | "none": under torchrun with N > 1 '
                        "processes, camera-DP over the observations when a "
                        "multi-camera dataset is loaded, else the particle x "
                        "tile sharded fit step")
    p.add_argument("--device", type=str, default="cuda",
                   help='"cuda" (default) or "cpu" (the plain twins)')
    return p


def main(argv=None):
    identify(build_parser().parse_args(argv))
    if torch.distributed.is_initialized():
        _drop_group_graphs()  # before the communicators they captured go
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
