"""Entry point: simulate a 3DGS scene as MPM particles and re-render it.

Port of gsmpm_tpu/apps/simulate.py on one device, taking the JAX app's TPU
route on every device: the tiled transfer engine (sim/tiles.py, kernels K1
and K2) and the drop-free stream renderer (render/stream_raster.py, kernel
K3).  Pipeline: load gaussians -> sim_area mask -> world2grid -> volumes ->
MPM substeps per frame -> cov = F Sigma0 F^T -> grid2world -> rasterize ->
PNG (+ mp4 when ffmpeg exists).

Runs on CUDA unless ``device="cpu"`` (``--device cpu``) is given; on the
CPU the kernels' plain twins run.  Not ported yet (ROADMAP queue A):
multi-device ``--mesh``, ``--checkpoint_interval`` / ``--resume``, and the
golden-engine fallback on occupied-tile-cap overflow, which raises here.

Usage:
    python -m gsmpm_tpu_torch.apps.simulate --config_path cfg.json \
        [--output_path out] [--synthetic N] [--frames K] [--device cpu]
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
from gsmpm_tpu_torch.io.cameras import load_cameras
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
from gsmpm_tpu_torch.sim.solver import postprocess
from gsmpm_tpu_torch.sim.state import GridConfig, init_model, init_state
from gsmpm_tpu_torch.sim.tiles import bootstrap, default_tile_config, frame_tiled
from gsmpm_tpu_torch.sim.volume import particle_volume
from gsmpm_tpu_torch.utils import resolve_device

_MAX_DROPFREE_REBUILDS = 6


def load_scene(cfg: SimConfig, synthetic: Optional[int],
               device) -> GaussianScene:
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

    def world_geometry(self, st):
        """Grid-space state -> world-space (means, 6-packed covs)."""
        w_xyz, w_cov = grid2world(st.x, st.cov, self.scaling, self.pos_center,
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


def simulate(cfg: SimConfig, synthetic: Optional[int] = None,
             frames: Optional[int] = None, quiet: bool = False,
             synthetic_res: int = 800, device: Optional[str] = "cuda",
             stats: Optional[dict] = None):
    """Simulate + render; returns the frames as (H, W, 3) float numpy arrays
    (frame 0 is the initial state).

    ``stats``, when a dict is given, receives per-frame host-clock times
    (``sim_s``, ``render_s``, each ended by a device synchronize), the
    per-frame ``n_dropped`` and ``substeps_per_frame``.
    """
    mpm = cfg.mpm
    if mpm.incremental_cov:
        raise NotImplementedError(
            "incremental_cov (the golden engine's incremental covariance "
            "update) is not ported yet (ROADMAP queue A item 3)"
        )
    t_start = time.time()
    su = prepare(cfg, synthetic, synthetic_res, device, quiet)
    dev = su.state.x.device
    scene, model, bcs, grid, tc = su.scene, su.model, su.bcs, su.grid, su.tc
    state = su.state
    n_steps = mpm.steps_per_frame
    # the drop-free sorted-segment stream rasterizer, as the JAX app
    rcfg = RasterConfig(stream=True)

    def do_render(st, R):
        """Render; if any candidate was over the tier budgets, measure the
        budgets at this frame's geometry, resize and re-render the SAME
        frame, so no frame is saved truncated."""
        nonlocal rcfg
        w_xyz, w_cov = su.world_geometry(st)
        shs = su.features
        if mpm.rotate_sh and R is not None:
            shs = rotate_sh(su.features, R.transpose(-1, -2), scene.sh_degree)
        for attempt in range(_MAX_DROPFREE_REBUILDS + 1):
            img, nd = render_with_aux(w_xyz, w_cov, su.opacity, shs,
                                      su.camera, su.bg, scene.sh_degree, rcfg)
            nd = int(nd)
            if nd == 0 or attempt == _MAX_DROPFREE_REBUILDS:
                return img, nd
            rcfg = bump_caps_for_dropfree(rcfg, w_xyz, w_cov, su.opacity,
                                          su.camera)
            if not quiet:
                print(f"render: {nd} candidates over the caps — resizing for "
                      "a drop-free frame and re-rendering (stream_g2/g3/g4 "
                      f"{rcfg.stream_g2}/{rcfg.stream_g3}/{rcfg.stream_g4})")

    out_dir = cfg.render.output_path or "outputs/run"
    images_dir = os.path.join(out_dir, "images")
    os.makedirs(images_dir, exist_ok=True)
    num_frames = frames if frames is not None else cfg.render.num_frames
    if stats is not None:
        stats.update(sim_s=[], render_s=[], n_dropped=[],
                     substeps_per_frame=n_steps)

    def emit(fid, st, R):
        t0 = time.perf_counter()
        img, nd = do_render(st, R)
        frame = img.cpu().numpy()
        if stats is not None:
            stats["render_s"].append(time.perf_counter() - t0)
            stats["n_dropped"].append(nd)
        if nd:
            print(f"WARNING: frame {fid}: {nd} candidates still dropped "
                  "after cap rebuilds")
        save_frame(frame, images_dir, fid)
        return frame

    frames_np = [emit(0, state, None)]
    ts = bootstrap(soa_from_state(state), model, grid, tc)
    t_sim = 0.0
    for fid in range(1, num_frames + 1):
        t0 = time.perf_counter()
        ts, soa, t_sim = frame_tiled(
            ts, soa_from_state(state), model, bcs, t_sim, n_steps, grid, tc,
            mpm.substep_dt,
        )
        if not bool(ts.ok):
            raise RuntimeError(
                f"frame {fid}: more occupied tiles than the tile cap "
                f"({tc.occ_cap}); simulate's fallback to the golden engine is "
                "not ported yet (ROADMAP queue A item 3)"
            )
        st = state_from_soa(soa)
        cov6, R = postprocess(st, rotate_sh=mpm.rotate_sh)
        state = dataclasses.replace(st, cov=cov6)
        _sync(dev)
        if stats is not None:
            stats["sim_s"].append(time.perf_counter() - t0)
        frames_np.append(emit(fid, state, R))

        if cfg.render.save_pcd and fid % cfg.render.save_pcd_interval == 0:
            w_xyz, _ = su.world_geometry(state)
            scene.with_xyz_at(su.sim_idx, w_xyz).save_ply(os.path.join(
                out_dir, "point_cloud", f"iteration_{fid}", "point_cloud.ply"
            ))
        if not quiet:
            print(f"frame {fid}/{num_frames}  {time.perf_counter() - t0:.2f}s",
                  flush=True)

    video_path = encode_video(images_dir, os.path.join(out_dir, "simulated"))
    if video_path and not quiet:
        print(f"wrote {video_path}")
    if not quiet:
        print(f"Done in {time.time() - t_start:.1f}s.")
    return frames_np


_NOT_PORTED = ("--mesh", "--checkpoint_interval", "--resume")


def main(argv=None):
    parser = argparse.ArgumentParser(add_help=True)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--synthetic", type=int, default=None,
                        help="run on a generated scene with N gaussians")
    parser.add_argument("--frames", type=int, default=None,
                        help="override render.num_frames")
    parser.add_argument("--synthetic_res", type=int, default=800,
                        help="render resolution for --synthetic scenes")
    parser.add_argument("--device", type=str, default="cuda",
                        help='"cuda" (default) or "cpu" (the plain twins)')
    args, remaining = parser.parse_known_args(argv)
    for flag in _NOT_PORTED:
        if any(a.split("=", 1)[0] == flag for a in remaining):
            parser.error(f"{flag} is not ported yet (ROADMAP queue A)")
    cfg = SimConfig.from_json(args.config_path).override_from_args(remaining)
    simulate(cfg, synthetic=args.synthetic, frames=args.frames,
             synthetic_res=args.synthetic_res, device=args.device)


if __name__ == "__main__":
    main()
