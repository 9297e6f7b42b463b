"""Write an observed multi-camera dataset of apps.identify's synthetic scene
with the PyTorch port (gsmpm_tpu_torch; no JAX).

The scene is the one ``apps.identify --synthetic N`` fits (the blob thrown
down at 2 m/s), simulated at known (E*, nu*) by
``SystemIdentifier.generate_ground_truth`` once per camera, each camera one
of identify's ring cameras; the frames are written in the layout that
io/dataset.py loads (camera.json with K and an OpenGL c2w, frame.json,
physical.json, <camera>/NNN.png), so that ``apps.identify --data_path``
fits against them, on a mesh by camera-DP.

    python scripts/torch_observed_dataset.py --out DIR [--particles 245760] \
        [--res 512] [--frames 5] [--cams 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, ".")

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--particles", type=int, default=245760)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--cams", type=int, default=4,
                    help="ring cameras, evenly spaced (a divisor of 8)")
    ap.add_argument("--E_true", type=float, default=3e3)
    ap.add_argument("--nu_true", type=float, default=0.3)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from gsmpm_tpu_torch.apps.identify import (
        load_scene_and_velocity, make_ring_cameras,
    )
    from gsmpm_tpu_torch.config import MPMConfig
    from gsmpm_tpu_torch.io.video import encode_png, to8b
    from gsmpm_tpu_torch.render.renderer import RasterConfig
    from gsmpm_tpu_torch.sim.fitting import FitConfig, SystemIdentifier
    from gsmpm_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    scene, init_v = load_scene_and_velocity("torus", args.particles, dev)
    # apps.identify's configuration; the ground truth sets E* and nu*
    ident = SystemIdentifier(
        scene, MPMConfig(material="jelly", E=args.E_true, nu=args.nu_true,
                         n_grid=50, grid_extent=2.0,
                         gravity=[0.0, -9.81, 0.0], fitting=True),
        init_velocity=init_v, fit_cfg=FitConfig(),
        raster_cfg=RasterConfig(block=64, k_block=min(512, args.particles),
                                chunk=64),
        bg=torch.ones(3, device=dev))
    ring = make_ring_cameras(scene, args.res)
    cams = ring[::len(ring) // args.cams][:args.cams]

    os.makedirs(args.out, exist_ok=True)
    defs = []
    for i, cam in enumerate(cams):
        f = cam.width / (2.0 * np.tan(0.5 * cam.fovx))
        c2w = np.linalg.inv(cam.view.astype(np.float64))
        c2w[:3, 1:3] *= -1  # the loader's OpenGL convention
        defs.append({"camera": f"cam{i}",
                     "K": [[f, 0.0, cam.width / 2], [0.0, f, cam.height / 2],
                           [0.0, 0.0, 1.0]],
                     "c2w": c2w.tolist()})
        frames = ident.generate_ground_truth(args.E_true, args.nu_true, [cam],
                                             args.frames)
        os.makedirs(os.path.join(args.out, f"cam{i}"), exist_ok=True)
        for fid, img in enumerate(frames):
            rgb = to8b(img.clamp(0.0, 1.0).cpu().numpy())
            rgba = np.concatenate(
                [rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
            with open(os.path.join(args.out, f"cam{i}", f"{fid:03d}.png"),
                      "wb") as fh:
                fh.write(encode_png(rgba))
        print(f"cam{i}: {args.frames} frames", flush=True)
    fdt = FitConfig().frame_dt
    with open(os.path.join(args.out, "camera.json"), "w") as fh:
        json.dump(defs, fh)
    with open(os.path.join(args.out, "frame.json"), "w") as fh:
        json.dump([{f"{i:03d}": fdt * i} for i in range(args.frames)], fh)
    with open(os.path.join(args.out, "physical.json"), "w") as fh:
        json.dump({"E": args.E_true, "nu": args.nu_true}, fh)
    print(f"wrote {len(cams)} cameras x {args.frames} frames to {args.out}")


if __name__ == "__main__":
    main()
