"""Run apps.simulate of the PyTorch port (gsmpm_tpu_torch; no JAX) on one
GPU or on a mesh and record each run's engines, rates and exchange volume.

    python3 scripts/torch_mesh_engines.py --mesh none --out DIR/none
    python3 -m torch.distributed.run --standalone --nproc_per_node 4 \\
        scripts/torch_mesh_engines.py --mesh data=4[,engine=E] --out DIR/E
    python3 scripts/torch_mesh_engines.py --compare DIR

The scene is the bench's (chip_smoke.bench_config: a 245,760-gaussian box,
jelly, E 2e5, 100 substeps of 1e-4 s a frame) on an n_grid^3 grid
(default 100, the bench's secondary shape), rendered at 800^2.  Rank 0
writes <out>.json: the card (nvidia-smi name and power limit), the engine,
sim seconds and substeps/s of every frame, the bytes each rank sent through
the neighbour exchange (parallel/mesh.neighbor_ppermute's counter) per
substep, and the ring all-reduce volume per substep of the tiled and psum
engines' grids (analytic: 2 (N-1) / N times the grid's bytes); and
<out>.npz, the frames.  --compare prints every run's largest and mean
frame difference from DIR/none.npz.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

sys.path.insert(0, ".")

import numpy as np


def _card(device: str) -> str:
    if device == "cpu":
        return "cpu (no GPU)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def run(args) -> None:
    import torch
    import torch.distributed as dist

    from gsmpm_tpu_torch.apps.simulate import simulate
    from gsmpm_tpu_torch.config import MPMConfig, RenderConfig, SimConfig
    from gsmpm_tpu_torch.parallel import mesh as pmesh
    from gsmpm_tpu_torch.sim.tiles import _drop_group_graphs

    cfg = SimConfig(
        mpm=MPMConfig(E=2e5, nu=0.3, material="jelly", n_grid=args.n_grid,
                      grid_extent=2.0, substep_dt=1e-4, frame_dt=1e-2,
                      density=200.0),
        render=RenderConfig(output_path=args.out))
    stats = {}
    pmesh.neighbor_ppermute.bytes_sent = 0
    frames = simulate(cfg, synthetic=args.particles, frames=args.frames,
                      quiet=False, synthetic_res=args.res,
                      device=args.device, stats=stats, mesh=args.mesh)
    steps = stats["substeps_per_frame"]
    world, rank = 1, 0
    sent = [pmesh.neighbor_ppermute.bytes_sent]
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        sent = [None] * world
        dist.all_gather_object(sent, pmesh.neighbor_ppermute.bytes_sent)
        _drop_group_graphs()  # before the communicators they captured go
        dist.destroy_process_group()
    if rank:
        return
    T = -(-args.n_grid // 8) + 1
    ring = 2 * (world - 1) / world
    out = dict(
        card=_card(args.device), mesh=args.mesh, world=world,
        n_grid=args.n_grid, particles=args.particles, frames=args.frames,
        substeps_per_frame=steps,
        engine=stats["engine"], sim_s=stats["sim_s"],
        substeps_per_s=[steps / s for s in stats["sim_s"]],
        render_s=stats["render_s"],
        bytes_sent_per_substep=[b / (steps * args.frames) for b in sent],
        tiled_allreduce_bytes_per_substep=ring * T ** 3 * 32 * 64 * 4,
        psum_allreduce_bytes_per_substep=ring * 4 * args.n_grid ** 3 * 4,
        torch=torch.__version__)
    with open(args.out + ".json", "w") as f:
        json.dump(out, f, indent=1)
    np.savez_compressed(args.out + ".npz", frames=np.stack(frames))
    print("RESULT " + json.dumps(out), flush=True)


def compare(root: str) -> None:
    base = np.load(os.path.join(root, "none.npz"))["frames"]
    for path in sorted(glob.glob(os.path.join(root, "*.npz"))):
        name = os.path.basename(path)[:-4]
        got = np.load(path)["frames"]
        d = np.abs(got - base)
        print("COMPARE " + json.dumps(dict(
            run=name, max_diff=[float(x.max()) for x in d],
            mean_diff=[float(x.mean()) for x in d],
            pixels_over_1e2=[int((x.max(-1) > 1e-2).sum()) for x in d])),
            flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", type=str, default="none")
    ap.add_argument("--out", type=str, help="output path prefix")
    ap.add_argument("--compare", type=str, default=None,
                    help="directory of runs to hold against its none.npz")
    ap.add_argument("--particles", type=int, default=245760)
    ap.add_argument("--n_grid", type=int, default=100)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if args.compare:
        compare(args.compare)
    else:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        run(args)


if __name__ == "__main__":
    main()
