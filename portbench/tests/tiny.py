"""Tiny sizes of each cell for the CPU tests: the cells' own files with
the scale cut (particles, grid, image, substeps, frames), the kernels'
plain twins in place of CUDA."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def config(name):
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def overrides(workload):
    """run_cell's overrides that cut ``workload`` to a CPU test's size."""
    if workload.startswith("lego_jelly."):
        sc = copy.deepcopy(config("lego_jelly")["sim_config"])
        # a steep gravity, so that a test's few short frames move the box
        # by a good part of a cell
        sc["mpm"].update(n_grid=16, frame_dt=0.003, gravity=[0.0, 0.0, -500.0])
        return dict(
            scene={"kind": "box", "gaussians": 2048, "lo": [-0.5, -0.5, 0.2],
                   "hi": [0.5, 0.5, 1.2], "sh_degree": 3},
            sim_config=sc,
            render={"resolution": 64, "fov": 0.8,
                    "orbit": [130.0, 10.0, 5.75], "block": 64},
            warmup_frames=2, check_within=1, check_steps=1, trace_steps=1)
    cfg = config("torus_sysid")
    # frames of 20 substeps of 3 ms and a fast throw: the blob meets the
    # ground in the first fit frame, so that the gradients carry signal
    fit = dict(cfg["fit"], resolution=64, frames=3, substeps=20,
               frame_dt=0.06, velocity=[0.0, -8.0, 0.0])
    return dict(
        scene={"kind": "blob", "gaussians": 1024, "radius": 0.4,
               "centre": [0.0, 0.8, 0.0], "sh_degree": 3},
        mpm=dict(cfg["mpm"], n_grid=16), fit=fit, warmup_iterations=1,
        check_within=2, check_steps=1, trace_steps=1, trace_from=1)
