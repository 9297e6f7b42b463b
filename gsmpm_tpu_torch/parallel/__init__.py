"""Multi-process parallelism with torch.distributed: the mesh, the sharded
simulation engines, the tile-sharded render and the multi-device fit steps
(port of gsmpm_tpu/parallel).

One process per GPU (``torchrun --nproc_per_node N``), NCCL on CUDA and
gloo on the CPU: particles are sharded over the ranks, and the MPM grid is
either all-reduced every substep (sharded.py, tiled_sharded.py) or owned
per rank in slabs or rectangles with halo strips exchanged between
neighbours (halo.py, halo_tiled.py, halo_tiled2d.py); engines.py picks
one in gsmpm_tpu's order.  The image's block rows are split over the
ranks; system identification runs the data x tile sharded fit step or
camera-DP, with the single-device gradient.  dryrun.py runs each once on
spawned CPU ranks.
"""

from gsmpm_tpu_torch.parallel.mesh import (
    Mesh,
    gather,
    make_mesh,
    pad_particles,
    shard,
    unpad,
)
from gsmpm_tpu_torch.parallel.sharded import (
    make_camera_dp_fit_step,
    make_sharded_fit_step,
    make_sharded_frame_fn,
    make_sharded_render_fn,
    stack_cameras,
)

__all__ = [
    "Mesh",
    "gather",
    "make_mesh",
    "pad_particles",
    "shard",
    "unpad",
    "make_camera_dp_fit_step",
    "make_sharded_fit_step",
    "make_sharded_frame_fn",
    "make_sharded_render_fn",
    "stack_cameras",
]
