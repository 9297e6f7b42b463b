"""Multi-process parallelism with torch.distributed: the mesh, the sharded
simulation engines, the tile-sharded render and the multi-device fit steps
(port of gsmpm_tpu/parallel).

One process per GPU (``torchrun --nproc_per_node N``), NCCL on CUDA and
gloo on the CPU: particles are sharded over the ranks, the MPM grid is
all-reduced every substep and the image's block rows are split over the
ranks; system identification runs the data x tile sharded fit step or
camera-DP, with the single-device gradient.  The halo engines are not
ported yet.
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
