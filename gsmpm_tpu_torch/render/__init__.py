"""Port of gsmpm_tpu.render (see the package docstring)."""

from gsmpm_tpu_torch.render.camera import (
    Camera,
    focal2fov,
    fov2focal,
    projection_matrix,
    world_to_view,
    make_camera,
)
from gsmpm_tpu_torch.render.renderer import render, RasterConfig
