"""Port of gsmpm_tpu.io (see the package docstring)."""

from gsmpm_tpu_torch.io.ply import (
    read_gaussian_ply,
    write_gaussian_ply,
    write_particle_ply,
    read_particle_ply,
)
from gsmpm_tpu_torch.io.cameras import load_cameras, Camera
