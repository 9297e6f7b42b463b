"""Port of gsmpm_tpu.ops (see the package docstring)."""

from gsmpm_tpu_torch.ops.svd3 import svd3x3, polar_rotation
from gsmpm_tpu_torch.ops.bspline import (
    quadratic_bspline_weights,
    SPLINE_OFFSETS,
)
