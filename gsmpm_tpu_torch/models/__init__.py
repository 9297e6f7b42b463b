"""Port of gsmpm_tpu.models (see the package docstring)."""

from gsmpm_tpu_torch.models.gaussians import (
    GaussianScene,
    load_gaussians,
    search_for_max_iteration,
)
from gsmpm_tpu_torch.models.synthetic import (
    synthetic_blob_scene,
    synthetic_box_scene,
)
