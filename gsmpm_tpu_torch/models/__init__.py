"""Port of gsmpm_tpu.models (see the package docstring)."""
