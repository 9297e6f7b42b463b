"""Port of gsmpm_tpu.io (see the package docstring)."""
