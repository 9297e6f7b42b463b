"""Port of gsmpm_tpu.ops (see the package docstring)."""
