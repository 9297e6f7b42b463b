"""Port of gsmpm_tpu.sim (see the package docstring)."""
