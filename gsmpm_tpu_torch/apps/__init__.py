"""Port of gsmpm_tpu.apps (see the package docstring)."""
