"""Port of gsmpm_tpu.render (see the package docstring)."""
