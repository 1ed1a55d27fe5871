"""See the package docstring of fedml_tpu_torch."""
