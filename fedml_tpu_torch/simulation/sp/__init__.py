"""The single-process simulator (counterpart of ``fedml_tpu/simulation/sp``)."""
