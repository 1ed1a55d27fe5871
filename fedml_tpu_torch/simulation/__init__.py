"""Simulators (counterpart of ``fedml_tpu/simulation``): the sp front."""
