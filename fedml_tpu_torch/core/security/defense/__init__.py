"""Defenses: counterpart of ``fedml_tpu/core/security/defense``."""
