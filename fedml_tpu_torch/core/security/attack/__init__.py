"""Attacks: counterpart of ``fedml_tpu/core/security/attack``."""
