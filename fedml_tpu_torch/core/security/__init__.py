"""Attacks and defenses (the trust middleware's security half): counterpart
of ``fedml_tpu/core/security``."""
