"""Homomorphic-encryption aggregation: counterpart of ``fedml_tpu/core/fhe``."""
