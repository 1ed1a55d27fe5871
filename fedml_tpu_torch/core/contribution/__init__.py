"""Client contribution assessment: counterpart of
``fedml_tpu/core/contribution``."""
