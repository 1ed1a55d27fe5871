"""Data partitioning (counterpart of ``fedml_tpu/core/data``)."""
