"""Local SGD and the client trainers (counterpart of ``fedml_tpu/ml/trainer``)."""
