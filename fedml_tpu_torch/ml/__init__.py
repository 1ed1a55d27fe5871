"""Client trainers and the default server aggregator (counterpart of
``fedml_tpu/ml``)."""
