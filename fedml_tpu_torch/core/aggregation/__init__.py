"""Aggregation: the bucketed fold, the FedAvg rules and the FedOpt server
(counterpart of ``fedml_tpu/core/aggregation``)."""
