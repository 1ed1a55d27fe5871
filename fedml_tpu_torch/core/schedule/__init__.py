"""Sequential-training scheduling for FedAvg_seq: a copy of
``fedml_tpu/core/schedule``."""

from .runtime_estimate import linear_fit, t_sample_fit
from .seq_train_scheduler import SeqTrainScheduler

__all__ = ["linear_fit", "t_sample_fit", "SeqTrainScheduler"]
