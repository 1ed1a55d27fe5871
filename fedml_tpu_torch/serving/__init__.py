"""Model serving (counterpart of ``fedml_tpu/serving``).

Ported: the predictors, the slot and paged continuous-batching engines, the
paged KV allocator and admission control. The HTTP front (inference
runner, endpoints, replica controller) and weight-only int8 decode wait for
later slices (ROADMAP.md, Queue 1).
"""

from .admission import AdmissionController, AdmissionError, TenantPolicy
from .continuous_batching import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from .fedml_predictor import FedMLPredictor, LLMPredictor, TorchPredictor
from .paged_kv import PagedKVAllocator

__all__ = [
    "AdmissionController",
    "AdmissionError",
    "TenantPolicy",
    "ContinuousBatchingEngine",
    "PagedContinuousBatchingEngine",
    "FedMLPredictor",
    "LLMPredictor",
    "TorchPredictor",
    "PagedKVAllocator",
]
