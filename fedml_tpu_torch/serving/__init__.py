"""Model serving (counterpart of ``fedml_tpu/serving``).

Ported: the predictors, the slot and paged continuous-batching engines, the
paged KV allocator, admission control, weight-only int8 decode (``quant``),
and the HTTP front: the inference runner, endpoints, and the subprocess
replicas with their gateway and autoscaler (``replica_controller``,
``replica_main``, ``bench_predictors``). The JAX package's FastAPI app is
not ported (``fastapi`` is not installed where the port runs); the stdlib
runner serves the same routes.
"""

from .admission import AdmissionController, AdmissionError, TenantPolicy
from .continuous_batching import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from .endpoint import Endpoint, EndpointManager, ModelCard, ModelDB
from .fedml_inference_runner import FedMLInferenceRunner
from .fedml_predictor import FedMLPredictor, LLMPredictor, TorchPredictor
from .paged_kv import PagedKVAllocator
from .quant import dequantize_params_int8, quantize_model_int8, quantize_params_int8

__all__ = [
    "AdmissionController",
    "AdmissionError",
    "TenantPolicy",
    "ContinuousBatchingEngine",
    "PagedContinuousBatchingEngine",
    "Endpoint",
    "EndpointManager",
    "ModelCard",
    "ModelDB",
    "FedMLInferenceRunner",
    "FedMLPredictor",
    "LLMPredictor",
    "TorchPredictor",
    "PagedKVAllocator",
    "dequantize_params_int8",
    "quantize_model_int8",
    "quantize_params_int8",
]
