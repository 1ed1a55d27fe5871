"""Predictor factory for tests/test_torch_package.py — NOT a test.

A replica child (``python -m fedml_tpu_torch.serving.replica_main
--predictor tests._replica_probe:probe_predictor``) builds the endpoint
bench's tiny LLM predictor on the CPU and answers each request with a
decoded text and the jax or fedml_tpu modules loaded in the child by then.
Imports nothing but the port.
"""

import sys

from fedml_tpu_torch.serving.bench_predictors import llm_bench_predictor
from fedml_tpu_torch.serving.fedml_predictor import FedMLPredictor


class _Probe(FedMLPredictor):
    def __init__(self, inner):
        self._inner = inner

    def predict(self, request, *args, **kwargs):
        out = dict(self._inner.predict(request))
        out["foreign_modules"] = sorted(m for m in sys.modules
                                        if m.split(".")[0] in ("jax", "jaxlib", "fedml_tpu"))
        return out

    def ready(self) -> bool:
        return self._inner.ready()


def probe_predictor():
    return _Probe(llm_bench_predictor())
