"""Default server aggregator: counterpart of ``fedml_tpu/ml/aggregator.py``
(reference ``ml/aggregator/default_aggregator.py``). One class covers
classification/nwp/prediction: evaluation dispatches on the labels' shape
(local_sgd.make_eval_fn).

The aggregator evaluates its own state dict through the shared module
(``FedModel.apply``), so it never writes into the module the client trainer
trains. It keeps a reference to the state dict it is given: the round's
global, which nothing writes after the fold made it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.alg_frame.server_aggregator import ServerAggregator
from ..data.dataset import ArrayDataset
from ..models.model_hub import FedModel
from .trainer.local_sgd import evaluate, make_eval_fn


class DefaultServerAggregator(ServerAggregator):
    def __init__(self, model: FedModel, args: Any):
        super().__init__(model, args)
        self._eval_batch = make_eval_fn(model)
        self.params: Dict[str, torch.Tensor] = model.params

    def get_model_params(self):
        return self.params

    def set_model_params(self, model_parameters) -> None:
        self.params = model_parameters

    def test(self, test_data: ArrayDataset, device=None, args: Any = None):
        args = args or self.args
        if test_data is None:
            return {"test_loss": 0.0, "test_acc": 0.0, "test_total": 0.0, "test_correct": 0.0}
        return evaluate(self._eval_batch, self.params, test_data,
                        int(getattr(args, "batch_size", 32)), self.model.device)


def create_server_aggregator(model: FedModel, args: Any) -> DefaultServerAggregator:
    return DefaultServerAggregator(model, args)
