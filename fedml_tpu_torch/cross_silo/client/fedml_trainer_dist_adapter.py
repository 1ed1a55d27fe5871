"""Trainer adapter: the counterpart of
``fedml_tpu/cross_silo/client/fedml_trainer_dist_adapter.py``.

Reference: ``cross_silo/client/fedml_trainer_dist_adapter.py:9`` — in the
reference this wraps the model in DDP for intra-silo parallelism; the JAX
package re-jits the local round over a device mesh for the hierarchical
scenario. The port trains each silo on one device: the hierarchical scenario
raises NotImplementedError (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Any, Optional

from ...constants import CROSS_SILO_SCENARIO_HIERARCHICAL
from ...ml.trainer.trainer_creator import create_model_trainer
from .fedml_trainer import FedMLTrainer


class TrainerDistAdapter:
    def __init__(
        self,
        args: Any,
        device,
        client_rank: int,
        model,
        train_data_num,
        train_data_local_num_dict,
        train_data_local_dict,
        test_data_local_dict,
        model_trainer=None,
    ):
        if str(getattr(args, "scenario", "horizontal")) == CROSS_SILO_SCENARIO_HIERARCHICAL:
            raise NotImplementedError(
                "scenario 'hierarchical': intra-silo data parallelism is not ported to "
                "fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")
        self.args = args
        self.device = device
        self.client_rank = client_rank
        client_index = client_rank - 1
        if model_trainer is None:
            model_trainer = create_model_trainer(model, args)
        model_trainer.set_id(client_index)
        self.trainer = FedMLTrainer(
            client_index,
            train_data_local_dict,
            train_data_local_num_dict,
            test_data_local_dict,
            train_data_num,
            device,
            args,
            model_trainer,
        )

    def train(self, round_idx: Optional[int] = None):
        return self.trainer.train(round_idx)

    def update_model(self, model_params) -> None:
        self.trainer.update_model(model_params)

    def update_dataset(self, client_index: Optional[int] = None) -> None:
        self.trainer.update_dataset(int(client_index if client_index is not None else self.trainer.client_index))
