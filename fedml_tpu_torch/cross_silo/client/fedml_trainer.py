"""Client-side trainer wrapper for cross-silo rounds: a copy of
``fedml_tpu/cross_silo/client/fedml_trainer.py``.

Reference: ``cross_silo/client/fedml_trainer.py:8`` (FedMLTrainer): holds
the local datasets, swaps the active silo's shard per round, runs the
alg-frame hook sandwich around local training.
"""

from __future__ import annotations

import logging
from typing import Any, Optional, Tuple

log = logging.getLogger(__name__)


class FedMLTrainer:
    def __init__(
        self,
        client_index: int,
        train_data_local_dict,
        train_data_local_num_dict,
        test_data_local_dict,
        train_data_num,
        device,
        args: Any,
        model_trainer,
    ):
        self.trainer = model_trainer
        self.client_index = client_index
        self.train_data_local_dict = train_data_local_dict
        self.train_data_local_num_dict = train_data_local_num_dict
        self.test_data_local_dict = test_data_local_dict
        self.all_train_data_num = train_data_num
        self.train_local = None
        self.local_sample_number = None
        self.test_local = None
        self.device = device
        self.args = args

    def update_model(self, weights) -> None:
        self.trainer.set_model_params(weights)

    def update_dataset(self, client_index: int) -> None:
        self.client_index = client_index
        self.train_local = self.train_data_local_dict[client_index]
        self.local_sample_number = self.train_data_local_num_dict[client_index]
        self.test_local = self.test_data_local_dict[client_index]
        self.trainer.set_id(client_index)
        self.trainer.update_dataset(self.train_local, self.test_local, self.local_sample_number)

    def train(self, round_idx: Optional[int] = None) -> Tuple[Any, int]:
        self.args.round_idx = round_idx
        data = self.trainer.on_before_local_training(self.train_local, self.device, self.args)
        self.trainer.train(data, self.device, self.args)
        self.trainer.on_after_local_training(data, self.device, self.args)
        weights = self.trainer.get_model_params()
        return weights, self.local_sample_number

    def test(self):
        return self.trainer.test(self.test_local, self.device, self.args)
