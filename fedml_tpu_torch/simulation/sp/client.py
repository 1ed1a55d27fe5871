"""Simulated client: counterpart of ``fedml_tpu/simulation/sp/client.py``
(reference ``simulation/sp/fedavg/client.py``)."""

from __future__ import annotations


class Client:
    def __init__(self, client_idx, local_training_data, local_test_data, local_sample_number,
                 args, device, model_trainer):
        self.client_idx = client_idx
        self.local_training_data = local_training_data
        self.local_test_data = local_test_data
        self.local_sample_number = local_sample_number
        self.args = args
        self.device = device
        self.model_trainer = model_trainer
        self.model_trainer.local_sample_number = local_sample_number

    def update_local_dataset(self, client_idx, local_training_data, local_test_data,
                             local_sample_number):
        self.client_idx = client_idx
        self.local_training_data = local_training_data
        self.local_test_data = local_test_data
        self.local_sample_number = local_sample_number
        self.model_trainer.set_id(client_idx)
        self.model_trainer.local_sample_number = local_sample_number

    def get_sample_number(self):
        return self.local_sample_number

    def train(self, w_global):
        """One local round; returns the updated weights, a copy (set global ->
        hooks -> train -> hooks -> get weights)."""
        self.model_trainer.set_model_params(w_global)
        train_data = self.model_trainer.on_before_local_training(
            self.local_training_data, self.device, self.args)
        self.model_trainer.train(train_data, self.device, self.args)
        self.model_trainer.on_after_local_training(train_data, self.device, self.args)
        return self.model_trainer.get_model_params()

    def local_test(self, b_use_test_dataset: bool):
        data = self.local_test_data if b_use_test_dataset else self.local_training_data
        return self.model_trainer.test(data, self.device, self.args)
