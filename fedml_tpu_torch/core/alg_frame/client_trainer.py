"""Abstract client trainer with privacy/security hooks.

Counterpart of ``fedml_tpu/core/alg_frame/client_trainer.py`` (reference
``python/fedml/core/alg_frame/client_trainer.py:8``). What
``get_model_params``/``set_model_params`` exchange is the trainer's own: the
FedAvg trainers (``ml/trainer``) pass state dicts of tensors that stay on
the trainer's device between clients, copied in and out (torch tensors are
mutable); the FedLLM client (``train/llm/fed_llm_trainer.py``) passes its
adapters as nested dicts of numpy arrays in the flax layout, the payload a
JAX peer takes. ``models/convert.py`` maps a state dict to the flax layout;
the FedAvg path needs it only in tests until the message plane is ported
(ROADMAP.md, Queue 1).

The hooks keep their place in the round (JAX ``client_trainer.py:63-101``):
before training the round's global model is kept as DP-Clip's anchor and a
data-poisoning attack may replace the data; after it the local DP frame
noises the update, then FHE encrypts it (``core/fhe``): the trainer's
parameters become a state dict of ciphertexts until the next
``set_model_params`` of tensors, as the JAX trainer's pytree does.
"""

from __future__ import annotations

import abc
from typing import Any


class ClientTrainer(abc.ABC):
    """Local trainer run inside each (simulated or real) client."""

    def __init__(self, model: Any, args: Any):
        self.model = model
        self.id = 0
        self.args = args
        self.local_train_dataset = None
        self.local_test_dataset = None
        self.local_sample_number = 0
        self.rid = 0
        self.template_model_params = None
        self.enable_hooks = not getattr(args, "disable_alg_frame_hooks", False)

    def set_id(self, trainer_id: int) -> None:
        self.id = trainer_id

    def is_main_process(self) -> bool:
        """Only rank 0 of a silo talks WAN (reference
        fedml_client_master_manager.py:67-70): the torch.distributed rank
        when a process group is up, else this process is rank 0."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return True

    def update_dataset(self, local_train_dataset, local_test_dataset, local_sample_number) -> None:
        self.local_train_dataset = local_train_dataset
        self.local_test_dataset = local_test_dataset
        self.local_sample_number = local_sample_number

    # --- abstract parameter plumbing ------------------------------------
    @abc.abstractmethod
    def get_model_params(self):
        """Return the trainable parameters (a copy the caller may keep)."""

    @abc.abstractmethod
    def set_model_params(self, model_parameters) -> None:
        """Install parameters received from the server."""

    # --- hook wiring (reference client_trainer.py:37-82) ----------------
    def on_before_local_training(self, train_data, device, args) -> Any:
        """Data poisoning (reference :37-43); keeps the round's global
        model as DP-Clip's anchor."""
        if not self.enable_hooks:
            return train_data
        from ..dp.fedml_differential_privacy import FedMLDifferentialPrivacy
        from ..security.fedml_attacker import FedMLAttacker

        if FedMLDifferentialPrivacy.get_instance().is_local_dp_enabled():
            self._dp_global_params = self.get_model_params()
        attacker = FedMLAttacker.get_instance()
        if attacker.is_data_poisoning_attack() and attacker.is_to_poison_data():
            return attacker.poison_data(train_data)
        return train_data

    @abc.abstractmethod
    def train(self, train_data, device, args) -> None:
        """Run local optimization; must leave updated params in the model."""

    def on_after_local_training(self, train_data, device, args) -> None:
        """Local DP noise, then FHE encryption (reference :59-82, JAX
        ``client_trainer.py:84-101``, the same order)."""
        if not self.enable_hooks:
            return
        from ..dp.fedml_differential_privacy import FedMLDifferentialPrivacy
        from ..fhe.fhe_agg import FedMLFHE
        from .context import Context

        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_local_dp_enabled():
            extra = {"global_model_params": getattr(self, "_dp_global_params", None),
                     "local_sample_num": self.local_sample_number or None}
            self.set_model_params(dp.add_local_noise(self.get_model_params(), extra))
        fhe = FedMLFHE.get_instance()
        if fhe.is_fhe_enabled():
            Context().add("fhe_encrypted", True)
            self.set_model_params(fhe.fhe_enc("local", self.get_model_params()))

    def test(self, test_data, device, args):  # pragma: no cover - optional
        return None
