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

The hooks keep their place in the round (poison before training; local DP
noise then FHE after), but local DP, attacks and FHE are not ported yet:
enabling any of them raises NotImplementedError (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import abc
from typing import Any

_HOOK_FLAGS = ("enable_dp", "enable_attack", "enable_fhe")


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
    def _check_hooks(self, args) -> None:
        if not self.enable_hooks:
            return
        on = [f for f in _HOOK_FLAGS if getattr(args, f, False)]
        if on:
            raise NotImplementedError(
                f"{', '.join(on)}: local DP, attack and FHE hooks are not ported "
                "to fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")

    def on_before_local_training(self, train_data, device, args) -> Any:
        """Data/model poisoning hooks (reference :37-43)."""
        self._check_hooks(args)
        return train_data

    @abc.abstractmethod
    def train(self, train_data, device, args) -> None:
        """Run local optimization; must leave updated params in the model."""

    def on_after_local_training(self, train_data, device, args) -> None:
        """Local DP noise then FHE encryption (reference :59-82)."""
        self._check_hooks(args)

    def test(self, test_data, device, args):  # pragma: no cover - optional
        return None
