"""Generic classification/nwp client trainer: counterpart of
``fedml_tpu/ml/trainer/classification_trainer.py`` (reference
``ml/trainer/my_model_trainer_classification.py``).

JAX arrays are immutable and torch tensors are not, so the parameter
plumbing copies where the JAX package could share:

- ``set_model_params`` copies the global state dict into the module's own
  parameters. Were the module to hold the global's tensors, local SGD would
  move the global in place, and the round's later clients would start from
  moved weights.
- ``get_model_params`` returns a copy. Were it the module's tensors, every
  client's ``w_local`` would be the one module, and the fold would return
  the last client.

The parameters stay on the trainer's device between clients. A state dict
of object leaves (FHE ciphertexts, set by the encryption hook) is kept as it
is and handed back by ``get_model_params`` until the next state dict of
tensors, as the JAX trainer's pytree would be.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np
import torch

from ...core.alg_frame.client_trainer import ClientTrainer
from ...data.dataset import ArrayDataset
from ...models.model_hub import FedModel
from ...utils.pytree import tree_clone
from .local_sgd import epoch_index_array, evaluate, make_eval_fn, make_local_train_fn

log = logging.getLogger(__name__)


def round_seed(args: Any, client_id: int, fallback_round: int) -> int:
    """Deterministic per-(client, round) local-training seed, the JAX
    package's: ``args.round_idx`` when set (the cross-silo trainer sets it
    per round), else the trainer's own round counter (the sp simulator)."""
    r = getattr(args, "round_idx", None)
    rnd = int(r) if r is not None else int(fallback_round)
    return int(getattr(args, "random_seed", 0)) * 100003 + int(client_id) * 131 + rnd


class ClassificationTrainer(ClientTrainer):
    def __init__(self, model: FedModel, args: Any):
        super().__init__(model, args)
        self.device = model.device
        self._local_train = make_local_train_fn(model, args)
        self._eval_batch = make_eval_fn(model)
        self._round = 0
        self._sealed = None  # a state dict of ciphertexts, after the FHE hook
        self.last_loss = float("nan")
        self.last_steps = 0
        if model.params is not None:
            self.set_model_params(model.params)

    # --- params ----------------------------------------------------------
    def get_model_params(self) -> Dict[str, torch.Tensor]:
        if self._sealed is not None:
            return dict(self._sealed)
        return tree_clone(dict(self.model.module.named_parameters()))

    @torch.no_grad()
    def set_model_params(self, model_parameters) -> None:
        if not all(isinstance(v, torch.Tensor) for v in model_parameters.values()):
            self._sealed = dict(model_parameters)
            return
        self._sealed = None
        for k, p in self.model.module.named_parameters():
            p.copy_(model_parameters[k])

    # --- training --------------------------------------------------------
    def train(self, train_data: ArrayDataset, device=None, args: Any = None) -> None:
        self._local_round(train_data, args or self.args)

    def _local_round(self, train_data: ArrayDataset, args: Any, extras: Any = None) -> None:
        """One local round from the weights the module holds, over this
        client's (client, round)-seeded shuffles; ``extras`` goes to the
        local loop's gradient transform (fed_trainers.py)."""
        batch_size = int(getattr(args, "batch_size", 32))
        epochs = int(getattr(args, "epochs", 1))
        seed = round_seed(args, self.id, self._round)
        idx, mask = epoch_index_array(len(train_data), batch_size, epochs, seed)
        x_all = torch.from_numpy(np.ascontiguousarray(train_data.x)).to(self.device)
        y_all = torch.from_numpy(np.ascontiguousarray(train_data.y)).to(self.device)
        rng = torch.Generator(device=self.device).manual_seed(seed)
        result = self._local_train(x_all, y_all, idx, mask, rng, extras)
        self._round += 1
        # one read of the device per local round, as the JAX trainer's log does
        self.last_loss = float(result.loss)
        self.last_steps = result.num_steps
        log.debug("client %s local loss %.4f (%d steps)", self.id, self.last_loss, self.last_steps)

    # --- evaluation -------------------------------------------------------
    def test(self, test_data: ArrayDataset, device=None, args: Any = None):
        args = args or self.args
        return evaluate(self._eval_batch, None, test_data, int(getattr(args, "batch_size", 32)),
                        self.device)
