"""Trainer factory: counterpart of ``fedml_tpu/ml/trainer/trainer_creator.py``
(reference ``ml/trainer/trainer_creator.py:13``).

FedAvg and FedOpt train with :class:`ClassificationTrainer`, FedProx with
:class:`FedProxTrainer` (the proximal term in the loss). FedNova, SCAFFOLD,
FedDyn and Mime need the JAX package's ``fed_trainers.py``, which is not
ported: they raise (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Any

from ...constants import (
    FEDML_FEDERATED_OPTIMIZER_FEDDYN,
    FEDML_FEDERATED_OPTIMIZER_FEDNOVA,
    FEDML_FEDERATED_OPTIMIZER_FEDPROX,
    FEDML_FEDERATED_OPTIMIZER_MIME,
    FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
)
from ...models.model_hub import FedModel
from .classification_trainer import ClassificationTrainer

NOT_PORTED = (FEDML_FEDERATED_OPTIMIZER_FEDNOVA, FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
              FEDML_FEDERATED_OPTIMIZER_FEDDYN, FEDML_FEDERATED_OPTIMIZER_MIME)


class FedProxTrainer(ClassificationTrainer):
    """mu is consumed inside the loss (local_sgd.make_local_train_fn)."""

    def __init__(self, model: FedModel, args: Any):
        if not getattr(args, "fedprox_mu", None):
            args.fedprox_mu = 0.1
        super().__init__(model, args)


def create_model_trainer(model: FedModel, args: Any) -> ClassificationTrainer:
    fed_opt = str(getattr(args, "federated_optimizer", "FedAvg"))
    if fed_opt in NOT_PORTED:
        raise NotImplementedError(
            f"federated_optimizer {fed_opt!r}: its client trainer (fed_trainers.py) is not "
            "ported to fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")
    if fed_opt == FEDML_FEDERATED_OPTIMIZER_FEDPROX:
        return FedProxTrainer(model, args)
    return ClassificationTrainer(model, args)
