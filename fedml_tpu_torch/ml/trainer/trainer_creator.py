"""Trainer factory: counterpart of ``fedml_tpu/ml/trainer/trainer_creator.py``
(reference ``ml/trainer/trainer_creator.py:13``): FedProx, FedNova, SCAFFOLD,
FedDyn and Mime train with their trainers in ``fed_trainers.py``, every other
optimizer with :class:`ClassificationTrainer`.
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
from .fed_trainers import (
    FedDynTrainer,
    FedNovaTrainer,
    FedProxTrainer,
    MimeTrainer,
    ScaffoldTrainer,
)


def create_model_trainer(model: FedModel, args: Any) -> ClassificationTrainer:
    fed_opt = str(getattr(args, "federated_optimizer", "FedAvg"))
    table = {
        FEDML_FEDERATED_OPTIMIZER_FEDPROX: FedProxTrainer,
        FEDML_FEDERATED_OPTIMIZER_FEDNOVA: FedNovaTrainer,
        FEDML_FEDERATED_OPTIMIZER_SCAFFOLD: ScaffoldTrainer,
        FEDML_FEDERATED_OPTIMIZER_FEDDYN: FedDynTrainer,
        FEDML_FEDERATED_OPTIMIZER_MIME: MimeTrainer,
    }
    cls = table.get(fed_opt, ClassificationTrainer)
    return cls(model, args)
