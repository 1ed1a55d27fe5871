"""Attacker facade: counterpart of ``fedml_tpu/core/security/fedml_attacker.py``
(reference core/security/fedml_attacker.py:14). A process-wide singleton
configured from ``args`` (``enable_attack``, ``attack_type``) by
``fedml_tpu_torch.init`` and queried from the alg-frame hooks."""

from __future__ import annotations

import logging
from typing import Any, List, Optional, Tuple

ATTACK_METHOD_BYZANTINE = "byzantine"
ATTACK_METHOD_LABEL_FLIP = "label_flipping"
ATTACK_METHOD_MODEL_REPLACEMENT = "model_replacement"
ATTACK_METHOD_LAZY_WORKER = "lazy_worker"
ATTACK_METHOD_DLG = "dlg"
ATTACK_METHOD_INVERT_GRADIENT = "invert_gradient"
ATTACK_METHOD_BACKDOOR = "backdoor"
ATTACK_METHOD_EDGE_CASE_BACKDOOR = "edge_case_backdoor"
ATTACK_METHOD_REVEAL_LABELS = "revealing_labels"

MODEL_ATTACKS = {ATTACK_METHOD_BYZANTINE, ATTACK_METHOD_MODEL_REPLACEMENT,
                 ATTACK_METHOD_LAZY_WORKER, ATTACK_METHOD_BACKDOOR}
DATA_ATTACKS = {ATTACK_METHOD_LABEL_FLIP, ATTACK_METHOD_EDGE_CASE_BACKDOOR}
RECONSTRUCT_ATTACKS = {ATTACK_METHOD_DLG, ATTACK_METHOD_INVERT_GRADIENT,
                       ATTACK_METHOD_REVEAL_LABELS}


def attack_type(args: Any) -> Optional[str]:
    """The attack ``args`` turns on, or None."""
    if not getattr(args, "enable_attack", False):
        return None
    return str(getattr(args, "attack_type", ATTACK_METHOD_BYZANTINE)).strip().lower()


class FedMLAttacker:
    _instance: Optional["FedMLAttacker"] = None

    @classmethod
    def get_instance(cls) -> "FedMLAttacker":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self) -> None:
        self.is_enabled = False
        self.attack_type = None
        self.attacker = None

    def init(self, args: Any) -> None:
        self.is_enabled = bool(getattr(args, "enable_attack", False))
        if not self.is_enabled:
            self.attack_type, self.attacker = None, None
            return
        self.attack_type = attack_type(args)
        from .attack import attacks, gradient_inversion

        table = {
            ATTACK_METHOD_BYZANTINE: attacks.ByzantineAttack,
            ATTACK_METHOD_LABEL_FLIP: attacks.LabelFlippingAttack,
            ATTACK_METHOD_MODEL_REPLACEMENT: attacks.ModelReplacementBackdoorAttack,
            ATTACK_METHOD_LAZY_WORKER: attacks.LazyWorkerAttack,
            ATTACK_METHOD_BACKDOOR: attacks.BackdoorAttack,
            ATTACK_METHOD_EDGE_CASE_BACKDOOR: attacks.EdgeCaseBackdoorAttack,
            ATTACK_METHOD_REVEAL_LABELS: gradient_inversion.RevealingLabelsFromGradientsAttack,
            ATTACK_METHOD_INVERT_GRADIENT: gradient_inversion.InvertGradientAttack,
            ATTACK_METHOD_DLG: gradient_inversion.DLGAttack,
        }
        if self.attack_type not in table:
            raise ValueError(f"unknown attack type {self.attack_type!r}")
        self.attacker = table[self.attack_type](args)
        logging.info("attack enabled: %s", self.attack_type)

    # --- predicates (the reference's names) -----------------------------------
    def is_model_attack(self) -> bool:
        return self.is_enabled and self.attack_type in MODEL_ATTACKS

    def is_data_poisoning_attack(self) -> bool:
        return self.is_enabled and self.attack_type in DATA_ATTACKS

    def is_reconstruct_data_attack(self) -> bool:
        return self.is_enabled and self.attack_type in RECONSTRUCT_ATTACKS

    def is_to_poison_data(self) -> bool:
        return self.is_enabled

    # --- dispatch ---------------------------------------------------------------
    def attack_model(self, raw_client_grad_list: List[Tuple[float, Any]],
                     extra_auxiliary_info: Any = None):
        return self.attacker.attack_model(raw_client_grad_list,
                                          extra_auxiliary_info=extra_auxiliary_info)

    def poison_data(self, dataset):
        return self.attacker.poison_data(dataset)

    def reconstruct_data(self, a_gradient, extra_auxiliary_info: Any = None):
        return self.attacker.reconstruct_data(a_gradient, extra_auxiliary_info=extra_auxiliary_info)
