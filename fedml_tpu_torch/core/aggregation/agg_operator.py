"""Federated aggregation rules: counterpart of
``fedml_tpu/core/aggregation/agg_operator.py``.

``raw_grad_list`` is a list of ``(sample_num, state dict)`` pairs, one per
client. The sample-weighted optimizers (FedAvg, FedProx, FedOpt, ...) fold
through the bucketed engine. FedNova's and SCAFFOLD's structured payloads
need their trainers (``ml/trainer/fed_trainers.py`` in the JAX package),
which are not ported: they raise (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

from ...constants import (
    FEDML_FEDERATED_OPTIMIZER_ASYNC_FEDAVG,
    FEDML_FEDERATED_OPTIMIZER_FEDAVG,
    FEDML_FEDERATED_OPTIMIZER_FEDAVG_SEQ,
    FEDML_FEDERATED_OPTIMIZER_FEDDYN,
    FEDML_FEDERATED_OPTIMIZER_FEDOPT,
    FEDML_FEDERATED_OPTIMIZER_FEDPROX,
    FEDML_FEDERATED_OPTIMIZER_HIERACHICAL_FL,
    FEDML_FEDERATED_OPTIMIZER_MIME,
    FEDML_FEDERATED_OPTIMIZER_TURBO_AGGREGATE,
)
from ...utils.pytree import StateDict, weighted_average

SAMPLE_WEIGHTED = {
    FEDML_FEDERATED_OPTIMIZER_FEDAVG,
    FEDML_FEDERATED_OPTIMIZER_FEDAVG_SEQ,
    FEDML_FEDERATED_OPTIMIZER_FEDPROX,
    FEDML_FEDERATED_OPTIMIZER_FEDOPT,
    FEDML_FEDERATED_OPTIMIZER_FEDDYN,
    FEDML_FEDERATED_OPTIMIZER_MIME,
    FEDML_FEDERATED_OPTIMIZER_HIERACHICAL_FL,
    FEDML_FEDERATED_OPTIMIZER_TURBO_AGGREGATE,
    FEDML_FEDERATED_OPTIMIZER_ASYNC_FEDAVG,
}


def fedavg(raw_grad_list: Sequence[Tuple[float, StateDict]]) -> StateDict:
    """w = sum_k (n_k / n) * w_k: the sample-count weighted average."""
    return weighted_average(raw_grad_list)


def uniform_average(trees: Sequence[StateDict]) -> StateDict:
    return weighted_average([(1.0, t) for t in trees])


class FedMLAggOperator:
    """Dispatch table mirroring the JAX package's ``FedMLAggOperator.agg``."""

    @staticmethod
    def agg(args: Any, raw_grad_list: List[Tuple[float, Any]]) -> Any:
        fed_opt = getattr(args, "federated_optimizer", FEDML_FEDERATED_OPTIMIZER_FEDAVG)
        if fed_opt in SAMPLE_WEIGHTED:
            return fedavg(raw_grad_list)
        raise NotImplementedError(
            f"federated_optimizer {fed_opt!r}: only the sample-weighted rules are ported "
            "to fedml_tpu_torch (see ROADMAP.md, Queue 1)")
