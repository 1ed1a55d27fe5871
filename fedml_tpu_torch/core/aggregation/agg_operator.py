"""Federated aggregation rules: counterpart of
``fedml_tpu/core/aggregation/agg_operator.py``.

``raw_grad_list`` is a list of ``(sample_num, state dict)`` pairs, one per
client. The sample-weighted optimizers (FedAvg, FedProx, FedOpt, ...) fold
through the bucketed engine. FedNova's and SCAFFOLD's entries carry the
structured payloads of their trainers (``ml/trainer/fed_trainers.py``),
documented per function.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np

from ...constants import (
    FEDML_FEDERATED_OPTIMIZER_ASYNC_FEDAVG,
    FEDML_FEDERATED_OPTIMIZER_FEDAVG,
    FEDML_FEDERATED_OPTIMIZER_FEDAVG_SEQ,
    FEDML_FEDERATED_OPTIMIZER_FEDDYN,
    FEDML_FEDERATED_OPTIMIZER_FEDNOVA,
    FEDML_FEDERATED_OPTIMIZER_FEDOPT,
    FEDML_FEDERATED_OPTIMIZER_FEDPROX,
    FEDML_FEDERATED_OPTIMIZER_HIERACHICAL_FL,
    FEDML_FEDERATED_OPTIMIZER_MIME,
    FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
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


def fednova_aggregate(
    w_global: StateDict,
    grad_list: Sequence[Tuple[float, Tuple[float, StateDict]]],
) -> StateDict:
    """FedNova (Wang et al. 2020) server rule.

    Each client k sends ``(n_k, (a_k, d_k))`` where ``d_k`` is its
    *normalized* cumulative gradient and ``a_k`` the local-step scaling
    (sum of optimizer coefficients). Server computes
    ``tau_eff = sum_k p_k a_k`` (in f32) and
    ``w <- w - tau_eff * sum_k p_k d_k``.
    """
    n_total = float(sum(n for n, _ in grad_list))
    p = np.asarray([n / n_total for n, _ in grad_list], dtype=np.float32)
    a = np.asarray([float(payload[0]) for _, payload in grad_list], dtype=np.float32)
    tau_eff = float(np.sum(p * a))
    # the bucketed engine normalizes the weights; sample counts carry p_k
    avg_d = weighted_average([(float(n), payload[1]) for n, payload in grad_list])
    return {k: w - tau_eff * avg_d[k] for k, w in w_global.items()}


def scaffold_aggregate(
    w_global: StateDict,
    c_global: StateDict,
    grad_list: Sequence[Tuple[float, Tuple[StateDict, StateDict]]],
    total_clients: int,
    server_lr: float = 1.0,
) -> Tuple[StateDict, StateDict]:
    """SCAFFOLD (Karimireddy et al. 2020) server rule.

    Each sampled client sends ``(n_k, (delta_w_k, delta_c_k))``. Server:
    ``w <- w + eta_g * mean(delta_w)``;
    ``c <- c + (|S|/N) * mean(delta_c)``.
    """
    n = len(grad_list)
    dw = uniform_average([payload[0] for _, payload in grad_list])
    dc = uniform_average([payload[1] for _, payload in grad_list])
    new_w = {k: w + server_lr * dw[k] for k, w in w_global.items()}
    frac = n / float(total_clients)
    new_c = {k: c + frac * dc[k] for k, c in c_global.items()}
    return new_w, new_c


class FedMLAggOperator:
    """Dispatch table mirroring the JAX package's ``FedMLAggOperator.agg``."""

    @staticmethod
    def agg(args: Any, raw_grad_list: List[Tuple[float, Any]]) -> Any:
        fed_opt = getattr(args, "federated_optimizer", FEDML_FEDERATED_OPTIMIZER_FEDAVG)
        if fed_opt in SAMPLE_WEIGHTED:
            return fedavg(raw_grad_list)
        if fed_opt == FEDML_FEDERATED_OPTIMIZER_FEDNOVA:
            return fednova_aggregate(args.fednova_w_global, raw_grad_list)
        if fed_opt == FEDML_FEDERATED_OPTIMIZER_SCAFFOLD:
            # callers use scaffold_aggregate directly for the (w, c) pair;
            # generic path averages the delta_w payloads uniformly.
            return uniform_average([payload[0] for _, payload in raw_grad_list])
        raise ValueError(f"unknown federated optimizer {fed_opt!r}")
