"""Client contribution assessment: counterpart of
``fedml_tpu/core/contribution/contribution_assessor_manager.py`` (reference
core/contribution/contribution_assessor_manager.py:9, gtg_shapley_value.py,
leave_one_out.py).

Each sampled client is valued by how much its update moves the folded
model's metric. A subset's model is the same weighted average the round's
fold uses (the bucketed engine, on the state dicts' device); the
valuations are host numpy, GTG's permutations from JAX's seed.
"""

from __future__ import annotations

import itertools
import logging
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...utils.pytree import StateDict, weighted_average
from ..alg_frame.context import Context

EXACT_SHAPLEY_MAX_CLIENTS = 12


def leave_one_out(model_list: Sequence[Tuple[float, StateDict]],
                  metric_fn: Callable[[StateDict], float]) -> List[float]:
    """v_i = metric(all) - metric(all without i) (reference leave_one_out.py)."""
    full = metric_fn(weighted_average(model_list))
    return [full - metric_fn(weighted_average([m for j, m in enumerate(model_list) if j != i]))
            for i in range(len(model_list))]


def gtg_shapley(model_list: Sequence[Tuple[float, StateDict]],
                metric_fn: Callable[[StateDict], float], last_round_metric: float = 0.0, *,
                eps: float = 1e-3, max_perms: Optional[int] = None, seed: int = 0) -> List[float]:
    """Guided-truncation-gradient Shapley (Liu et al. 2022; reference
    gtg_shapley_value.py): Monte Carlo over permutations, truncated within
    one once the marginal contribution falls below ``eps``."""
    k = len(model_list)
    rng = np.random.default_rng(seed)
    max_perms = max_perms or min(2 * k, 20)
    phi = np.zeros(k)
    full_metric = metric_fn(weighted_average(model_list))
    counts = np.zeros(k)
    for _ in range(max_perms):
        perm = rng.permutation(k)
        prev = last_round_metric
        subset: List[Tuple[float, StateDict]] = []
        for idx in perm:
            if abs(full_metric - prev) < eps:
                counts[idx] += 1  # truncated: the remaining marginals are about 0
                continue
            subset.append(model_list[idx])
            cur = metric_fn(weighted_average(subset))
            phi[idx] += cur - prev
            counts[idx] += 1
            prev = cur
    counts = np.maximum(counts, 1)
    return list(phi / counts)


def exact_shapley(model_list: Sequence[Tuple[float, StateDict]],
                  metric_fn: Callable[[StateDict], float],
                  empty_metric: float = 0.0) -> List[float]:
    """The exact Shapley value over all 2^K subsets (reference
    mr_shapley_value.py's per-round value; Song et al. 2019)."""
    k = len(model_list)
    v: Dict[frozenset, float] = {frozenset(): empty_metric}
    for r in range(1, k + 1):
        for subset in itertools.combinations(range(k), r):
            v[frozenset(subset)] = metric_fn(weighted_average([model_list[i] for i in subset]))
    phi = [0.0] * k
    for i in range(k):
        others = [j for j in range(k) if j != i]
        for r in range(k):
            w = math.factorial(r) * math.factorial(k - r - 1) / math.factorial(k)
            for subset in itertools.combinations(others, r):
                s = frozenset(subset)
                phi[i] += w * (v[s | {i}] - v[s])
    return phi


def multi_round_shapley(per_round_values: Sequence[Dict[Any, float]],
                        mode: str = "sum") -> Dict[Any, float]:
    """Per-round values merged into one valuation per client id (reference
    mr_shapley_value.py): 'sum' adds the rounds; 'last_round_weighted'
    weighs round r of n by 2(r+1)/(n(n+1))."""
    if not per_round_values:
        return {}
    n = len(per_round_values)
    if mode == "sum":
        weights = [1.0] * n
    elif mode == "last_round_weighted":
        weights = [2.0 * (r + 1) / (n * (n + 1)) for r in range(n)]
    else:
        raise ValueError(f"unknown multi-round mode {mode!r}")
    out: Dict[Any, float] = {}
    for w, round_vals in zip(weights, per_round_values):
        for cid, v in round_vals.items():
            out[cid] = out.get(cid, 0.0) + w * v
    return out


class ContributionAssessorManager:
    def __init__(self, args: Any):
        self.args = args
        self.metric = str(getattr(args, "contribution_alg", "")).lower()
        self._history: List[Dict[Any, float]] = []

    def is_enabled(self) -> bool:
        return bool(getattr(self.args, "enable_contribution", False))

    def run(self, model_list: Sequence[Tuple[float, StateDict]], model_aggregated: StateDict,
            metric_fn: Callable[[StateDict], float],
            last_round_metric: float = 0.0) -> Optional[List[float]]:
        if not self.is_enabled():
            return None
        if self.metric in ("loo", "leave_one_out"):
            vals = leave_one_out(model_list, metric_fn)
        elif self.metric in ("shapley", "mr_shapley", "multi_round"):
            if len(model_list) > EXACT_SHAPLEY_MAX_CLIENTS:
                # 2^K subset models: GTG's sampled permutations bound the work
                logging.warning("exact Shapley over %d clients is 2^%d subsets; using GTG",
                                len(model_list), len(model_list))
                vals = gtg_shapley(model_list, metric_fn, last_round_metric)
            else:
                vals = exact_shapley(model_list, metric_fn, last_round_metric)
        else:
            vals = gtg_shapley(model_list, metric_fn, last_round_metric)
        # keyed by client id (Context carries the round's ids), so rounds
        # that sample other clients never mix
        ids = Context().get("client_indexes_of_round")
        if ids is None or len(ids) != len(vals):
            ids = list(range(len(vals)))
        self._history.append({cid: v for cid, v in zip(ids, vals)})
        logging.info("contribution values: %s", self._history[-1])
        return vals

    def get_history(self) -> List[Dict[Any, float]]:
        """Per-round valuations keyed by client id."""
        return self._history

    def get_final_contribution(self, mode: str = "sum") -> Dict[Any, float]:
        """The valuation accumulated over rounds (reference mr_shapley_value.py)."""
        return multi_round_shapley(self._history, mode)
