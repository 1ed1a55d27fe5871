"""Renyi-DP accountant for the subsampled Gaussian mechanism: a copy of
``fedml_tpu/core/dp/budget_accountant/rdp_accountant.py``.

Reference: ``python/fedml/core/dp/budget_accountant/rdp_accountant.py``
(itself the standard moments-accountant recipe from Mironov 2017 / Abadi et
al. 2016). Implemented from the math, numpy-only: RDP orders are tracked per
round and converted to (epsilon, delta).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

import numpy as np

DEFAULT_ORDERS: List[float] = [1 + x / 10.0 for x in range(1, 100)] + list(range(12, 64))


def _log_add(a: float, b: float) -> float:
    if a == -np.inf:
        return b
    if b == -np.inf:
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(min(a, b) - m))


def _compute_log_a_int(q: float, sigma: float, alpha: int) -> float:
    """log A_alpha for integer alpha via the binomial expansion."""
    log_a = -np.inf
    for i in range(alpha + 1):
        log_coef = (
            math.lgamma(alpha + 1)
            - math.lgamma(i + 1)
            - math.lgamma(alpha - i + 1)
            + i * math.log(q)
            + (alpha - i) * math.log(1 - q)
        )
        s = log_coef + (i * i - i) / (2.0 * sigma**2)
        log_a = _log_add(log_a, s)
    return log_a


def compute_rdp(q: float, noise_multiplier: float, steps: int, orders: Sequence[float]) -> np.ndarray:
    """RDP of `steps` compositions of the sampled Gaussian mechanism."""
    if noise_multiplier == 0:
        return np.full(len(orders), np.inf)
    rdp = []
    for alpha in orders:
        if q == 1.0:
            r = alpha / (2.0 * noise_multiplier**2)
        elif float(alpha).is_integer():
            r = _compute_log_a_int(q, noise_multiplier, int(alpha)) / (alpha - 1)
        else:
            # conservative bound: use ceil(alpha)
            a = int(math.ceil(alpha))
            r = _compute_log_a_int(q, noise_multiplier, a) / (a - 1)
        rdp.append(r)
    return np.asarray(rdp) * steps


def get_privacy_spent(
    orders: Sequence[float], rdp: np.ndarray, target_delta: float
) -> Tuple[float, float]:
    """Convert accumulated RDP to (epsilon, best_order) at target_delta."""
    orders_v = np.atleast_1d(np.asarray(orders, dtype=float))
    rdp_v = np.atleast_1d(np.asarray(rdp, dtype=float))
    eps = rdp_v - math.log(target_delta) / (orders_v - 1)
    idx = int(np.nanargmin(eps))
    return float(eps[idx]), float(orders_v[idx])


class RDPAccountant:
    """Stateful per-run accountant (compose per round, query any time)."""

    def __init__(self, orders: Iterable[float] = None):
        self.orders = list(orders) if orders is not None else DEFAULT_ORDERS
        self._rdp = np.zeros(len(self.orders))

    def step(self, *, noise_multiplier: float, sample_rate: float, steps: int = 1) -> None:
        self._rdp = self._rdp + compute_rdp(sample_rate, noise_multiplier, steps, self.orders)

    def get_epsilon(self, delta: float) -> float:
        eps, _ = get_privacy_spent(self.orders, self._rdp, delta)
        return eps
