"""Robust aggregation over the stacked cohort: counterpart of
``fedml_tpu/core/security/defense/robust_aggregation.py`` (reference
core/security/defense/{krum,coordinate_wise_median,
coordinate_wise_trimmed_mean,rfa,geometric_median}_defense.py).

Each defense stacks the client updates into one ``[K, D]`` matrix on their
device and reduces it there. Where torch's defaults differ from JAX's:

- the median of an even count averages the two middle values, as
  ``jnp.median`` does (``torch.median`` returns the lower one), from one
  sort along the client axis (``torch.quantile`` refuses inputs above 2^24
  elements);
- ties keep their order (``stable=True``), as ``jnp.argsort`` does;
- Krum's Gram matrix and every other product over D run in float64, so no
  result depends on the TF32 matmul flag.
"""

from __future__ import annotations

from typing import Any, List

import torch

from ....utils.pytree import tree_flatten_to_vector, tree_unflatten_from_vector
from .defense_base import BaseDefenseMethod, GradList


def _stack_flat(raw_client_grad_list: GradList):
    """``[K, D]`` over the clients (f32, or float64 for float64 leaves) and
    the spec that restores a state dict."""
    first = raw_client_grad_list[0][1]
    dtype = torch.float64 if any(v.dtype == torch.float64 for v in first.values()) \
        else torch.float32
    flats, spec = [], None
    for _, g in raw_client_grad_list:
        f, spec = tree_flatten_to_vector(g, dtype=dtype)
        flats.append(f)
    return torch.stack(flats), spec


def weights_of(raw_client_grad_list: GradList, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([float(n) for n, _ in raw_client_grad_list], dtype=like.dtype,
                        device=like.device)


def median0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=0)``: the middle value along the client axis, the
    mean of the two middle values for an even count."""
    k = x.shape[0]
    s = torch.sort(x, dim=0).values
    if k % 2:
        return s[k // 2]
    return (s[k // 2 - 1] + s[k // 2]) / 2


def matmul_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` in float64, cast back to ``a``'s dtype."""
    return (a.double() @ b.double().T).to(a.dtype)


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """[K, D] -> [K, K] squared euclidean distances through the Gram matrix,
    clamped at 0 (JAX ``:35-41``), computed in float64."""
    x64 = x.double()
    sq = (x64 * x64).sum(dim=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (x64 @ x64.T)
    return d.clamp_min(0.0).to(x.dtype)


def krum_scores(x: torch.Tensor, byzantine_count: int, k_nearest: int) -> torch.Tensor:
    """Each client's sum of distances to its ``k_nearest`` nearest others."""
    d = pairwise_sq_dists(x)
    d = d + torch.diag(torch.full((d.shape[0],), float("inf"), dtype=d.dtype, device=d.device))
    return torch.sort(d, dim=1).values[:, :k_nearest].sum(dim=1)


def krum_select(x: torch.Tensor, byzantine_count: int, multi_k: int = 1) -> torch.Tensor:
    """Indices of the ``multi_k`` lowest-score clients (Blanchard et al.
    2017), ties in client order."""
    k = x.shape[0]
    k_nearest = max(1, k - byzantine_count - 2)
    scores = krum_scores(x, byzantine_count, k_nearest)
    return torch.argsort(scores, stable=True)[:multi_k]


def coordinate_wise_median(x: torch.Tensor) -> torch.Tensor:
    return median0(x)


def trimmed_mean(x: torch.Tensor, trim_k: int) -> torch.Tensor:
    """Drop the ``trim_k`` largest and smallest per coordinate, then mean."""
    k = x.shape[0]
    s = torch.sort(x, dim=0).values
    return s[trim_k:k - trim_k].mean(dim=0)


def geometric_median(x: torch.Tensor, weights: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Smoothed Weiszfeld iterations (RFA, Pillutla et al. 2019), a fixed
    trip count as JAX's ``lax.scan``."""
    mu = (weights[:, None] * x).sum(dim=0) / weights.sum()
    for _ in range(iters):
        d = torch.sqrt(((x - mu[None, :]) ** 2).sum(dim=1) + 1e-8)
        w = weights / d
        mu = (w[:, None] * x).sum(dim=0) / w.sum()
    return mu


class KrumDefense(BaseDefenseMethod):
    """Reference defense/krum_defense.py (``krum_param_m`` > 1: multi-Krum)."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.byzantine_client_num = int(getattr(config, "byzantine_client_num", 1))
        self.multi = int(getattr(config, "krum_param_m", 1))
        self.selected: List[int] = []

    def defend_before_aggregation(self, raw_client_grad_list: GradList,
                                  extra_auxiliary_info=None) -> GradList:
        x, _ = _stack_flat(raw_client_grad_list)
        self.selected = krum_select(x, self.byzantine_client_num, self.multi).tolist()
        return [raw_client_grad_list[i] for i in self.selected]


class CoordinateWiseMedianDefense(BaseDefenseMethod):
    def defend_on_aggregation(self, raw_client_grad_list, base_aggregation_func=None,
                              extra_auxiliary_info=None):
        x, spec = _stack_flat(raw_client_grad_list)
        return tree_unflatten_from_vector(coordinate_wise_median(x), spec)


class CoordinateWiseTrimmedMeanDefense(BaseDefenseMethod):
    def __init__(self, config: Any):
        super().__init__(config)
        self.beta = float(getattr(config, "beta", 0.1))  # the trimmed fraction a side

    def defend_on_aggregation(self, raw_client_grad_list, base_aggregation_func=None,
                              extra_auxiliary_info=None):
        x, spec = _stack_flat(raw_client_grad_list)
        trim_k = min(int(self.beta * x.shape[0]), (x.shape[0] - 1) // 2)
        return tree_unflatten_from_vector(trimmed_mean(x, trim_k), spec)


class RFADefense(BaseDefenseMethod):
    """Geometric-median aggregation (reference defense/RFA_defense.py)."""

    def defend_on_aggregation(self, raw_client_grad_list, base_aggregation_func=None,
                              extra_auxiliary_info=None):
        x, spec = _stack_flat(raw_client_grad_list)
        w = weights_of(raw_client_grad_list, x)
        return tree_unflatten_from_vector(geometric_median(x, w / w.sum()), spec)


class GeometricMedianDefense(RFADefense):
    pass
