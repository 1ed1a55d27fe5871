"""Screening and re-weighting defenses: counterpart of
``fedml_tpu/core/security/defense/screening.py`` (reference
core/security/defense/{norm_diff_clipping,weak_dp,foolsgold,three_sigma,
slsgd,crfl}_defense.py).

WeakDP and CRFL draw from explicit generators on the state dicts' device,
seeded with JAX's offsets (``random_seed`` + 13 and + 29), leaf by leaf in
wire order: their draws match JAX's in distribution. The 3-sigma screen
reads the norms on the host in f32 numpy, as JAX does.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from ....utils.pytree import tree_add, tree_clip_by_global_norm, tree_sub, \
    tree_unflatten_from_vector
from ...alg_frame.context import Context
from ...dp.mechanisms.gaussian import DeviceGenerators, add_gaussian_noise
from .defense_base import BaseDefenseMethod, GradList
from .robust_aggregation import _stack_flat, matmul_t, trimmed_mean


def client_ids(n: int) -> List[int]:
    """This round's client ids from Context ``client_indexes_of_round`` (the
    per-client memories must key on ids: under sampling a slot holds another
    client each round); slot positions when they do not fit."""
    ids = Context().get("client_indexes_of_round")
    if ids is None or len(ids) != n:
        return list(range(n))
    return [int(i) for i in ids]


class NormDiffClippingDefense(BaseDefenseMethod):
    """Clip ||w_client - w_global|| to a bound (reference
    norm_diff_clipping_defense.py; Sun et al. 2019)."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.norm_bound = float(getattr(config, "norm_bound", 5.0))

    def defend_before_aggregation(self, raw_client_grad_list: GradList,
                                  extra_auxiliary_info=None) -> GradList:
        w_global = extra_auxiliary_info
        return [(n, tree_add(w_global, tree_clip_by_global_norm(tree_sub(w, w_global),
                                                                self.norm_bound)))
                for n, w in raw_client_grad_list]


class WeakDPDefense(BaseDefenseMethod):
    """Small Gaussian noise on each client update (reference
    weak_dp_defense.py)."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.stddev = float(getattr(config, "stddev", 0.001))
        self.generators = DeviceGenerators(int(getattr(config, "random_seed", 0)) + 13)

    def defend_before_aggregation(self, raw_client_grad_list: GradList,
                                  extra_auxiliary_info=None) -> GradList:
        return [(n, add_gaussian_noise(w, self.generators.for_tree(w), self.stddev))
                for n, w in raw_client_grad_list]


def foolsgold_weights(grads: torch.Tensor) -> torch.Tensor:
    """FoolsGold (Fung et al. 2020): down-weight clients whose historical
    updates are similar in direction. [K, D] -> [K] learning rates. The
    cosines are float64 products (no TF32 path)."""
    norms = torch.linalg.norm(grads, dim=1, keepdim=True) + 1e-9
    unit = grads / norms
    cs = matmul_t(unit, unit)
    # the diagonal is 0 exactly: JAX subtracts the identity from its f32
    # products, whose rounding (about 1e-7) then decides the pardon of a
    # client no other resembles (its row's max is the diagonal)
    cs.fill_diagonal_(0.0)
    maxcs = cs.max(dim=1).values
    # pardoning: rescale similarity by the ratio of the max similarities
    pardon = maxcs[None, :] / (maxcs[:, None] + 1e-9)
    cs = cs * torch.clamp(pardon, max=1.0)
    wv = 1.0 - cs.max(dim=1).values
    wv = wv.clamp(0.0, 1.0)
    wv = wv / (wv.max() + 1e-9)
    # logit re-scaling
    wv = wv.clamp(1e-6, 1 - 1e-6)
    wv = torch.log(wv / (1 - wv)) + 0.5
    return wv.clamp(0.0, 1.0)


class FoolsGoldDefense(BaseDefenseMethod):
    def __init__(self, config: Any):
        super().__init__(config)
        # the sum of each client's flat updates, keyed by client id
        self.memory: dict = {}
        self.weights: List[float] = []

    def defend_before_aggregation(self, raw_client_grad_list: GradList,
                                  extra_auxiliary_info=None) -> GradList:
        x, _ = _stack_flat(raw_client_grad_list)
        ids = client_ids(len(raw_client_grad_list))
        for i, cid in enumerate(ids):
            self.memory[cid] = x[i] if cid not in self.memory else self.memory[cid] + x[i]
        hist = torch.stack([self.memory[cid] for cid in ids])
        wv = foolsgold_weights(hist).cpu().numpy()
        self.weights = [float(v) for v in wv]
        return [(float(wv[i]) * n if wv[i] > 0 else 1e-9, g)
                for i, (n, g) in enumerate(raw_client_grad_list)]


class ThreeSigmaDefense(BaseDefenseMethod):
    """Drop clients whose update norm deviates more than 3 sigma from the
    cohort's median, sigma the MAD's (reference three_sigma_defense.py
    family). ``set_potential_malicious_clients`` narrows the screen to a
    suspect set (CrossRoundDefense's, inside OutlierDetection)."""

    def __init__(self, config: Any):
        super().__init__(config)
        self._suspects = None
        self._malicious: list = []

    def set_potential_malicious_clients(self, suspect_idxs) -> None:
        self._suspects = None if suspect_idxs is None else set(int(i) for i in suspect_idxs)

    def get_malicious_client_idxs(self) -> list:
        return self._malicious

    def defend_before_aggregation(self, raw_client_grad_list: GradList,
                                  extra_auxiliary_info=None) -> GradList:
        x, _ = _stack_flat(raw_client_grad_list)
        norms = torch.linalg.norm(x, dim=1).cpu().numpy()
        med = float(np.median(norms))
        # robust sigma (MAD * 1.4826): the outlier being screened inflates np.std
        std = float(np.median(np.abs(norms - med)) * 1.4826 + 1e-6 * (abs(med) + 1.0))
        outlier = {i for i, v in enumerate(norms)
                   if abs(v - med) > 3.0 * std and (self._suspects is None or i in self._suspects)}
        self._malicious = sorted(outlier)
        keep = [i for i in range(len(raw_client_grad_list)) if i not in outlier]
        if not keep:
            keep = list(range(len(raw_client_grad_list)))
            self._malicious = []
        return [raw_client_grad_list[i] for i in keep]


class SLSGDDefense(BaseDefenseMethod):
    """Trimmed mean mixed with the previous global model (reference
    slsgd_defense.py; Xie et al. 2019)."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.alpha = float(getattr(config, "alpha", 0.1))
        self.b = int(getattr(config, "trim_param_b", 1))

    def defend_on_aggregation(self, raw_client_grad_list, base_aggregation_func=None,
                              extra_auxiliary_info=None):
        x, spec = _stack_flat(raw_client_grad_list)
        b = min(self.b, (x.shape[0] - 1) // 2)
        agg = tree_unflatten_from_vector(trimmed_mean(x, b), spec)
        w_global = extra_auxiliary_info
        if w_global is None:
            return agg
        return {k: (1 - self.alpha) * g + self.alpha * agg[k] for k, g in w_global.items()}


class CRFLDefense(BaseDefenseMethod):
    """Clip the aggregated model and smooth it with noise each round
    (reference crfl_defense.py; Xie et al. 2021)."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.clip = float(getattr(config, "clip_threshold", 15.0))
        self.sigma = float(getattr(config, "crfl_sigma", 0.01))
        self.generators = DeviceGenerators(int(getattr(config, "random_seed", 0)) + 29)

    def defend_after_aggregation(self, global_model):
        clipped = tree_clip_by_global_norm(global_model, self.clip)
        return add_gaussian_noise(clipped, self.generators.for_tree(clipped), self.sigma)
