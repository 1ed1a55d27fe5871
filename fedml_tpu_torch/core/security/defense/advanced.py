"""Advanced Byzantine and backdoor defenses: counterpart of
``fedml_tpu/core/security/defense/advanced.py`` (reference
core/security/defense/{bulyan,cclip,cross_round,outlier_detection,
residual_based_reweighting,robust_learning_rate,soteria,wbc,
three_sigma_defense_foolsgold,three_sigma_geomedian}_defense.py).

The cohort is stacked into one ``[K, D]`` matrix on its device; medians,
stable orders and float64 products as in ``robust_aggregation.py``. Three
places follow the JAX package's flax layout, where a Dense kernel is
``[in, out]`` and the port's Linear weight ``[out, in]``:

- CrossRound fingerprints a client by the last leaf of two or more
  dimensions in flax's order (``models/convert.py`` ``wire_order``), raveled
  in the flax layout;
- Soteria's ``repr_param_path`` names a flax path (``Dense_0``), and its
  mask multiplies the flax layout's last (output) axis;
- WBC adds numpy Laplace draws coordinate by coordinate to the flat vector
  in JAX's order (``wire_vector``), so its perturbation is bit-equal to
  JAX's.

CClip's buckets (``random_seed`` + 17) and WBC's draws (+ 23) are host numpy,
from JAX's seeds.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ....models.convert import flax_leaf, state_from_wire_vector, wire_order, wire_vector
from ....utils.pytree import tree_flatten_to_vector, tree_unflatten_from_vector
from .defense_base import BaseDefenseMethod, GradList, StateDict
from .robust_aggregation import _stack_flat, geometric_median, krum_scores, median0, weights_of
from .screening import FoolsGoldDefense, ThreeSigmaDefense, client_ids

log = logging.getLogger(__name__)


# -- Bulyan (Mhamdi et al. 2018), reference bulyan_defense.py -----------------

def bulyan_coordinate_trim(selected: torch.Tensor, beta: int) -> torch.Tensor:
    """[theta, D] -> [D]: per coordinate, the mean of the ``beta`` values
    closest to the coordinate median (ties in client order). The median and
    the distances run in float64, so the pick does not hang on f32 rounding
    near a tie."""
    x64 = selected.double()
    dist = (x64 - median0(x64)[None, :]).abs()
    order = torch.argsort(dist, dim=0, stable=True)
    closest = torch.take_along_dim(selected, order[:beta], dim=0)
    return closest.mean(dim=0)


class BulyanDefense(BaseDefenseMethod):
    """Recursive Krum picks theta = n - 2f clients, then a per-coordinate
    mean of the beta = theta - 2f values nearest the median. Needs
    n >= 4f + 3 (reference bulyan_defense.py:28)."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.f = int(getattr(config, "byzantine_client_num", 1))
        n = int(getattr(config, "client_num_per_round", 4 * self.f + 3))
        assert n >= 4 * self.f + 3, ("bulyan requires n >= 4f + 3", n, self.f)
        self.selected: List[int] = []

    def defend_on_aggregation(self, raw_client_grad_list, base_aggregation_func=None,
                              extra_auxiliary_info=None):
        x, spec = _stack_flat(raw_client_grad_list)
        n = x.shape[0]
        theta = n - 2 * self.f
        remaining = list(range(n))
        selected: List[int] = []
        # recursive Krum: take the best-scoring client each iteration
        while len(selected) < theta and len(remaining) > 2:
            sub = x[torch.tensor(remaining, device=x.device)]
            k_nearest = max(1, len(remaining) - self.f - 2)
            scores = krum_scores(sub, self.f, k_nearest).cpu().numpy()
            best = remaining[int(np.argmin(scores))]
            selected.append(best)
            remaining.remove(best)
        self.selected = selected
        beta = max(1, theta - 2 * self.f)
        agg = bulyan_coordinate_trim(x[torch.tensor(selected, device=x.device)], beta)
        return tree_unflatten_from_vector(agg, spec)


# -- centered clipping with bucketing (Karimireddy et al. 2021), cclip_defense.py

class CClipDefense(BaseDefenseMethod):
    """Bucketize the clients, center-clip each bucket's mean around a
    reference point with radius tau, re-center after the fold (reference
    cclip_defense.py:26-57)."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.tau = float(getattr(config, "tau", 10.0))
        self.bucket_size = int(getattr(config, "bucket_size", 1))
        self._rng = np.random.RandomState(int(getattr(config, "random_seed", 0)) + 17)
        self._initial_guess: Optional[StateDict] = None
        self.buckets: List[List[int]] = []

    def _bucketize(self, lst: GradList) -> GradList:
        """Shuffle, then average groups of ``bucket_size`` (reference
        common/bucket.py Bucket.bucketization)."""
        idx = self._rng.permutation(len(lst))
        out: GradList = []
        self.buckets = []
        for s in range(0, len(lst), self.bucket_size):
            members = [int(i) for i in idx[s:s + self.bucket_size]]
            self.buckets.append(members)
            group = [lst[i] for i in members]
            n_sum = float(sum(n for n, _ in group))
            mean = {k: sum(w[k] for _, w in group) / len(group) for k in group[0][1]}
            out.append((n_sum, mean))
        return out

    def defend_before_aggregation(self, raw_client_grad_list: GradList,
                                  extra_auxiliary_info=None) -> GradList:
        buckets = self._bucketize(raw_client_grad_list)
        # the reference centers on a random bucket, which can be the
        # attacker's; the coordinate median of the buckets stands in for the
        # paper's previous iterate, as in the JAX package
        self._initial_guess = {k: median0(torch.stack([w[k] for _, w in buckets]))
                               for k in buckets[0][1]}
        ref, _ = tree_flatten_to_vector(self._initial_guess)
        out: GradList = []
        for n, w in buckets:
            v, spec = tree_flatten_to_vector(w)
            dist = float(torch.linalg.norm(v - ref)) + 1e-8
            score = min(1.0, self.tau / dist)
            out.append((n, tree_unflatten_from_vector((v - ref) * score, spec)))
        return out

    def defend_after_aggregation(self, global_model: StateDict) -> StateDict:
        if self._initial_guess is None:
            return global_model
        return {k: g + self._initial_guess[k] for k, g in global_model.items()}


# -- cross-round similarity screening, cross_round_defense.py ------------------

def _importance_feature(tree: StateDict) -> np.ndarray:
    """The last leaf of two or more dimensions in flax's order, raveled in
    the flax layout, f32 on the host (JAX ``advanced.py:133-140``)."""
    names = wire_order(tree)
    pick = next((k for k in reversed(names) if tree[k].ndim >= 2), names[-1])
    return flax_leaf(pick, tree[pick]).detach().to("cpu", torch.float32).numpy().reshape(-1)


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na < 1e-12 or nb < 1e-12:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


class CrossRoundDefense(BaseDefenseMethod):
    """Flag clients whose update direction swings away from their own last
    round and from the global model (cosine below ``cosine_similarity_bound``)
    as potentially poisoned; near-identical updates are lazy workers
    (reference cross_round_defense.py:22-101). The cache keys on client ids
    (Context ``client_indexes_of_round``)."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.lowerbound = float(getattr(config, "cosine_similarity_bound", 0.5))
        self.upperbound = 1.0 - 1e-6
        self.client_cache: dict = {}
        self.training_round = 1
        self.is_attack_existing = True
        self.potentially_poisoned_worker_list: List[int] = []
        self.lazy_worker_list: List[int] = []
        self._temp_features: List[np.ndarray] = []
        self._round_ids: List[int] = []

    def get_potential_poisoned_clients(self) -> List[int]:
        return self.potentially_poisoned_worker_list

    def renew_cache(self, real_poisoned_slot_idxs) -> None:
        bad = set(int(i) for i in real_poisoned_slot_idxs)
        for slot, feat in enumerate(self._temp_features):
            if slot not in bad:
                self.client_cache[self._round_ids[slot]] = feat

    def defend_before_aggregation(self, raw_client_grad_list: GradList,
                                  extra_auxiliary_info=None) -> GradList:
        self._temp_features = [_importance_feature(g) for _, g in raw_client_grad_list]
        self._round_ids = client_ids(len(raw_client_grad_list))
        if self.training_round == 1:
            # no history yet: everyone is suspect in round one
            self.training_round += 1
            self.potentially_poisoned_worker_list = list(range(len(raw_client_grad_list)))
            self.is_attack_existing = True
            return raw_client_grad_list
        self.is_attack_existing = False
        self.potentially_poisoned_worker_list = []
        self.lazy_worker_list = []
        global_feature = (_importance_feature(extra_auxiliary_info)
                          if extra_auxiliary_info is not None else None)
        for slot, feat in enumerate(self._temp_features):
            cached = self.client_cache.get(self._round_ids[slot], global_feature)
            client_score = _cosine(feat, cached) if cached is not None else 1.0
            global_score = _cosine(feat, global_feature) if global_feature is not None else 1.0
            if client_score < self.lowerbound or global_score < self.lowerbound:
                self.is_attack_existing = True
                self.potentially_poisoned_worker_list.append(slot)
            elif client_score > self.upperbound:
                self.lazy_worker_list.append(slot)
        self.training_round += 1
        # this round's clean features refresh the history; OutlierDetection
        # re-calls renew_cache with the 3-sigma-confirmed set afterwards
        self.renew_cache(self.potentially_poisoned_worker_list)
        return raw_client_grad_list


class OutlierDetection(BaseDefenseMethod):
    """Two phases (reference outlier_detection.py): the cross-round cosine
    check gates the 3-sigma screen; only confirmed outliers are dropped, and
    the cache keeps only clean clients."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.cross_round_check = CrossRoundDefense(config)
        self.three_sigma_check = ThreeSigmaDefense(config)

    def get_malicious_client_idxs(self):
        return self.three_sigma_check.get_malicious_client_idxs()

    def defend_before_aggregation(self, raw_client_grad_list: GradList,
                                  extra_auxiliary_info=None) -> GradList:
        lst = self.cross_round_check.defend_before_aggregation(raw_client_grad_list,
                                                               extra_auxiliary_info)
        if self.cross_round_check.is_attack_existing:
            self.three_sigma_check.set_potential_malicious_clients(
                self.cross_round_check.get_potential_poisoned_clients())
            lst = self.three_sigma_check.defend_before_aggregation(lst, extra_auxiliary_info)
            self.cross_round_check.renew_cache(self.three_sigma_check.get_malicious_client_idxs())
            log.info("outlier detection: malicious=%s",
                     self.three_sigma_check.get_malicious_client_idxs())
        return lst


# -- residual-based reweighting (Fu et al. 2019) ------------------------------

def irls_weights(x: torch.Tensor, lambda_param: float = 2.0, thresh: float = 0.1) -> torch.Tensor:
    """Each client's IRLS confidence from its residuals, standardized by the
    MAD, against the coordinate median. [K, D] -> [K] weights summing to 1."""
    med = median0(x)
    resid = x - med[None, :]
    mad = median0(resid.abs()) * 1.4826 + 1e-8
    std_resid = resid.abs() / mad[None, :]
    r = torch.clamp(std_resid, max=lambda_param).mean(dim=1)
    w = 1.0 / (1.0 + r)
    w = torch.where(w < thresh, torch.full_like(w, thresh), w)
    return w / w.sum()


def weighted_rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``sum_k w[k] * x[k]`` without a matmul (no TF32 path)."""
    return (w[:, None] * x).sum(dim=0)


class ResidualBasedReweightingDefense(BaseDefenseMethod):
    def __init__(self, config: Any):
        super().__init__(config)
        self.lambda_param = float(getattr(config, "residual_lambda", 2.0))
        self.thresh = float(getattr(config, "residual_thresh", 0.1))

    def defend_on_aggregation(self, raw_client_grad_list, base_aggregation_func=None,
                              extra_auxiliary_info=None):
        x, spec = _stack_flat(raw_client_grad_list)
        w = irls_weights(x, self.lambda_param, self.thresh)
        return tree_unflatten_from_vector(weighted_rows(w, x), spec)


# -- robust learning rate (Ozdayi et al. 2021) --------------------------------

def rlr_aggregate(x: torch.Tensor, weights: torch.Tensor, robust_threshold: int) -> torch.Tensor:
    """Per-coordinate sign vote: where fewer than ``robust_threshold`` clients
    agree in sign the server's learning rate flips to -1 (reference
    robust_learning_rate_defense.py:42-59)."""
    vote = torch.sign(x).sum(dim=0).abs()
    lr = torch.where(vote >= robust_threshold, 1.0, -1.0).to(x.dtype)
    return lr * weighted_rows(weights / weights.sum(), x)


class RobustLearningRateDefense(BaseDefenseMethod):
    def __init__(self, config: Any):
        super().__init__(config)
        self.robust_threshold = int(getattr(config, "robust_threshold", 4))

    def defend_on_aggregation(self, raw_client_grad_list, base_aggregation_func=None,
                              extra_auxiliary_info=None):
        if self.robust_threshold == 0:
            return base_aggregation_func(self.config, raw_client_grad_list)
        x, spec = _stack_flat(raw_client_grad_list)
        w = weights_of(raw_client_grad_list, x)
        return tree_unflatten_from_vector(rlr_aggregate(x, w, self.robust_threshold), spec)


# -- Soteria (Sun et al. 2021) ------------------------------------------------

def soteria_mask(sensitivity: torch.Tensor, prune_percentile: float) -> torch.Tensor:
    """Zero the representation coordinates of smallest sensitivity; the
    threshold is ``jnp.percentile``'s linear interpolation."""
    thresh = torch.quantile(sensitivity, prune_percentile / 100.0)
    return torch.where(sensitivity < thresh, 0.0, 1.0).to(sensitivity.dtype)


class SoteriaDefense(BaseDefenseMethod):
    """Client-side gradient-leakage defense: prune the representation
    layer of the shared update so DLG-style reconstruction degrades
    (reference soteria_defense.py; one ``torch.func.jacrev`` for JAX's
    ``jax.jacrev``).

    ``repr_fn(params, x) -> [B, F]`` extracts the defended representation;
    ``repr_param_path`` names that layer in flax's path form (``Dense_0``):
    every leaf whose flax path holds it and whose flax layout's last axis is
    F is masked along that axis.
    """

    def __init__(self, config: Any, repr_fn: Callable = None, repr_param_path: str = None):
        super().__init__(config)
        self.repr_fn = repr_fn
        self.repr_param_path = repr_param_path
        self.prune_percentile = float(getattr(config, "soteria_percentile", 1.0))
        self.defense_data = getattr(config, "defense_data", None)

    def sensitivity(self, params: StateDict, x: torch.Tensor) -> torch.Tensor:
        jac = torch.func.jacrev(lambda d: self.repr_fn(params, d))(x)  # [B, F, *x.shape]
        r = self.repr_fn(params, x)  # [B, F]
        jnorm = torch.sqrt((jac.reshape(jac.shape[0], jac.shape[1], -1) ** 2).sum(dim=-1))
        return (jnorm / (r.abs() + 1e-8)).sum(dim=0)  # [F]

    def mask_state(self, w: StateDict, mask: torch.Tensor) -> StateDict:
        from ....models.convert import flax_name, torch_leaf

        out = {}
        for k, leaf in w.items():
            flax = flax_leaf(k, leaf)
            if (self.repr_param_path in flax_name(k) and flax.ndim >= 1
                    and flax.shape[-1] == mask.shape[0]):
                leaf = torch_leaf(k, flax * mask.to(flax.dtype))
            out[k] = leaf
        return out

    def defend_before_aggregation(self, raw_client_grad_list: GradList,
                                  extra_auxiliary_info=None) -> GradList:
        if self.repr_fn is None or self.defense_data is None or self.repr_param_path is None:
            log.warning("SoteriaDefense: repr_fn/defense_data/repr_param_path not set; passthrough")
            return raw_client_grad_list
        out: GradList = []
        for n, w in raw_client_grad_list:
            dev = next(iter(w.values())).device
            x = torch.as_tensor(np.asarray(self.defense_data), device=dev)
            mask = soteria_mask(self.sensitivity(w, x), self.prune_percentile)
            out.append((n, self.mask_state(w, mask)))
        return out


# -- FL-WBC (Sun et al. 2021), wbc_defense.py ----------------------------------

class WbcDefense(BaseDefenseMethod):
    """White Blood Cell: perturb, with Laplace noise, the coordinates whose
    gradient barely moved between batches, where a poisoning attack's effect
    persists (reference wbc_defense.py). Noise lands only where
    |grad_diff| <= |laplace| (reference :62-67)."""

    def __init__(self, config: Any):
        super().__init__(config)
        self.client_idx = int(getattr(config, "client_idx", 0))
        self.batch_idx = int(getattr(config, "batch_idx", 0))
        self.pert_strength = float(getattr(config, "wbc_pert_strength", 1.0))
        self.learning_rate = float(getattr(config, "wbc_learning_rate", 0.1))
        self._rng = np.random.RandomState(int(getattr(config, "random_seed", 0)) + 23)
        self.old_gradient: dict = {}

    @staticmethod
    def _is_grad_list(obj) -> bool:
        return (isinstance(obj, (list, tuple)) and len(obj) > 0
                and isinstance(obj[0], (list, tuple)) and len(obj[0]) == 2)

    def defend_on_aggregation(self, raw_client_grad_list, base_aggregation_func=None,
                              extra_auxiliary_info=None):
        # the server hook passes the global model as aux info; use aux only
        # when it is a (sample_num, params) list like the reference's
        models_param = (extra_auxiliary_info if self._is_grad_list(extra_auxiliary_info)
                        else raw_client_grad_list)
        lst = list(models_param)
        n_i, w_i = lst[self.client_idx]
        _, grad_w = raw_client_grad_list[self.client_idx]
        flat_grad = wire_vector(grad_w).cpu().numpy()
        if self.batch_idx != 0:
            old = self.old_gradient.get("flat")
            if old is None:
                old = flat_grad * 0.2  # the reference's bootstrap (:60)
            grad_diff = flat_grad - old
            pert = self._rng.laplace(0.0, self.pert_strength, size=grad_diff.shape).astype(np.float32)
            pert = np.where(np.abs(grad_diff) > np.abs(pert), 0.0, pert)
            flat_w = wire_vector(w_i)
            flat_w = flat_w + torch.from_numpy(pert).to(flat_w.device) * self.learning_rate
            lst[self.client_idx] = (n_i, state_from_wire_vector(flat_w, w_i))
        self.old_gradient["flat"] = flat_grad
        return base_aggregation_func(self.config, lst)


# -- 3-sigma combinations ------------------------------------------------------

class ThreeSigmaFoolsGoldDefense(ThreeSigmaDefense):
    """3-sigma screening, then FoolsGold's re-weighting of the survivors
    with its per-client history (reference three_sigma_defense_foolsgold.py)."""

    def __init__(self, config: Any):
        super().__init__(config)
        self._foolsgold = FoolsGoldDefense(config)

    def defend_before_aggregation(self, raw_client_grad_list: GradList,
                                  extra_auxiliary_info=None) -> GradList:
        kept = super().defend_before_aggregation(raw_client_grad_list, extra_auxiliary_info)
        return self._foolsgold.defend_before_aggregation(kept, extra_auxiliary_info)


class ThreeSigmaGeoMedianDefense(BaseDefenseMethod):
    """3-sigma screening centered on the geometric median (reference
    three_sigma_geomedian_defense.py)."""

    def defend_before_aggregation(self, raw_client_grad_list: GradList,
                                  extra_auxiliary_info=None) -> GradList:
        x, _ = _stack_flat(raw_client_grad_list)
        w = weights_of(raw_client_grad_list, x)
        gm = geometric_median(x, w / w.sum())
        scores = torch.linalg.norm(x - gm[None, :], dim=1).cpu().numpy()
        mu = float(np.median(scores))
        sigma = float(np.median(np.abs(scores - mu)) * 1.4826 + 1e-6 * (abs(mu) + 1.0))
        keep = [i for i, s in enumerate(scores) if s <= mu + 3.0 * sigma]
        if not keep:
            keep = list(range(len(raw_client_grad_list)))
        return [raw_client_grad_list[i] for i in keep]
