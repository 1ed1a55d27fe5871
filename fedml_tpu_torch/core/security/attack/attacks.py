"""Attacks on the model and the data: counterpart of
``fedml_tpu/core/security/attack/attacks.py`` (reference
core/security/attack/{byzantine_attack,label_flipping_attack,
model_replacement_backdoor_attack,backdoor_attack,edge_case_backdoor_attack,
lazy_worker}.py). The gradient-inversion attacks are in
``gradient_inversion.py``.

Byzantine ``random`` and the lazy worker draw from explicit generators on
the state dicts' device (``random_seed`` + 101 and + 211), leaf by leaf in
wire order; the edge-case draws are host numpy (+ 307), bit-equal to JAX's.
The data attacks take a client's ``ArrayDataset`` (what the fronts pass)
or an ``(x, y)`` pair, and return the same kind.
"""

from __future__ import annotations

import logging
import os
from typing import Any, List, Tuple

import numpy as np
import torch

from ....data.dataset import ArrayDataset
from ....utils.pytree import StateDict, tree_add, tree_scale, tree_sub
from ...dp.mechanisms.gaussian import DeviceGenerators, normal_like

GradList = List[Tuple[float, StateDict]]


def _xy(dataset) -> Tuple[Any, Any]:
    if isinstance(dataset, ArrayDataset):
        return dataset.x, dataset.y
    x, y = dataset
    return x, y


def _like(dataset, x, y):
    return ArrayDataset(x, y) if isinstance(dataset, ArrayDataset) else (x, y)


class ByzantineAttack:
    """Replace the first ``byzantine_client_num`` updates with zeros, random
    noise or sign-flipped updates (reference byzantine_attack.py)."""

    def __init__(self, config: Any):
        self.byzantine_client_num = int(getattr(config, "byzantine_client_num", 1))
        self.attack_mode = str(getattr(config, "attack_mode", "random"))  # zero|random|flip
        self.generators = DeviceGenerators(int(getattr(config, "random_seed", 0)) + 101)

    def attack_model(self, raw_client_grad_list: GradList, extra_auxiliary_info=None) -> GradList:
        out = list(raw_client_grad_list)
        for i in range(min(self.byzantine_client_num, len(out))):
            n, w = out[i]
            if self.attack_mode == "zero":
                w = {k: torch.zeros_like(v) for k, v in w.items()}
            elif self.attack_mode == "flip":
                w = tree_scale(w, -1.0)
            else:  # random
                noise = normal_like(w, self.generators.for_tree(w))
                w = {k: noise[k].to(v.dtype) for k, v in w.items()}
            out[i] = (n, w)
        return out


class LabelFlippingAttack:
    """Relabel ``original_class`` as ``target_class`` in the poisoned
    client's data (reference label_flipping_attack.py)."""

    def __init__(self, config: Any):
        self.original_class = int(getattr(config, "original_class_list", [1])[0]) if hasattr(
            config, "original_class_list") else int(getattr(config, "original_class", 1))
        self.target_class = int(getattr(config, "target_class_list", [7])[0]) if hasattr(
            config, "target_class_list") else int(getattr(config, "target_class", 7))

    def poison_data(self, dataset):
        x, y = _xy(dataset)
        y = np.asarray(y).copy()
        y[y == self.original_class] = self.target_class
        return _like(dataset, x, y)


class ModelReplacementBackdoorAttack:
    """Scale a malicious update so it survives averaging (reference
    model_replacement_backdoor_attack.py; Bagdasaryan et al.)."""

    def __init__(self, config: Any):
        self.scale = float(getattr(config, "attack_scale", 0.0))  # 0: the cohort's size

    def attack_model(self, raw_client_grad_list: GradList, extra_auxiliary_info=None) -> GradList:
        w_global = extra_auxiliary_info
        out = list(raw_client_grad_list)
        if not out or w_global is None:
            return out
        gamma = self.scale if self.scale > 0 else float(len(out))
        n, w = out[0]
        out[0] = (n, tree_add(w_global, tree_scale(tree_sub(w, w_global), gamma)))
        return out


class BackdoorAttack:
    """"A little is enough" (Baruch et al. 2019; reference
    backdoor_attack.py): the malicious workers submit mean - z * std of the
    benign updates per coordinate (std with ddof 0, as ``jnp.std``), inside
    the band statistical defenses take as plausible."""

    def __init__(self, config: Any):
        self.backdoor_client_num = int(getattr(config, "backdoor_client_num", 1))
        self.client_num = int(getattr(config, "client_num_per_round", 4))
        self.num_std = float(getattr(config, "num_std", 1.5))

    def attack_model(self, raw_client_grad_list: GradList, extra_auxiliary_info=None) -> GradList:
        out = list(raw_client_grad_list)
        k = min(self.backdoor_client_num, len(out))
        if k == 0 or len(out) <= k:
            return out
        benign = [w for _, w in out[k:]]
        poisoned = {}
        for name in benign[0]:
            s = torch.stack([w[name] for w in benign])
            poisoned[name] = s.mean(dim=0) - self.num_std * s.std(dim=0, correction=0)
        for i in range(k):
            out[i] = (out[i][0], poisoned)
        return out


class EdgeCaseBackdoorAttack:
    """Edge-case ("tail") backdoor (Wang et al. 2020; reference
    edge_case_backdoor_attack.py): poisoned clients mix a share of rare
    samples labelled with the attacker's target into their data. Without a
    pool (none given, and no reference pickle in ``data_cache_dir``) the
    tail of the local data is relabelled."""

    def __init__(self, config: Any, backdoor_dataset=None):
        self.sample_pct = float(getattr(config, "backdoor_sample_percentage", 0.1))
        self.target_class = int(getattr(config, "target_class", 0))
        self.backdoor_dataset = backdoor_dataset or getattr(config, "backdoor_dataset", None)
        # an explicit pool is user config: a shape mismatch raises; only a
        # pool found in the cache falls back to the tail relabel
        self._pool_explicit = self.backdoor_dataset is not None
        if self.backdoor_dataset is None:
            cache = str(getattr(config, "data_cache_dir", "") or "")
            from ....data.sources import edge_case_pickle_path, load_edge_case_examples

            if cache and os.path.exists(edge_case_pickle_path(cache)):
                pool = load_edge_case_examples(target_class=self.target_class, cache_dir=cache, n=0)
                if len(pool[0]):  # an unreadable pickle gives an empty surrogate (n=0)
                    self.backdoor_dataset = pool
        self._rng = np.random.RandomState(int(getattr(config, "random_seed", 0)) + 307)

    def poison_data(self, dataset):
        x, y = _xy(dataset)
        x, y = np.asarray(x), np.asarray(y).copy()
        n_poison = max(1, int(len(y) * self.sample_pct))
        pool = self.backdoor_dataset
        if pool is not None and np.asarray(pool[0]).shape[1:] != x.shape[1:]:
            if self._pool_explicit:
                raise ValueError(
                    f"backdoor_dataset shape {np.asarray(pool[0]).shape[1:]} does not match "
                    f"local data {x.shape[1:]}: an explicitly configured pool must match the "
                    "training data")
            logging.getLogger(__name__).warning(
                "the edge-case pool found in the cache has shape %s, the local data %s; "
                "relabelling the tail instead", np.asarray(pool[0]).shape[1:], x.shape[1:])
            pool = None
        if pool is not None:
            bx = np.asarray(pool[0])
            pick = self._rng.randint(0, len(bx), n_poison)
            slots = self._rng.choice(len(y), n_poison, replace=False)
            x = x.copy()
            x[slots] = bx[pick][:len(slots)].reshape(x[slots].shape)
            y[slots] = self.target_class
        else:
            slots = self._rng.choice(len(y), n_poison, replace=False)
            y[slots] = self.target_class
        return _like(dataset, x, y)


class LazyWorkerAttack:
    """Lazy workers resubmit a noisy copy of the previous global model
    instead of training (reference lazy_worker.py)."""

    def __init__(self, config: Any):
        self.lazy_worker_num = int(getattr(config, "lazy_worker_num", 1))
        self.noise = float(getattr(config, "lazy_noise", 1e-3))
        self.generators = DeviceGenerators(int(getattr(config, "random_seed", 0)) + 211)

    def attack_model(self, raw_client_grad_list: GradList, extra_auxiliary_info=None) -> GradList:
        w_global = extra_auxiliary_info
        if w_global is None:
            return raw_client_grad_list
        out = list(raw_client_grad_list)
        for i in range(min(self.lazy_worker_num, len(out))):
            noise = normal_like(w_global, self.generators.for_tree(w_global))
            out[i] = (out[i][0], {k: v + (self.noise * noise[k]).to(v.dtype)
                                  for k, v in w_global.items()})
        return out
