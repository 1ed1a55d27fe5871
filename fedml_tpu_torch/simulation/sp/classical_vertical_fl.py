"""Classical vertical FL: counterpart of
``fedml_tpu/simulation/sp/classical_vertical_fl.py`` (reference
``simulation/sp/classical_vertical_fl``).

One active party (the host, holding the labels) and N passive parties
(guests, holding feature slices) over a feature-partitioned table. Per
batch every party computes its partial logit from its slice, the host sums
them and takes the logistic loss, and each party gets the gradient of the
loss with respect to its own component and applies it to its own model.
As in the JAX package the joint step is one autograd pass over the summed
logit: the parties' isolation is an information-flow boundary, not a
mathematical one, and only components and their gradients would cross it.
The parties' linear models live on the trainer's device.

A library API, outside the runner's dispatch, in the JAX package too.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ...device import resolve_device

log = logging.getLogger(__name__)


def _party_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """A party's linear component (the reference's LR/dense heads)."""
    return x @ params["w"] + params["b"]


def init_party(feature_dim: int, out_dim: int = 1, seed: int = 0, device: Any = "cpu",
               dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``w ~ 0.01 N(0, 1)`` from a torch generator seeded with ``seed``
    (JAX's draw is its own PRNG's), ``b = 0``."""
    gen = torch.Generator().manual_seed(int(seed))
    return {"w": (0.01 * torch.randn(feature_dim, out_dim, generator=gen)).to(device, dtype),
            "b": torch.zeros(out_dim, device=device, dtype=dtype)}


def _joint_logit(all_params, xs) -> torch.Tensor:
    return sum(_party_apply(p, x) for p, x in zip(all_params, xs))[:, 0]


class VerticalFederatedLearning:
    """The joint trainer of a host and its guests (reference vfl.py
    ``VerticalMultiplePartyLogisticRegressionFederatedLearning``)."""

    def __init__(self, party_feature_dims: Sequence[int], learning_rate: float = 0.1,
                 seed: int = 0, device: Any = "cuda", dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.party_params: List[Dict[str, torch.Tensor]] = [
            init_party(d, seed=seed + i, device=self.device, dtype=dtype)
            for i, d in enumerate(party_feature_dims)]
        self.lr = float(learning_rate)

    def _as(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(self.dtype)

    def fit_batch(self, party_xs: Sequence[np.ndarray], y: np.ndarray) -> float:
        xs = [self._as(x) for x in party_xs]
        y = self._as(y)
        params = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in self.party_params]
        logit = _joint_logit(params, xs)
        # logistic loss; y in {0, 1}
        loss = torch.mean(torch.clamp(logit, min=0) - logit * y
                          + torch.log1p(torch.exp(-torch.abs(logit))))
        grads = torch.autograd.grad(loss, [v for p in params for v in p.values()])
        # each party applies only ITS gradient slice (the protocol boundary)
        it = iter(grads)
        self.party_params = [{k: v.detach() - self.lr * next(it) for k, v in p.items()}
                             for p in params]
        return float(loss.detach())

    @torch.no_grad()
    def predict(self, party_xs: Sequence[np.ndarray]) -> np.ndarray:
        logit = _joint_logit(self.party_params, [self._as(x) for x in party_xs])
        return torch.sigmoid(logit).cpu().numpy()


class VflFixture:
    """The train and evaluation driver (reference vfl_fixture
    ``FederatedLearningFixture``)."""

    def __init__(self, vfl: VerticalFederatedLearning):
        self.vfl = vfl
        self.loss_list: List[float] = []

    def fit(self, party_xs_train: Sequence[np.ndarray], y_train: np.ndarray,
            party_xs_test: Sequence[np.ndarray], y_test: np.ndarray,
            epochs: int = 1, batch_size: int = 64) -> Dict[str, Any]:
        n = len(y_train)
        metrics: Dict[str, Any] = {}
        for ep in range(epochs):
            idx = np.random.RandomState(ep).permutation(n)
            for start in range(0, n, batch_size):
                sel = idx[start:start + batch_size]
                self.loss_list.append(
                    self.vfl.fit_batch([x[sel] for x in party_xs_train], y_train[sel]))
            pred = self.vfl.predict(party_xs_test)
            acc = float(np.mean((pred > 0.5) == (np.asarray(y_test) > 0.5)))
            metrics = {"epoch": ep, "loss": self.loss_list[-1], "test_acc": acc}
            log.info("vfl epoch %d: %s", ep, metrics)
        return metrics
