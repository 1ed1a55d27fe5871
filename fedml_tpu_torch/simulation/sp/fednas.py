"""FedNAS, federated neural architecture search on a DARTS supernet:
counterpart of ``fedml_tpu/simulation/sp/fednas.py`` (reference
``simulation/mpi/fednas/``).

Each client alternates DARTS's bi-level steps on its data halved: an
architecture step (the alphas, ``arch``) on a validation batch, then a
weight step on a training batch. The server FedAvg-folds weights and alphas
alike, and the searched architecture is the argmax genotype of the folded
alphas.

The JAX package steps two optax transforms over the whole tree, each with
the other's gradients zeroed: SGD with momentum 0.9 on the weights, Adam on
``arch``. A zero gradient leaves SGD's momentum trace at zero and Adam's
moments at zero, and so moves nothing, so the port steps
``torch.optim.SGD(momentum=0.9)`` over the weights and
``torch.optim.Adam`` over ``arch`` alone: the same updates (Adam's float32
rounding as ``sp/split_nn.py`` states it). The batches are numpy's, two
draws from ``default_rng(round_idx * 31 + cid)``, bit for bit. Images go to
the device in the model's dtype, as JAX promotes them.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...models.darts import derive_genotype
from ...utils.pytree import StateDict, stacked_weighted_average

log = logging.getLogger(__name__)


class FedNASAPI:
    def __init__(self, args: Any, device, dataset, model, client_trainer=None,
                 server_aggregator=None):
        self.args = args
        [_tr_num, _te_num, _tr_g, self.test_global,
         self.train_num_dict, self.train_local, _te_local, self.class_num] = dataset
        self.model = model  # FedModel over DARTSNetwork
        self.device = torch.device(device) if device is not None else model.device
        self.w_lr = float(getattr(args, "learning_rate", 0.025))
        self.a_lr = float(getattr(args, "arch_learning_rate", 3e-3))
        self.metrics_history: List[Dict[str, float]] = []

    @property
    def _dtype(self) -> torch.dtype:
        return self.model.module.arch.dtype

    def _local_search(self, params: StateDict, x_tr, y_tr, x_val, y_val, tr_idx: torch.Tensor,
                      val_idx: torch.Tensor) -> Tuple[StateDict, torch.Tensor, torch.Tensor]:
        module = self.model.module
        named = dict(module.named_parameters())
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(params[k])
        weights = [p for k, p in named.items() if k != "arch"]
        opt_w = torch.optim.SGD(weights, lr=self.w_lr, momentum=0.9)
        opt_a = torch.optim.Adam([module.arch], lr=self.a_lr)
        lw, la = [], []
        for s in range(tr_idx.shape[0]):
            # 1) the alpha step on the validation batch (the bi-level outer)
            loss_a = F.cross_entropy(module(x_val.index_select(0, val_idx[s])),
                                     y_val.index_select(0, val_idx[s]))
            (module.arch.grad,) = torch.autograd.grad(loss_a, [module.arch])
            opt_a.step()
            # 2) the weight step on the training batch (the inner)
            loss_w = F.cross_entropy(module(x_tr.index_select(0, tr_idx[s])),
                                     y_tr.index_select(0, tr_idx[s]))
            for p, g in zip(weights, torch.autograd.grad(loss_w, weights)):
                p.grad = g
            opt_w.step()
            lw.append(loss_w.detach())
            la.append(loss_a.detach())
        return ({k: p.detach().clone() for k, p in named.items()},
                torch.stack(lw).mean(), torch.stack(la).mean())

    def _split_batches(self, cid: int, seed: int):
        """The client's data halved into train/val (reference fednas data
        split), each half's batch indices from one ``default_rng(seed)``."""
        data = self.train_local[cid]
        n = len(data)
        half = max(1, n // 2)
        bs = min(int(getattr(self.args, "batch_size", 32)), half)
        epochs = int(getattr(self.args, "epochs", 1))
        rng = np.random.default_rng(seed)
        nb = max(1, half // bs)

        def idx(offset):
            return torch.from_numpy(np.stack([
                offset + rng.permutation(half)[: nb * bs].reshape(nb, bs) for _ in range(epochs)
            ]).reshape(epochs * nb, bs)).to(self.device)

        x = torch.from_numpy(np.ascontiguousarray(data.x)).to(self.device, self._dtype)
        y = torch.from_numpy(np.ascontiguousarray(data.y)).to(self.device).long()
        return x[:half], y[:half], x[half:2 * half], y[half:2 * half], idx(0), idx(0)

    def train(self) -> Dict[str, float]:
        args = self.args
        w_global = self.model.params
        rounds = int(getattr(args, "comm_round", 2))
        n_clients = int(getattr(args, "client_num_in_total", len(self.train_local)))
        for round_idx in range(rounds):
            locals_, weights, lw_m, la_m = [], [], [], []
            for cid in range(n_clients):
                batches = self._split_batches(cid, round_idx * 31 + cid)
                params, lw, la = self._local_search(w_global, *batches)
                locals_.append(params)
                weights.append(float(self.train_num_dict[cid]))
                lw_m.append(float(lw))
                la_m.append(float(la))
            w = torch.tensor(weights, dtype=torch.float64 if self._dtype == torch.float64
                             else torch.float32, device=self.device)
            w_global = stacked_weighted_average(locals_, w / w.sum())
            metrics = self._test(w_global)
            metrics.update(round=round_idx, weight_loss=float(np.mean(lw_m)),
                           arch_loss=float(np.mean(la_m)))
            self.metrics_history.append(metrics)
            log.info("fednas round %d: %s", round_idx, metrics)
        self.model = dataclasses.replace(self.model, params=w_global)
        return self.metrics_history[-1]

    def genotype(self):
        """The searched architecture, discretised from the folded alphas."""
        return derive_genotype(self.model.params["arch"])

    @torch.no_grad()
    def _test(self, params: StateDict) -> Dict[str, float]:
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = 0.0
        for bx, by in self.test_global.batches(64):
            logits = self.model.apply(params, torch.from_numpy(bx).to(self.device, self._dtype))
            correct += (logits.argmax(-1) == torch.from_numpy(by).to(self.device)).sum()
            total += len(by)
        return {"test_acc": float(correct) / max(total, 1.0), "test_total": total}
