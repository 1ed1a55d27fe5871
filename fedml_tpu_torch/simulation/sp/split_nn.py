"""Split NN (split learning): counterpart of
``fedml_tpu/simulation/sp/split_nn.py`` (reference
``simulation/mpi/split_nn``).

The model is cut at an activation boundary (``models/split_model.py``): each
client owns the bottom half, the server the top. Per batch the client sends
its features up, the server computes the loss, updates its half and returns
the features' gradient, and the client back-propagates it through its half.
Clients train in a relay: client i's bottom weights pass on to client i+1,
with no averaging. The two halves stay separate modules and exchange only
the feature and gradient tensors, which is what would cross the wire.

Adam: the JAX package's ``optax.adam(lr)`` maps to ``torch.optim.Adam(lr)``
with the same betas (0.9, 0.999) and epsilon (1e-8, added outside the
square root in both). The update is the same function; the float32
rounding differs in the order of operations (torch divides the square root
of v by the root of the bias correction, optax takes the root of the
bias-corrected v), at a few ulps of each update.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ...models.layers import flax_init_
from ...models.split_model import SplitClientNet, SplitServerNet

log = logging.getLogger(__name__)


def adam_lr(args: Any, name: str) -> float:
    """The JAX package's Adam rate: ``args.<name>`` when set, else the
    config's ``learning_rate`` capped at 1e-3 (it is tuned for SGD)."""
    return float(getattr(args, name, min(float(getattr(args, "learning_rate", 1e-3)), 1e-3)))


class SplitNNAPI:
    def __init__(self, args: Any, device, dataset, model=None, client_trainer=None,
                 server_aggregator=None):
        self.args = args
        self.device = torch.device(device)
        [_tr_num, _te_num, _tr_g, self.test_global,
         self.train_num_dict, self.train_local, _te_local, class_num] = dataset
        self.class_num = int(class_num)
        width = int(getattr(args, "split_width", 16))
        in_ch = int(self.train_local[0].x.shape[-1])
        gen = torch.Generator().manual_seed(int(getattr(args, "random_seed", 0)))
        self.client_net = flax_init_(SplitClientNet(self.class_num, width, with_logits=False,
                                                    in_channels=in_ch), gen).to(self.device)
        self.server_net = flax_init_(SplitServerNet(self.class_num, width, blocks_per_stage=1),
                                     gen).to(self.device)
        # adam: the split boundary decouples the halves' gradient scales,
        # which plain SGD handles poorly on the narrow client stem
        lr = adam_lr(args, "split_learning_rate")
        self.opt_c = torch.optim.Adam(self.client_net.parameters(), lr=lr)
        self.opt_s = torch.optim.Adam(self.server_net.parameters(), lr=lr)
        self.metrics_history: List[Dict[str, float]] = []

    def _step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One batch across the boundary; returns the server's loss."""
        feats = self.client_net(x)                                # ── wire up
        feats_s = feats.detach().requires_grad_(True)
        loss = F.cross_entropy(self.server_net(feats_s), y)
        self.opt_s.zero_grad(set_to_none=True)
        loss.backward()
        self.opt_s.step()                                          # ── wire down
        self.opt_c.zero_grad(set_to_none=True)
        feats.backward(feats_s.grad)
        self.opt_c.step()
        return loss.detach()

    def _train_client(self, cid: int) -> float:
        data = self.train_local[cid]
        bs = int(getattr(self.args, "batch_size", 32))
        epochs = int(getattr(self.args, "epochs", 1))
        losses = []
        for ep in range(epochs):
            for bx, by in data.batches(bs, shuffle=True, seed=ep, drop_last=True):
                x = torch.from_numpy(bx).to(self.device)
                y = torch.from_numpy(by).to(self.device)
                losses.append(float(self._step(x, y)))
        return float(np.mean(losses)) if losses else 0.0

    def train(self) -> Dict[str, float]:
        rounds = int(getattr(self.args, "comm_round", 2))
        n_clients = int(getattr(self.args, "client_num_in_total", len(self.train_local)))
        for round_idx in range(rounds):
            # relay: the bottom weights pass client to client, no averaging
            round_loss = [self._train_client(cid) for cid in range(n_clients)]
            metrics = self._test()
            metrics.update(round=round_idx, train_loss=float(np.mean(round_loss)))
            self.metrics_history.append(metrics)
            log.info("splitnn round %d: %s", round_idx, metrics)
        return self.metrics_history[-1]

    @torch.no_grad()
    def _test(self) -> Dict[str, float]:
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = 0.0
        for bx, by in self.test_global.batches(64):
            logits = self.server_net(self.client_net(torch.from_numpy(bx).to(self.device)))
            correct += (logits.argmax(-1) == torch.from_numpy(by).to(self.device)).sum()
            total += len(by)
        return {"test_acc": float(correct) / max(total, 1.0), "test_total": total}
