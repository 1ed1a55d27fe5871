"""FedGKT (group knowledge transfer): counterpart of
``fedml_tpu/simulation/sp/fedgkt.py`` (reference ``simulation/mpi/fedgkt``).

Each client trains a small feature extractor with a local head on its
labels plus a KL distillation from the server's logits; it uploads
(features, labels, local logits) of its whole shard; the server trains the
big head on those features with CE plus KL from the client's logits and
returns per-sample logits for the next round's distillation. Only
features and logits cross the boundary, never raw data or the big model.

As in the JAX package: a fresh client optimizer each round (its
``client_epoch`` initialises it inside the step), one server optimizer for
the run, no distillation in a client's first round (there are no server
logits yet), and the shuffles from ``numpy`` generators seeded per round
and client. The optimizers map optax's to torch's (``split_nn.py`` states
Adam's difference; ``sgd`` with momentum 0.9 is the same update in both).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...models.layers import flax_init_
from ...models.split_model import SplitClientNet, SplitServerNet
from .split_nn import adam_lr

log = logging.getLogger(__name__)


def kl_soft(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float) -> torch.Tensor:
    """The JAX package's ``_kl_soft``: KL(teacher || student) at
    ``temperature``, the teacher clipped at 1e-8 under the log, times T^2."""
    s = F.log_softmax(student_logits / temperature, dim=-1)
    t = F.softmax(teacher_logits / temperature, dim=-1)
    return (t * (torch.log(torch.clamp(t, min=1e-8)) - s)).sum(-1).mean() * temperature ** 2


class FedGKTAPI:
    def __init__(self, args: Any, device, dataset, model=None, client_trainer=None,
                 server_aggregator=None):
        self.args = args
        self.device = torch.device(device)
        [_tr_num, _te_num, _tr_g, self.test_global,
         self.train_num_dict, self.train_local, _te_local, class_num] = dataset
        self.class_num = int(class_num)
        width = int(getattr(args, "gkt_width", 8))
        self.temperature = float(getattr(args, "gkt_temperature", 3.0))
        self.alpha = float(getattr(args, "gkt_alpha", 1.0))  # KD weight
        in_ch = int(self.train_local[0].x.shape[-1])
        n_clients = int(getattr(args, "client_num_in_total", len(self.train_local)))
        gen = torch.Generator().manual_seed(int(getattr(args, "random_seed", 0)))
        self.client_nets = [
            flax_init_(SplitClientNet(self.class_num, width, with_logits=True, in_channels=in_ch),
                       gen).to(self.device)
            for _ in range(n_clients)]
        self.server_net = flax_init_(SplitServerNet(self.class_num, width, blocks_per_stage=1),
                                     gen).to(self.device)
        opt_name = str(getattr(args, "gkt_optimizer", "adam")).lower()
        if opt_name == "adam":
            lr = adam_lr(args, "gkt_learning_rate")
            self._make_opt = lambda params: torch.optim.Adam(params, lr=lr)
        else:
            lr = float(getattr(args, "learning_rate", 0.01))
            self._make_opt = lambda params: torch.optim.SGD(params, lr=lr, momentum=0.9)
        self.opt_s = self._make_opt(self.server_net.parameters())
        self.metrics_history: List[Dict[str, float]] = []

    def _batches(self, n: int, seed: int) -> np.ndarray:
        """``[epochs * nb, bs]`` sample indices, the JAX package's draws."""
        bs = int(getattr(self.args, "batch_size", 32))
        epochs = int(getattr(self.args, "epochs", 1))
        rng = np.random.default_rng(seed)
        nb = max(1, n // bs)
        idx = np.stack([rng.permutation(n)[: nb * bs].reshape(nb, bs) for _ in range(epochs)])
        return idx.reshape(epochs * nb, bs)

    def _client_epoch(self, net, x_all, y_all, server_logits, batches, kd_alpha) -> float:
        """CE plus KD from the server's logits on the client's small net,
        from a fresh optimizer; the mean of the steps' losses."""
        opt = self._make_opt(net.parameters())
        losses = []
        for bidx in torch.from_numpy(batches).to(self.device):
            x, y, tl = x_all[bidx], y_all[bidx], server_logits[bidx]
            _, logits = net(x)
            loss = F.cross_entropy(logits, y) + kd_alpha * kl_soft(logits, tl, self.temperature)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return float(torch.stack(losses).mean())

    def _server_epoch(self, feats_all, y_all, client_logits, batches) -> float:
        """CE plus KD from the client's logits on the big head."""
        losses = []
        for bidx in torch.from_numpy(batches).to(self.device):
            f, y, tl = feats_all[bidx], y_all[bidx], client_logits[bidx]
            logits = self.server_net(f)
            loss = F.cross_entropy(logits, y) + self.alpha * kl_soft(logits, tl, self.temperature)
            self.opt_s.zero_grad(set_to_none=True)
            loss.backward()
            self.opt_s.step()
            losses.append(loss.detach())
        return float(torch.stack(losses).mean())

    def train(self) -> Dict[str, float]:
        rounds = int(getattr(self.args, "comm_round", 2))
        n_clients = len(self.client_nets)
        server_logits: Dict[int, Optional[torch.Tensor]] = {c: None for c in range(n_clients)}
        for round_idx in range(rounds):
            bank = []
            c_losses = []
            for cid in range(n_clients):
                data = self.train_local[cid]
                x_all = torch.from_numpy(data.x).to(self.device)
                y_all = torch.from_numpy(data.y).to(self.device)
                t_logits = server_logits[cid]
                kd_alpha = self.alpha if t_logits is not None else 0.0
                if t_logits is None:
                    t_logits = torch.zeros((len(data), self.class_num), device=self.device)
                net = self.client_nets[cid]
                c_losses.append(self._client_epoch(
                    net, x_all, y_all, t_logits, self._batches(len(data), round_idx * 97 + cid),
                    kd_alpha))
                with torch.no_grad():
                    feats, logits = net(x_all)
                bank.append((cid, feats, y_all, logits))
            # ── boundary: only (features, labels, logits) reach the server ──
            s_losses = [self._server_epoch(feats, y_all, logits,
                                           self._batches(feats.shape[0], round_idx * 131 + cid))
                        for cid, feats, y_all, logits in bank]
            with torch.no_grad():
                for cid, feats, _, _ in bank:
                    server_logits[cid] = self.server_net(feats)
            metrics = self._test()
            metrics.update(round=round_idx, client_loss=float(np.mean(c_losses)),
                           server_loss=float(np.mean(s_losses)))
            self.metrics_history.append(metrics)
            log.info("fedgkt round %d: %s", round_idx, metrics)
        return self.metrics_history[-1]

    @torch.no_grad()
    def _test(self) -> Dict[str, float]:
        """Client 0's extractor and the server's head on the global test
        set, as the reference evaluates the deployed pair."""
        net = self.client_nets[0]
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = 0.0
        for bx, by in self.test_global.batches(64):
            feats, _ = net(torch.from_numpy(bx).to(self.device))
            logits = self.server_net(feats)
            correct += (logits.argmax(-1) == torch.from_numpy(by).to(self.device)).sum()
            total += len(by)
        return {"test_acc": float(correct) / max(total, 1.0), "test_total": total}
