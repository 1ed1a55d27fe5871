"""Federated GAN simulation: counterpart of
``fedml_tpu/simulation/sp/fedgan.py`` (reference ``simulation/mpi/fedgan/``).

Each client runs local GAN steps, a discriminator step on real local data
against generated images and then a generator step against the
discriminator (the non-saturating loss), and the server FedAvg-folds both
halves of the pair.

The JAX package steps one ``optax.adam(lr, b1=0.5)`` over the whole pair,
twice a batch, with the other half's gradients set to zero. optax then
still moves the frozen half by its first moment, and its step count
advances on every update. ``torch.optim.Adam`` skips a parameter whose
``grad`` is None, so the port writes zeros, never None, into the frozen
half: the same update. The float32 rounding of Adam differs in the order
of operations (``sp/split_nn.py`` states it).

The latents: JAX draws each step's z with ``jax.random`` from
``PRNGKey(cid + round_idx)``, which torch cannot reproduce. The port draws
them from a CPU ``torch.Generator`` seeded the same way (:meth:`FedGANAPI.
_latents`), so the card and the CPU draw the same z, and
:meth:`FedGANAPI.local_train` takes them as an explicit tensor
``[steps, 2, b, latent]`` (D's z, then G's). The batches are numpy's,
``default_rng(round_idx * 1000 + cid)``, and the sampling
``np.random.seed(round_idx)``, bit for bit.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.pytree import StateDict, stacked_weighted_average

log = logging.getLogger(__name__)


def _bce(logits: torch.Tensor, label: float) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy(logits, label).mean()."""
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, label))


class FedGANAPI:
    def __init__(self, args: Any, device, dataset, model, client_trainer=None,
                 server_aggregator=None):
        self.args = args
        [_tr_num, _te_num, _tr_g, self.test_global,
         self.train_num_dict, self.train_local, _te_local, _cn] = dataset
        self.model = model  # FedModel over GANPair
        self.device = torch.device(device) if device is not None else model.device
        self.latent_dim = int(getattr(model.module, "latent_dim", 64))
        self.lr = float(getattr(args, "learning_rate", 2e-4))
        self.metrics_history: List[Dict[str, float]] = []

    def local_train(self, params: StateDict, x_all: torch.Tensor, batches_idx: torch.Tensor,
                    z: torch.Tensor) -> Tuple[StateDict, torch.Tensor, torch.Tensor]:
        """One client's local phase from ``params``: for each row of
        ``batches_idx`` [steps, b], a D step on ``z[s, 0]`` and a G step on
        ``z[s, 1]``. -> (params, mean D loss, mean G loss), on the device."""
        module = self.model.module
        named = dict(module.named_parameters())
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(params[k])
        halves = {h: [p for k, p in named.items() if k.startswith(h + ".")]
                  for h in ("discriminator", "generator")}
        zeros = {h: [torch.zeros_like(p) for p in ps] for h, ps in halves.items()}
        opt = torch.optim.Adam(list(named.values()), lr=self.lr, betas=(0.5, 0.999), eps=1e-8)

        def step(half: str, loss: torch.Tensor) -> None:
            other = "generator" if half == "discriminator" else "discriminator"
            for p, g in zip(halves[half], torch.autograd.grad(loss, halves[half])):
                p.grad = g
            for p, g in zip(halves[other], zeros[other]):
                p.grad = g
            opt.step()

        d_losses, g_losses = [], []
        for s in range(batches_idx.shape[0]):
            x_real = x_all.index_select(0, batches_idx[s])
            with torch.no_grad():
                fake = module.generate(z[s, 0])
            dl = _bce(module.discriminate(x_real), 1.0) + _bce(module.discriminate(fake), 0.0)
            step("discriminator", dl)
            gl = _bce(module.discriminate(module.generate(z[s, 1])), 1.0)
            step("generator", gl)
            d_losses.append(dl.detach())
            g_losses.append(gl.detach())
        return ({k: p.detach().clone() for k, p in named.items()},
                torch.stack(d_losses).mean(), torch.stack(g_losses).mean())

    def _client_batches(self, cid: int, seed: int) -> np.ndarray:
        data = self.train_local[cid]
        bs = int(getattr(self.args, "batch_size", 32))
        epochs = int(getattr(self.args, "epochs", 1))
        rng = np.random.default_rng(seed)
        n = len(data)
        nb = max(1, n // bs)
        idx = np.stack([rng.permutation(n)[: nb * bs].reshape(nb, bs) for _ in range(epochs)])
        return idx.reshape(epochs * nb, bs)

    def _latents(self, cid: int, round_idx: int, steps: int, b: int) -> torch.Tensor:
        """[steps, 2, b, latent] unit normals from a CPU generator seeded with
        ``cid + round_idx`` (JAX's key), on the device."""
        g = torch.Generator().manual_seed(cid + round_idx)
        return torch.randn((steps, 2, b, self.latent_dim), generator=g).to(self.device)

    def train(self) -> Dict[str, float]:
        args = self.args
        w_global = self.model.params
        dtype = next(iter(w_global.values())).dtype
        rounds = int(getattr(args, "comm_round", 2))
        n_total = int(getattr(args, "client_num_in_total", len(self.train_local)))
        per_round = min(int(getattr(args, "client_num_per_round", n_total)), n_total)
        for round_idx in range(rounds):
            np.random.seed(round_idx)  # reference sampling seed (fedavg_api.py:132)
            sampled = (list(range(n_total)) if per_round == n_total
                       else list(np.random.choice(range(n_total), per_round, replace=False)))
            locals_, weights, dl_m, gl_m = [], [], [], []
            for cid in sampled:
                cid = int(cid)
                x_all = torch.from_numpy(np.ascontiguousarray(self.train_local[cid].x)).to(
                    self.device, dtype)
                idx = self._client_batches(cid, round_idx * 1000 + cid)
                z = self._latents(cid, round_idx, idx.shape[0], idx.shape[1]).to(dtype)
                params, dl, gl = self.local_train(
                    w_global, x_all, torch.from_numpy(idx).to(self.device), z)
                locals_.append(params)
                weights.append(float(self.train_num_dict[cid]))
                dl_m.append(float(dl))
                gl_m.append(float(gl))
            w = torch.tensor(weights, dtype=torch.float64 if dtype == torch.float64
                             else torch.float32, device=self.device)
            w_global = stacked_weighted_average(locals_, w / w.sum())
            metrics = {"round": round_idx, "d_loss": float(np.mean(dl_m)),
                       "g_loss": float(np.mean(gl_m))}
            self.metrics_history.append(metrics)
            log.info("fedgan round %d: %s", round_idx, metrics)
        self.model = dataclasses.replace(self.model, params=w_global)
        return self.metrics_history[-1]

    @torch.no_grad()
    def generate(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` images [n, H, W, C] from the global generator, z from a CPU
        generator seeded with ``seed``."""
        module = self.model.module
        for k, p in module.named_parameters():
            p.copy_(self.model.params[k])
        z = torch.randn((n, self.latent_dim), generator=torch.Generator().manual_seed(seed))
        return module.generate(z.to(self.device, p.dtype)).cpu().numpy()
