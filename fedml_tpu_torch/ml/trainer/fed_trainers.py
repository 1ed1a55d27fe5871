"""Algorithm-specific client trainers: counterpart of
``fedml_tpu/ml/trainer/fed_trainers.py`` (reference
``ml/trainer/{fedprox,fednova,scaffold,feddyn,mime}_trainer.py``).

Each variant reuses the local loop (``local_sgd.py``) with a gradient
transform and/or a structured round payload:

  - FedProx  — proximal term in the loss (mu), payload = plain weights.
  - FedNova  — payload ``(a_i, d_i)`` with normalized direction d_i.
  - SCAFFOLD — control variates; payload ``(delta_w, delta_c)``.
  - FedDyn   — per-client dual variable folded into the gradient.
  - Mime     — server momentum applied statelessly + full-batch grad payload.

In simulation one trainer serves every client (``set_id`` swaps the active
one), so the per-client state (SCAFFOLD's ``c_local``, FedDyn's ``lam``) is
kept per trainer id. State dicts live on the trainer's device. Every trainer
keeps the per-(client, round) seed of :func:`round_seed`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ...models.model_hub import FedModel
from ...utils.pytree import StateDict, tree_scale, tree_sub, tree_zeros_like
from .classification_trainer import ClassificationTrainer, round_seed
from .local_sgd import make_local_train_fn, masked_loss


class FedProxTrainer(ClassificationTrainer):
    """mu is consumed inside the loss (local_sgd.make_local_train_fn)."""

    def __init__(self, model: FedModel, args: Any):
        if not getattr(args, "fedprox_mu", None):
            args.fedprox_mu = 0.1
        super().__init__(model, args)


def _num_steps(n: int, batch_size: int, epochs: int) -> int:
    return max(1, -(-n // batch_size)) * epochs


class FedNovaTrainer(ClassificationTrainer):
    """Returns (a_i, d_i): local-step scale + normalized direction.

    For SGD with momentum rho over tau steps:
      a_i = (tau - rho (1 - rho^tau) / (1 - rho)) / (1 - rho); rho=0 -> tau.
    d_i = (w_global - w_local) / a_i  (lr folded into the server rule via
    agg_operator.fednova_aggregate).
    """

    def train(self, train_data, device=None, args: Any = None):
        args = args or self.args
        w_global = self.get_model_params()
        super().train(train_data, device, args)
        tau = _num_steps(len(train_data), int(getattr(args, "batch_size", 32)),
                         int(getattr(args, "epochs", 1)))
        rho = float(getattr(args, "momentum", 0.0))
        if rho > 0:
            a_i = (tau - rho * (1 - rho**tau) / (1 - rho)) / (1 - rho)
        else:
            a_i = float(tau)
        d_i = tree_scale(tree_sub(w_global, self.get_model_params()), 1.0 / a_i)
        self.round_payload = (a_i, d_i)
        return self.round_payload


class ScaffoldTrainer(ClassificationTrainer):
    """SCAFFOLD control-variate trainer (Karimireddy et al. 2020).

    The gradient correction g + c - c_i goes through the local loop's
    gradient transform; the c_i update is option II of the paper:
    c_i+ = c_i - c + (w_g - w_l) / (K * lr), K the local steps taken.
    """

    def __init__(self, model: FedModel, args: Any):
        super().__init__(model, args)

        def correct(grads, params, global_params, extras):
            c_global, c_local = extras
            return {k: g + c_global[k] - c_local[k] for k, g in grads.items()}

        self._local_train = make_local_train_fn(model, args, grad_transform=correct)
        self._c_local_by_client: Dict[int, StateDict] = {}
        self.c_global = tree_zeros_like(model.params)

    @property
    def c_local(self) -> StateDict:
        if self.id not in self._c_local_by_client:
            self._c_local_by_client[self.id] = tree_zeros_like(self.model.params)
        return self._c_local_by_client[self.id]

    @c_local.setter
    def c_local(self, value: StateDict) -> None:
        self._c_local_by_client[self.id] = value

    def set_control_variate(self, c_global: StateDict) -> None:
        self.c_global = c_global

    def train(self, train_data, device=None, args: Any = None):
        args = args or self.args
        w_global = self.get_model_params()
        self._local_round(train_data, args, (self.c_global, self.c_local))
        w_local = self.get_model_params()
        K = float(self.last_steps)
        lr = float(getattr(args, "learning_rate", 0.03))
        c_local, c_global = self.c_local, self.c_global
        new_c_local = {k: c_local[k] - c_global[k] + (w_global[k] - w_local[k]) / (K * lr)
                       for k in c_local}
        delta_w = tree_sub(w_local, w_global)
        delta_c = tree_sub(new_c_local, c_local)
        self.c_local = new_c_local
        self.round_payload = (delta_w, delta_c)
        return self.round_payload


class FedDynTrainer(ClassificationTrainer):
    """FedDyn (Acar et al. 2021): dynamic regularizer via per-client dual.

    Gradient: g - lambda_i + alpha (w - w_global); after the round:
    lambda_i <- lambda_i - alpha (w_local - w_global).
    """

    def __init__(self, model: FedModel, args: Any):
        super().__init__(model, args)
        self.alpha = float(getattr(args, "feddyn_alpha", 0.01))
        a = self.alpha

        def correct(grads, params, global_params, extras):
            lam = extras
            return {k: g - lam[k] + a * (params[k] - global_params[k]) for k, g in grads.items()}

        self._local_train = make_local_train_fn(model, args, grad_transform=correct)
        self._lam_by_client: Dict[int, StateDict] = {}

    @property
    def lam(self) -> StateDict:
        if self.id not in self._lam_by_client:
            self._lam_by_client[self.id] = tree_zeros_like(self.model.params)
        return self._lam_by_client[self.id]

    @lam.setter
    def lam(self, value: StateDict) -> None:
        self._lam_by_client[self.id] = value

    def train(self, train_data, device=None, args: Any = None):
        args = args or self.args
        w_global = self.get_model_params()
        self._local_round(train_data, args, self.lam)
        w_local = self.get_model_params()
        lam = self.lam
        self.lam = {k: lam[k] - self.alpha * (w_local[k] - w_global[k]) for k in lam}
        return w_local


class MimeTrainer(ClassificationTrainer):
    """MimeLite (Karimireddy et al. 2021): apply the *server* momentum
    statelessly during local steps; ship back a full-batch gradient at the
    received weights for the server's momentum update."""

    def __init__(self, model: FedModel, args: Any):
        super().__init__(model, args)
        self.beta = float(getattr(args, "mime_beta", 0.9))
        b = self.beta

        def correct(grads, params, global_params, extras):
            s = extras  # server momentum
            return {k: (1.0 - b) * g + b * s[k] for k, g in grads.items()}

        self._local_train = make_local_train_fn(model, args, grad_transform=correct)
        self.server_momentum = tree_zeros_like(model.params)

    def set_server_momentum(self, s: StateDict) -> None:
        self.server_momentum = s

    def _full_grad(self, train_data, seed: int) -> StateDict:
        """The gradient of the masked loss over the whole shard (mask all
        ones, training mode) at the weights the module holds."""
        x = torch.from_numpy(np.ascontiguousarray(train_data.x)).to(self.device)
        y = torch.from_numpy(np.ascontiguousarray(train_data.y)).to(self.device)
        rng = torch.Generator(device=self.device).manual_seed(seed)
        params = dict(self.model.module.named_parameters())
        loss = masked_loss(self.model.module(x, train=True, rng=rng), y,
                           torch.ones(len(train_data), device=self.device))
        grads = torch.autograd.grad(loss, list(params.values()))
        return dict(zip(params, grads))

    def train(self, train_data, device=None, args: Any = None):
        args = args or self.args
        # the full-batch gradient at the received model (for the server momentum)
        full_grad = self._full_grad(train_data, round_seed(args, self.id, self._round))
        self._local_round(train_data, args, self.server_momentum)
        self.round_payload = (self.get_model_params(), full_grad)
        return self.round_payload
