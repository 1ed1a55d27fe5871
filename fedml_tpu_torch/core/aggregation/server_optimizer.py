"""Server-side optimizers for FedOpt: counterpart of
``fedml_tpu/core/aggregation/server_optimizer.py``.

FedOpt (Reddi et al. 2021) treats ``w_global - w_avg`` as a pseudo-gradient
and steps a stateful server optimizer with it. The JAX package builds the
optimizers with optax; here ``sgd`` is ``torch.optim.SGD`` (optax's trace
momentum is torch's momentum with ``dampening=0``) and ``adam`` is
``torch.optim.Adam`` (the same bias-corrected update, ``b2=0.99``,
``eps=1e-3``). Torch has no Yogi: :func:`yogi_step` writes ``optax.yogi``
out (moments start at 1e-6) and :class:`Yogi` steps it.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Iterable, Optional

import torch

from ...utils.pytree import tree_clone

log = logging.getLogger(__name__)

StateDict = Dict[str, torch.Tensor]

YOGI_INITIAL_ACCUMULATOR = 1e-6  # optax.scale_by_yogi's default


@torch.no_grad()
def yogi_step(p: torch.Tensor, g: torch.Tensor, state: dict, lr: float, b1: float,
              b2: float, eps: float) -> None:
    """One Yogi step on ``p`` in place, as optax.yogi computes it:
    m <- (1-b1) g + b1 m;  v <- v - (1-b2) sign(v - g^2) g^2;
    p <- p - lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)."""
    if not state:
        state["step"] = 0
        state["mu"] = torch.full_like(p, YOGI_INITIAL_ACCUMULATOR)
        state["nu"] = torch.full_like(p, YOGI_INITIAL_ACCUMULATOR)
    mu, nu = state["mu"], state["nu"]
    g2 = g * g
    mu.mul_(b1).add_(g, alpha=1 - b1)
    nu.sub_((1 - b2) * torch.sign(nu - g2) * g2)
    state["step"] += 1
    t = state["step"]
    mu_hat = mu / (1 - b1 ** t)
    nu_hat = nu / (1 - b2 ** t)
    p.sub_(lr * (mu_hat / (torch.sqrt(nu_hat) + eps)))


class Yogi(torch.optim.Optimizer):
    """``optax.yogi`` as a torch optimizer (see :func:`yogi_step`)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, b1: float = 0.9,
                 b2: float = 0.99, eps: float = 1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    yogi_step(p, p.grad, self.state[p], group["lr"], group["b1"], group["b2"],
                              group["eps"])


def create_server_optimizer(args: Any, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    name = str(getattr(args, "server_optimizer", "sgd")).lower()
    lr = float(getattr(args, "server_lr", 1.0))
    momentum = float(getattr(args, "server_momentum", 0.9))
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=max(momentum, 0.0), dampening=0.0)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.99), eps=1e-3)
    if name == "yogi":
        return Yogi(params, lr=lr)
    raise ValueError(f"unknown server optimizer {name!r}")


class FedOptServer:
    """Holds the server optimizer and its state across rounds.
    :meth:`apply` returns the new global state dict; it does not alias its
    inputs."""

    def __init__(self, args: Any, params_template: StateDict):
        self._params = tree_clone(params_template)
        self.opt = create_server_optimizer(args, list(self._params.values()))

    @property
    def state(self) -> dict:
        return self.opt.state_dict()

    @state.setter
    def state(self, value: dict) -> None:
        """Load a saved ``state`` (a resumed round); the optimizer moves its
        tensors to the params' device."""
        self.opt.load_state_dict(value)

    @torch.no_grad()
    def apply(self, w_global: StateDict, w_avg: StateDict) -> StateDict:
        for k, p in self._params.items():
            p.copy_(w_global[k])
            p.grad = w_global[k] - w_avg[k]  # the pseudo-gradient, -delta
        self.opt.step()
        return tree_clone(self._params)


def _mesh_devices(spec: str, visible: int) -> int:
    """Devices a server-mesh spec (``"auto"``, ``"fsdp:4"``, ``"dp:2,fsdp:-1"``)
    asks for, the JAX package's rule: an auto axis takes what the fixed axes
    leave of the visible devices."""
    spec = spec.strip().lower()
    sizes = [-1] if spec == "auto" else [
        -1 if s.strip() in ("auto", "-1", "*") else int(s)
        for s in (part.partition(":")[2] for part in spec.split(","))]
    fixed = 1
    for s in sizes:
        fixed *= s if s != -1 else 1
    total = 1
    for s in sizes:
        total *= s if s != -1 else max(1, visible // fixed)
    return total


def _visible_devices(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def create_fedopt_server(args: Any, params_template: StateDict) -> FedOptServer:
    """The FedOpt server. A server mesh over more than one device
    (``args.server_mesh`` or ``FEDML_SERVER_MESH``) shards the JAX package's
    server state; that path is not ported and raises. A spec that resolves to
    one device, or to more devices than are visible, keeps the single-device
    server, as in the JAX package."""
    spec: Optional[str] = getattr(args, "server_mesh", None) or os.environ.get(
        "FEDML_SERVER_MESH", "").strip() or None
    if spec:
        visible = _visible_devices(next(iter(params_template.values())).device)
        total = _mesh_devices(str(spec), visible)
        if 1 < total <= visible:
            raise NotImplementedError(
                f"server_mesh {spec!r} over {total} devices: the sharded FedOpt server "
                "is not ported to fedml_tpu_torch (see ROADMAP.md, Queue 1)")
        if total > visible:
            log.warning("server mesh spec %r needs %d devices but only %d are visible; "
                        "using the single-device server", spec, total, visible)
    return FedOptServer(args, params_template)
