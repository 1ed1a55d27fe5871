"""Decentralized FL (DSGD and PushSum): counterpart of
``fedml_tpu/simulation/sp/decentralized.py`` (reference
``simulation/sp/decentralized``).

Online learning where each client takes a local gradient step and then
averages with its topology's neighbours; PushSum handles directed
(column-stochastic) topologies through a push weight per client. As in the
JAX package, every client lives in one state dict with a leading client
axis: one iteration is a ``torch.func.vmap`` gradient step over that axis
and the mixing ``W @ stacked`` of every leaf, on the stack's device. The
mixing matrix is the JAX package's float32 matrix, cast to the parameters'
dtype (exactly, so a float64 run mixes with JAX's float32 weights as JAX
does under x64), and PushSum's weights stay float32 as there.

``FedML_decentralized_fl`` is a library API, outside the runner's dispatch,
in the JAX package too.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from ...core.distributed.topology.asymmetric_topology_manager import AsymmetricTopologyManager
from ...core.distributed.topology.symmetric_topology_manager import SymmetricTopologyManager
from ...device import resolve_device

log = logging.getLogger(__name__)

StateDict = Dict[str, torch.Tensor]


def mixing_matrix_from_topology(topology: np.ndarray) -> np.ndarray:
    """Row-normalise a 0/1 (or weighted) adjacency-plus-self matrix into a
    row-stochastic float32 mixing matrix (JAX's, copied)."""
    W = np.asarray(topology, dtype=np.float32)
    if not np.any(np.diag(W)):
        W = W + np.eye(len(W), dtype=np.float32)
    return W / W.sum(axis=1, keepdims=True)


def _per_client(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``w [n]`` shaped to broadcast over ``p [n, ...]``."""
    return w.reshape((-1,) + (1,) * (p.ndim - 1))


class DecentralizedFedSGD:
    """``iterations`` of decentralized SGD over a client-stacked state dict.

    ``loss_fn(params, x, y) -> scalar`` is one client's (``params`` a state
    dict without the client axis); the data is ``[n_clients, N, ...]``.
    ``mode='dsgd'`` mixes with the row-stochastic W, ``mode='pushsum'`` with
    its column-stochastic transpose and push weights."""

    def __init__(self, params_stacked: StateDict, loss_fn: Callable, topology: np.ndarray,
                 learning_rate: float = 0.1, mode: str = "dsgd"):
        self.n = len(np.asarray(topology))
        self.loss_fn = loss_fn
        self.lr = float(learning_rate)
        self.mode = mode
        self.params = params_stacked  # leaves [n_clients, ...]
        leaf = next(iter(params_stacked.values()))
        W = mixing_matrix_from_topology(topology)
        if mode == "pushsum":
            # push along out-edges: column-stochastic P = W^T normalised by
            # out-degree; push weights start at 1
            P = W.T / W.T.sum(axis=0, keepdims=True)
            self.push_weights: Optional[torch.Tensor] = torch.ones(self.n, device=leaf.device)
        else:
            P = W
            self.push_weights = None
        self._P32 = torch.from_numpy(np.ascontiguousarray(P)).to(leaf.device)
        self._P = self._P32.to(leaf.dtype)
        self._grad_and_loss = vmap(grad_and_value(loss_fn))
        self.loss_history: List[float] = []

    def _mix(self, stacked: StateDict) -> StateDict:
        return {k: (self._P @ v.reshape(v.shape[0], -1)).reshape(v.shape)
                for k, v in stacked.items()}

    def step(self, x_b: torch.Tensor, y_b: torch.Tensor) -> torch.Tensor:
        """One iteration; returns the clients' mean loss (a 0-d tensor)."""
        w = self.push_weights
        # PushSum's gradient is taken at the de-biased iterate z = x / w
        z = self.params if w is None else {k: p / _per_client(w, p) for k, p in self.params.items()}
        grads, losses = self._grad_and_loss(z, x_b, y_b)
        stepped = {k: p - self.lr * grads[k] for k, p in self.params.items()}
        self.params = self._mix(stepped)
        if w is not None:
            self.push_weights = self._P32 @ w
        return losses.mean()

    @property
    def effective_params(self) -> StateDict:
        """PushSum's de-biased estimate x / w; the params for DSGD."""
        w = self.push_weights
        if w is None:
            return self.params
        return {k: p / _per_client(w, p) for k, p in self.params.items()}

    def run(self, x_stream, y_stream, iterations: int, batch_size: int = 1) -> StateDict:
        """``x_stream [n_clients, N, d]``; each iteration takes the next
        batch (wrapping), as the reference's streaming loop does."""
        dev = next(iter(self.params.values())).device
        x = torch.as_tensor(np.asarray(x_stream), device=dev)
        y = torch.as_tensor(np.asarray(y_stream), device=dev)
        N = x.shape[1]
        for t in range(iterations):
            sel = torch.arange(t * batch_size, (t + 1) * batch_size, device=dev) % N
            loss = self.step(x[:, sel], y[:, sel])
            self.loss_history.append(float(loss))
        return self.effective_params


def FedML_decentralized_fl(client_number: int, streaming_data, model_params: StateDict, loss_fn,
                           args, device: Any = "cuda") -> Dict[str, Any]:
    """The reference's ``decentralized_fl_api.FedML_decentralized_fl``:
    ``streaming_data`` is ``(x [n, N, d], y [n, N])``. Returns the final
    stacked params, the loss history and its mean (the average regret)."""
    dev = resolve_device(device)
    b_symmetric = bool(getattr(args, "b_symmetric", True))
    undirected = int(getattr(args, "topology_neighbors_num_undirected", 2))
    if b_symmetric:
        topo_mgr = SymmetricTopologyManager(client_number, undirected)
    else:
        topo_mgr = AsymmetricTopologyManager(
            client_number, undirected, int(getattr(args, "topology_neighbors_num_directed", 2)))
    topo_mgr.generate_topology()
    topology = topo_mgr.mixing_matrix()
    stacked = {k: torch.stack([torch.as_tensor(p, device=dev)] * client_number)
               for k, p in model_params.items()}
    sim = DecentralizedFedSGD(stacked, loss_fn, topology,
                              learning_rate=float(getattr(args, "learning_rate", 0.1)),
                              mode="dsgd" if b_symmetric else "pushsum")
    x, y = streaming_data
    final = sim.run(x, y, int(getattr(args, "iteration_number", 100)),
                    int(getattr(args, "batch_size", 1)))
    regret = float(np.mean(sim.loss_history)) if sim.loss_history else 0.0
    return {"params": final, "loss_history": sim.loss_history, "avg_regret": regret}
