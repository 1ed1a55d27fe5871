"""SecAgg server-side aggregator: the counterpart of
``fedml_tpu/cross_silo/secagg/sa_fedml_aggregator.py``.

Reference: ``cross_silo/secagg/sa_fedml_aggregator.py`` — wraps
``core/mpc/secagg.SecAggServer`` per round: collects masked GF(p) uploads,
reconstructs the survivor sum from the reveal shares, dequantizes and
installs the average.

On the server's device: the running sum of the masked uploads mod p (each
host vector copied up as it arrives), the stripping of the host-drawn masks
from it, the dequantization and the unweighted mean (the JAX package's
order, bit for bit), and the new global state dict (``sa.server_sum``,
``sa.unmask``, ``sa.dequantize`` spans, host time).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core import telemetry as tel
from ...core.mpc.finite_field import DEFAULT_PRIME, dequantize_mean, tree_dimensions
from ...core.mpc.secagg import SecAggConfig, SecAggServer
from ...models.convert import state_from_wire_vector

log = logging.getLogger(__name__)


class SecAggAggregator:
    def __init__(self, test_global, client_num, device, args, server_aggregator):
        self.test_global = test_global
        self.client_num = client_num
        self.device = device
        self.args = args
        self.aggregator = server_aggregator
        self.q_bits = int(getattr(args, "quantize_bits", 16))
        self.cfg = SecAggConfig(
            num_clients=client_num,
            threshold=int(getattr(args, "secagg_threshold", max(1, client_num // 2))),
            prime=int(getattr(args, "mpc_prime", DEFAULT_PRIME)),
        )
        self.server = SecAggServer(self.cfg)
        self.reveals: Dict[int, Any] = {}
        self.masked_sum: Optional[torch.Tensor] = None  # on self.device

    def new_round(self) -> None:
        self.server = SecAggServer(self.cfg)
        self.reveals.clear()
        self.masked_sum = None

    # --- model plumbing ---------------------------------------------------
    def get_global_model_params(self):
        return self.aggregator.get_model_params()

    def set_global_model_params(self, model_parameters) -> None:
        self.aggregator.set_model_params(model_parameters)

    # --- phase bookkeeping ------------------------------------------------
    def register_key(self, cid: int, pk: int) -> None:
        self.server.register_key(cid, pk)

    def all_keys_received(self) -> bool:
        return len(self.server.public_keys) >= self.client_num

    def add_masked_model(self, cid: int, y) -> None:
        # the mean is unweighted, as in JAX: the upload's sample count is unused
        self.server.submit(cid, np.asarray(y, np.int64))
        with tel.span("sa.server_sum"):
            y = torch.from_numpy(self.server.masked[cid]).to(self.device)
            self.masked_sum = y % self.cfg.prime if self.masked_sum is None \
                else (self.masked_sum + y) % self.cfg.prime

    def all_models_received(self) -> bool:
        return len(self.server.masked) >= self.client_num

    def add_reveal(self, cid: int, reveal) -> None:
        self.reveals[cid] = reveal

    def all_reveals_received(self) -> bool:
        return len(self.reveals) >= len(self.server.masked)

    # --- reconstruction ---------------------------------------------------
    def aggregate_model_reconstruction(self):
        template = self.get_global_model_params()
        _, d = tree_dimensions(template)
        if self.masked_sum.numel() != d:
            raise ValueError(f"masked uploads of {self.masked_sum.numel()} coordinates, the model {d}")
        with tel.span("sa.unmask"):
            x_sum = self.server.strip_masks(self.masked_sum, self.reveals)
        with tel.span("sa.dequantize"):
            mean = dequantize_mean(x_sum, len(self.server.masked), self.q_bits, self.cfg.prime)
            new_global = state_from_wire_vector(mean, template)
        self.set_global_model_params(new_global)
        return new_global

    # --- eval -------------------------------------------------------------
    def test_on_server_for_all_clients(self, round_idx: int) -> Optional[Dict[str, float]]:
        if self.test_global is None:
            return None
        metrics = self.aggregator.test(self.test_global, self.device, self.args)
        if metrics is not None:
            metrics = dict(metrics)
            metrics["round"] = round_idx
            log.info("SecAgg round %d: %s", round_idx, metrics)
        return metrics
