"""LightSecAgg server-side aggregator: the counterpart of
``fedml_tpu/cross_silo/lightsecagg/lsa_fedml_aggregator.py``.

Reference: ``cross_silo/lightsecagg/lsa_fedml_aggregator.py:18`` —
collects masked finite-field models (add_local_trained_result :72) and
aggregate-encoded masks (:80), reconstructs the summed mask from U of them
(aggregate_mask_reconstruction :101) and unmasks + dequantizes the model sum
(aggregate_model_reconstruction :132). The Lagrange algebra lives in
``core/mpc/lightsecagg.py``; everything here is bookkeeping.

On the server's device: the running sum of the masked uploads mod p, the
aggregate masks (copied up as they arrive) and their Lagrange decoding, the
unmasking, the dequantization and the unweighted mean (the JAX package's
order, bit for bit), and the new global state dict (``lsa.server_sum``,
``lsa.decode``, ``lsa.dequantize`` spans, host time).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core import telemetry as tel
from ...core.mpc.finite_field import DEFAULT_PRIME, dequantize_mean, tree_dimensions
from ...core.mpc.lightsecagg import LightSecAggConfig, unmask_aggregate
from ...models.convert import state_from_wire_vector

log = logging.getLogger(__name__)


class LightSecAggAggregator:
    def __init__(self, test_global, client_num, device, args, server_aggregator):
        self.test_global = test_global
        self.client_num = client_num
        self.device = device
        self.args = args
        self.aggregator = server_aggregator
        self.q_bits = int(getattr(args, "quantize_bits", 16))
        self.prime = int(getattr(args, "mpc_prime", DEFAULT_PRIME))
        self.cfg = LightSecAggConfig(
            num_clients=client_num,
            target_active=int(getattr(args, "lsa_target_active", client_num)),
            privacy_guarantee=int(getattr(args, "lsa_privacy_guarantee", max(1, client_num // 2))),
            prime=self.prime,
        )
        self.masked_models: Dict[int, np.ndarray] = {}
        self.masked_sum: Optional[torch.Tensor] = None  # on self.device
        self.aggregate_masks: Dict[int, torch.Tensor] = {}  # on self.device

    # --- model plumbing ---------------------------------------------------
    def get_global_model_params(self):
        return self.aggregator.get_model_params()

    def set_global_model_params(self, model_parameters) -> None:
        self.aggregator.set_model_params(model_parameters)

    # --- first phase: masked model uploads (reference :72-99) ------------
    def add_local_trained_result(self, index: int, masked_flat) -> None:
        # the mean is unweighted, as in JAX: the upload's sample count is unused
        self.masked_models[index] = np.asarray(masked_flat, np.int64)
        with tel.span("lsa.server_sum"):
            y = torch.from_numpy(self.masked_models[index]).to(self.device)
            self.masked_sum = y % self.prime if self.masked_sum is None \
                else (self.masked_sum + y) % self.prime

    def check_whether_all_receive(self) -> bool:
        return len(self.masked_models) >= self.client_num

    # --- second phase: aggregate-encoded masks (reference :80-99) --------
    def add_local_aggregate_encoded_mask(self, index: int, aggregate_encoded_mask) -> None:
        self.aggregate_masks[index] = torch.from_numpy(
            np.asarray(aggregate_encoded_mask, np.int64)).to(self.device)

    def check_whether_all_aggregate_encoded_mask_receive(self) -> bool:
        return len(self.aggregate_masks) >= self.cfg.target_active

    # --- reconstruction (reference :101-170) ------------------------------
    def aggregate_model_reconstruction(self) -> Any:
        n_active = len(self.masked_models)
        template = self.get_global_model_params()
        _, d = tree_dimensions(template)
        if self.masked_sum.numel() != d:
            raise ValueError(f"masked uploads of {self.masked_sum.numel()} coordinates, the model {d}")
        with tel.span("lsa.decode"):
            x_sum = unmask_aggregate(self.cfg, self.masked_sum, self.aggregate_masks)
        # the reference divides each dequantized tensor by active_num (:158)
        with tel.span("lsa.dequantize"):
            mean = dequantize_mean(x_sum, n_active, self.q_bits, self.prime)
            new_global = state_from_wire_vector(mean, template)
        self.set_global_model_params(new_global)
        self.masked_models.clear()
        self.masked_sum = None
        self.aggregate_masks.clear()
        return new_global

    # --- eval -------------------------------------------------------------
    def test_on_server_for_all_clients(self, round_idx: int) -> Optional[Dict[str, float]]:
        if self.test_global is None:
            return None
        metrics = self.aggregator.test(self.test_global, self.device, self.args)
        if metrics is not None:
            metrics = dict(metrics)
            metrics["round"] = round_idx
            log.info("LSA round %d: %s", round_idx, metrics)
        return metrics
