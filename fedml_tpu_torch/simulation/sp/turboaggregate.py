"""Turbo-Aggregate: counterpart of ``fedml_tpu/simulation/sp/turboaggregate.py``
(reference ``simulation/sp/turboaggregate``; So et al., 2021).

After the FedAvg clients' local rounds, the cohort is arranged into
``ta_group_num`` groups on a ring; each group adds its additively masked,
quantized models to the running partial sum, so no party sees another's
plaintext. Each model is scaled by its sample fraction first, quantized to
GF(2^31 - 1) at 16 fractional bits, flattened in the JAX package's wire
order (``core/mpc/finite_field.py``), masked and summed in int64 on the
models' device. The masks cancel within each group; they are drawn on the
host from the JAX package's generator stream (``additive_shares`` with
``random_seed``), so the ring sum is bit-equal to JAX's for the same
updates. The sum dequantizes to the sample-weighted average.
"""

from __future__ import annotations

import logging
from typing import Any, List, Tuple

import numpy as np
import torch

from ...core.mpc.finite_field import (additive_shares, flatten_finite, tree_from_finite,
                                      tree_to_finite, unflatten_finite)
from ...utils.pytree import tree_scale
from .fedavg_api import FedAvgAPI

log = logging.getLogger(__name__)

_P = 2**31 - 1
_Q_BITS = 16


class TurboAggregateTrainer(FedAvgAPI):
    """FedAvg with the Turbo-Aggregate ring in place of the plain fold."""

    def _ring_sum(self, w_locals: List[Tuple[float, Any]]) -> torch.Tensor:
        """The ring's field sum of the weighted, quantized, masked models:
        one int64 vector in the wire order, on the models' device."""
        ta_group_num = max(1, int(getattr(self.args, "ta_group_num", 2)))
        n = len(w_locals)
        groups = [list(range(g, n, ta_group_num)) for g in range(ta_group_num)]
        rng = np.random.default_rng(int(getattr(self.args, "random_seed", 0)))
        total_weight = float(sum(num for num, _ in w_locals))
        # each model scaled by its weight fraction BEFORE quantization, so the
        # ring only ever adds
        flats = [flatten_finite(tree_to_finite(tree_scale(w, num / total_weight), _Q_BITS, _P))
                 for num, w in w_locals]
        d = flats[0].shape[0]
        partial = torch.zeros(d, dtype=torch.int64, device=flats[0].device)
        for gi, group in enumerate(groups):
            if not group:
                continue
            # additive masks cancelling within the group: sum_j m_j = 0
            masks = torch.from_numpy(additive_shares(d, len(group), _P, rng)).to(partial.device)
            masked_sum = torch.zeros_like(partial)
            for slot, ci in enumerate(group):
                masked_sum = (masked_sum + (flats[ci] + masks[slot]) % _P) % _P
            partial = (partial + masked_sum) % _P
            log.debug("TA ring: group %d of %d added %d members", gi, ta_group_num, len(group))
        return partial

    def _ring_aggregate(self, w_locals: List[Tuple[float, Any]]):
        template = w_locals[0][1]
        return tree_from_finite(unflatten_finite(self._ring_sum(w_locals), template), _Q_BITS, _P)

    def _server_update(self, w_global, w_locals):
        agg = self.aggregator
        lst = agg.on_before_aggregation(w_locals)
        new_w = self._ring_aggregate(lst)
        new_w = agg.on_after_aggregation(new_w)
        agg.assess_contribution()
        return new_w
