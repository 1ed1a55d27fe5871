"""Device-collective FL simulation, the Parrot-NCCL equivalent: counterpart
of ``fedml_tpu/simulation/collective/collective_sim.py``.

Reference: ``simulation/nccl/base_framework/`` — one process per GPU; the
server ``dist.broadcast``s the parameters to local aggregators, each trains
its subset of clients and ``dist.reduce``s the weighted sum back
(LocalAggregator.py:15, Server.py:15, collectives common.py:185-228). The
JAX package shards the stacked clients over a device mesh and lets XLA
insert the all-reduce.

Here one process drives every device. The round's cohort is split into one
contiguous group per entry of ``devices`` (default: every visible card, or
the model's device), shrunk as JAX does until their number divides
``client_num_per_round``. The global weights are copied to each group's
device (the broadcast), each group runs the vmapped local round of its
clients there (``VmapFedAvgAPI``'s, with each client's shuffle seed and the
cohort's batch count as in the whole-cohort round), and each group's
weighted partial sum (the weights normalised over the whole cohort) is
copied to the first device and added there, in group order (the reduce).
``devices`` may repeat a device: several groups then share it.

One group is the vmapped round itself, bit for bit. Several groups differ
from it only in the fold's f32 summation order (each group's partial sum is
rounded before the reduce). With middleware that needs the clients one by
one (an attack, a defense, DP, contribution), the groups' stacked clients
are gathered on the first device and folded as the vmapped front folds them.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, List, Optional

import numpy as np
import torch

from ...core import telemetry as tel
from ...core.engine import RoundEngine, StackedBucketedSink
from ...core.engine.round_engine import (AggregationSink, ClientExecutionStrategy, RoundResult,
                                         middleware_wants_client_trees)
from ..vmapped.vmap_fedavg import VmapFedAvgAPI

log = logging.getLogger(__name__)


def visible_devices(model_device: torch.device) -> List[torch.device]:
    """Every visible card for a model on CUDA; the model's device otherwise."""
    if model_device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [model_device]


class CollectiveSimulator(VmapFedAvgAPI):
    def __init__(self, args: Any, device: Any, dataset, model, devices: Optional[List] = None):
        devices = [torch.device(d) for d in (devices or visible_devices(model.device))]
        n = len(devices)
        per_round = int(getattr(args, "client_num_per_round", 1))
        # the groups must split the cohort evenly: shrink to the largest divisor
        while n > 1 and per_round % n != 0:
            n -= 1
        self.devices = devices[:n]
        if model.device != self.devices[0]:
            # the global model lives on the first device (the reduce's target)
            model.module.to(self.devices[0])
            if model.params is not None:
                model.params = {k: v.to(self.devices[0]) for k, v in model.params.items()}
        super().__init__(args, device, dataset, model)
        log.info("collective sim: %d clients/round over %d groups on %s", per_round, n,
                 [str(d) for d in self.devices])

    def train(self):
        if len(self.devices) == 1:
            return super().train()
        engine = RoundEngine(
            self.args,
            GroupedVmapStrategy(self),
            GroupReduceSink(self.aggregator, self.devices[0]),
            sample_fn=lambda r: self._client_sampling(
                r, int(self.args.client_num_in_total), int(self.args.client_num_per_round)
            ),
            install_fn=self.aggregator.set_model_params,
            eval_fn=self._test_global,
            round_span_attrs={"optimizer": "FedAvg", "front": "collective",
                              "groups": len(self.devices)},
            metrics_history=self.metrics_history,
        )
        w_global = engine.run(self.model.params)
        self.model = dataclasses.replace(self.model, params=w_global)
        return self.metrics_history[-1] if self.metrics_history else {}


class GroupedVmapStrategy(ClientExecutionStrategy):
    """The cohort split into the simulator's groups, each group's vmapped
    local round on its device from a copy of the global weights."""

    name = "grouped_vmap"

    def __init__(self, api: CollectiveSimulator):
        self.api = api

    def run_round(self, round_idx: int, w_global, cohort) -> RoundResult:
        api = self.api
        cohort = list(cohort)
        per = len(cohort) // len(api.devices)
        bs = int(getattr(api.args, "batch_size", 32))
        nb_max = max(max(1, -(-len(api.train_data_local_dict[i]) // bs)) for i in cohort)
        counts = np.asarray([api.train_data_local_num_dict[i] for i in cohort], dtype=np.float32)
        weights = counts / counts.sum()
        groups = []
        with tel.span("fedavg.client_train", round=round_idx, clients=len(cohort),
                      groups=len(api.devices)):
            for g, dev in enumerate(api.devices):
                lo, hi = g * per, (g + 1) * per
                w_g = {k: v.to(dev) for k, v in w_global.items()}
                x, y, idx, mask = api._stack_clients(cohort[lo:hi], first=lo, nb_max=nb_max,
                                                     device=dev)
                result = api._vmapped_train(w_g, x, y, idx, mask, round_idx)
                groups.append((result.params, weights[lo:hi]))
        return RoundResult(stacked=(groups, weights))


class GroupReduceSink(AggregationSink):
    """Each group's weighted partial sum on its device, then their sum on
    the first device (or, with per-client middleware, the clients gathered
    there and folded by :class:`StackedBucketedSink`)."""

    name = "group_reduce"

    def __init__(self, aggregator: Any, device: torch.device):
        self._agg = aggregator
        self._device = device
        self._gathered = StackedBucketedSink(aggregator)

    def fold(self, round_idx: int, w_global, result: RoundResult):
        from ...core.aggregation.bucketed import get_engine

        groups, weights = result.stacked
        contribution = bool(getattr(self._agg.args, "enable_contribution", False))
        if self._agg.enable_hooks and (middleware_wants_client_trees() or contribution):
            names = list(groups[0][0])
            stacked = {k: torch.cat([g[k].to(self._device) for g, _ in groups]) for k in names}
            return self._gathered.fold(round_idx, w_global, RoundResult(stacked=(stacked, weights)))
        with tel.span("collective.reduce", groups=len(groups)):
            new_w = None
            for stacked, w in groups:
                part = get_engine().aggregate_stacked(stacked, w)
                part = {k: v.to(self._device) for k, v in part.items()}
                new_w = part if new_w is None else {k: new_w[k] + part[k] for k in new_w}
        return self._agg.on_after_aggregation(new_w)


def FedML_Collective_init(args, device, dataset, model):
    """Reference: ``FedML_NCCL_Similulation_init`` (fedml/__init__.py:130)."""
    return CollectiveSimulator(args, device, dataset, model)
