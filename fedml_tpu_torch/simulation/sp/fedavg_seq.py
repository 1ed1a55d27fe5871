"""FedAvg_seq: counterpart of ``fedml_tpu/simulation/sp/fedavg_seq.py``
(reference ``simulation/mpi/fedavg_seq`` and ``core/schedule``).

When a round's cohort outnumbers the workers, each worker trains a queue of
clients one after the other; ``SeqTrainScheduler`` packs the queues to
minimise the round's makespan from per-client runtime fits that improve as
rounds accumulate (``core/schedule/runtime_estimate.py``). The workers are
simulated lanes in one process: each client's local round runs on the
trainer's device, and its wall time, taken after the device has finished
(``torch.cuda.synchronize``), feeds the runtime history from round 1 on
(round 0's times hold one-off warm-up costs, as JAX's hold its compiles).
The reported ``makespan`` is the slowest lane's time.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Tuple

import torch

from ...constants import (FEDML_FEDERATED_OPTIMIZER_FEDNOVA, FEDML_FEDERATED_OPTIMIZER_MIME,
                          FEDML_FEDERATED_OPTIMIZER_SCAFFOLD)
from ...core import telemetry as tel
from ...core.alg_frame.context import Context
from ...core.schedule.runtime_estimate import t_sample_fit
from ...core.schedule.seq_train_scheduler import SeqTrainScheduler
from .fedavg_api import FedAvgAPI

log = logging.getLogger(__name__)


def _sync(device: Any) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class FedAvgSeqAPI(FedAvgAPI):
    """FedAvgAPI with makespan-optimised per-round client-to-worker
    queues."""

    def __init__(self, args: Any, device: Any, dataset, model, client_trainer=None,
                 server_aggregator=None):
        super().__init__(args, device, dataset, model, client_trainer, server_aggregator)
        if self.fed_opt in (FEDML_FEDERATED_OPTIMIZER_FEDNOVA, FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
                            FEDML_FEDERATED_OPTIMIZER_MIME):
            # their structured round payloads are not threaded through this
            # queue-ordered loop, in the JAX package either
            raise ValueError(f"FedAvgSeqAPI does not support {self.fed_opt}; use FedAvgAPI")
        self.worker_num = max(1, int(getattr(args, "worker_num", 2)))
        # runtime_history[worker][client] -> observed seconds
        self.runtime_history: Dict[int, Dict[int, List[float]]] = {
            w: {} for w in range(self.worker_num)}

    def _schedule(self, client_indexes: List[int]) -> Tuple[List[List[int]], List[float]]:
        """This round's clients packed into worker queues (positions within
        ``client_indexes``), minimising the estimated makespan."""
        sizes = {i: self.train_data_local_num_dict[c] for i, c in enumerate(client_indexes)}
        hist = {
            w: {i: self.runtime_history[w].get(c, [])
                for i, c in enumerate(client_indexes) if self.runtime_history[w].get(c)}
            for w in range(self.worker_num)
        }
        _, fit_funcs, _ = t_sample_fit(self.worker_num, len(client_indexes), hist, sizes,
                                       uniform_client=True, uniform_gpu=True)
        if fit_funcs.get(0, {}).get(0) is None:  # poly1d is falsy at order 0
            # no runtime history yet (round 0): cost proportional to samples
            fit_funcs = {0: {0: lambda n: float(n)}}
        workloads = [sizes[i] for i in range(len(client_indexes))]
        sched = SeqTrainScheduler(workloads, [1.0] * self.worker_num, [1.0] * self.worker_num,
                                  fit_funcs, uniform_client=True, uniform_gpu=True)
        return sched.DP_schedule()

    def train(self) -> Dict[str, float]:
        w_global = self.model_trainer.get_model_params()
        rounds = int(getattr(self.args, "comm_round", 2))
        metrics: Dict[str, float] = {}
        for r in range(rounds):
            client_indexes = self._client_sampling(
                r, int(self.args.client_num_in_total), int(self.args.client_num_per_round))
            queues, _est = self._schedule(list(client_indexes))
            lane_times = [0.0] * self.worker_num
            w_locals: List[Tuple[float, Any]] = []
            trained_order: List[int] = []
            client = self.client_list[0]  # one trainer, re-pointed per client
            for w, queue in enumerate(queues[: self.worker_num]):
                for pos in queue:
                    cid = client_indexes[pos]
                    client.update_local_dataset(cid, self.train_data_local_dict[cid],
                                                self.test_data_local_dict[cid],
                                                self.train_data_local_num_dict[cid])
                    # tel.timed always measures (the scheduler reads dt) and
                    # records the span only when telemetry is on
                    with tel.timed("fedavg.client_train", round=r, client=int(cid), lane=w) as sp:
                        w_local = client.train(w_global)
                        _sync(self.device)
                    dt = sp.duration_s
                    lane_times[w] += dt
                    if r > 0:
                        self.runtime_history[w].setdefault(cid, []).append(dt)
                    w_locals.append((client.get_sample_number(), w_local))
                    trained_order.append(cid)
            # defenses key per-client state by this (queue-ordered) list
            Context().add("client_indexes_of_round", trained_order)
            w_global = self._server_update(w_global, w_locals)
            self._install_global(w_global)
            freq = int(getattr(self.args, "frequency_of_the_test", 5))
            if r == rounds - 1 or (freq > 0 and r % freq == 0):
                metrics = self._test_global(r)
                metrics["makespan"] = float(max(lane_times))
                metrics["schedule"] = [list(map(int, q)) for q in queues]
                self.metrics_history.append(metrics)
            log.info("fedavg_seq round %d queues=%s makespan=%.3fs", r, queues, max(lane_times))
        return metrics
