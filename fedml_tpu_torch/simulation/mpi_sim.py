"""Multi-process simulation over the message plane (Parrot-MPI): the
counterpart of ``fedml_tpu/simulation/mpi_sim.py``.

Reference: ``simulation/mpi/fedavg/FedAvgAPI.py:13`` — ``mpirun -np N``
launches rank 0 as the server and ranks 1..N-1 as clients. Here the
cross-silo managers (the same round protocol) run over the message plane:

- run as one process (no external launcher): the server and every client
  are threads over INMEMORY, each party with a model of its own (a torch
  module is trained in place, so parties cannot share one as JAX's
  immutable params are shared);
- launched externally (JAX's rule: ``process_group_launched``, or backend
  GRPC with a rank and a role): this process is one rank over the backend
  given; backend ``MPI`` is GRPC among the ranks (``grpc_base_port``).

A party that raises fails the run: its exception is raised here, and the
run does not wait on the others.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Any, Dict

from ..constants import COMM_BACKEND_INMEMORY
from ..cross_silo.fedml_client import FedMLCrossSiloClient
from ..cross_silo.fedml_server import FedMLCrossSiloServer

log = logging.getLogger(__name__)


class FedMLDistributedRunner:
    def __init__(self, args: Any, device, dataset, model, client_trainer=None,
                 server_aggregator=None):
        self.args = args
        self.device = device
        self.dataset = dataset
        self.model = model
        self.client_trainer = client_trainer
        self.server_aggregator = server_aggregator
        self.n_clients = int(getattr(args, "client_num_per_round",
                                     getattr(args, "client_num_in_total", 1)))
        self.launched_externally = bool(getattr(args, "process_group_launched", False)) or (
            str(getattr(args, "backend", "")).upper() == "GRPC" and int(getattr(args, "rank", -1)) >= 0
            and getattr(args, "role", None) in ("client", "server")
        )

    def _run_single_rank(self):
        if str(getattr(self.args, "role", "client")) == "server" or int(getattr(self.args, "rank", 0)) == 0:
            self.args.role = "server"
            self.args.rank = 0
            return FedMLCrossSiloServer(self.args, self.device, self.dataset, self.model,
                                        self.server_aggregator).run()
        self.args.role = "client"
        return FedMLCrossSiloClient(self.args, self.device, self.dataset, self.model,
                                    self.client_trainer).run()

    def _run_threaded(self):
        results: Dict[str, Any] = {}
        errors: Dict[str, BaseException] = {}

        def party(name: str, build):
            try:
                results[name] = build().run()
            except BaseException as e:  # raised in run(); this thread must not hang the rest
                errors[name] = e
                log.exception("MPI simulation: %s failed", name)

        def server():
            args = copy.copy(self.args)
            args.rank, args.role, args.backend = 0, "server", COMM_BACKEND_INMEMORY
            return FedMLCrossSiloServer(args, self.device, self.dataset, copy.deepcopy(self.model),
                                        self.server_aggregator)

        def client(rank: int):
            args = copy.copy(self.args)
            args.rank, args.role, args.backend = rank, "client", COMM_BACKEND_INMEMORY
            return FedMLCrossSiloClient(args, self.device, self.dataset, copy.deepcopy(self.model),
                                        self.client_trainer)

        threads = [threading.Thread(target=party, args=("server", server), daemon=True)]
        threads += [threading.Thread(target=party, args=(f"client{r}", lambda r=r: client(r)),
                                     daemon=True) for r in range(1, self.n_clients + 1)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads) and not errors:
            time.sleep(0.01)
        if errors:
            name, err = next(iter(errors.items()))
            raise RuntimeError(f"MPI simulation: {name} failed: {err!r}") from err
        return results.get("server")

    def run(self):
        if self.launched_externally:
            return self._run_single_rank()
        log.info("MPI-style simulation in one process: server + %d clients over INMEMORY",
                 self.n_clients)
        return self._run_threaded()
