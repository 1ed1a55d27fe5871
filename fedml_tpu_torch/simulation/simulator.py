"""Simulator facade: counterpart of ``fedml_tpu/simulation/simulator.py``
(reference ``simulation/simulator.py:27``).

``SimulatorSingleProcess`` wraps the sp FedAvg-family API (FedAvg, FedProx,
FedOpt, FedNova, SCAFFOLD, FedDyn, Mime), the hierarchical trainer
(``HierarchicalFL``), async FedAvg (``Async_FedAvg``), FedAvg_seq,
TurboAggregate (``TA``), split NN (``split_nn``), FedGKT, FedGAN, FedNAS
and FedSeg; ``SimulatorVmap`` the client-batched simulator (backend
``vmap``) and, with ``async_rounds``, its event-driven async driver;
``SimulatorCollective`` the Parrot-NCCL simulator (backend ``NCCL``: the
vmapped round in client groups over devices, ``collective/``) and
``SimulatorMPI`` Parrot-MPI (backend ``MPI``: the cross-silo managers as
threads over INMEMORY, or one rank a process, ``mpi_sim.py``);
decentralized and vertical FL are library APIs (``sp/decentralized.py``,
``sp/classical_vertical_fl.py``), outside this dispatch as in the JAX
package. Per-pixel labels reach only FedSeg: any other optimizer refuses
them before its first round, with the JAX package's error.
"""

from __future__ import annotations

from typing import Any

from ..constants import (
    FEDML_FEDERATED_OPTIMIZER_ASYNC_FEDAVG,
    FEDML_FEDERATED_OPTIMIZER_FEDAVG_SEQ,
    FEDML_FEDERATED_OPTIMIZER_FEDGAN,
    FEDML_FEDERATED_OPTIMIZER_FEDGKT,
    FEDML_FEDERATED_OPTIMIZER_FEDNAS,
    FEDML_FEDERATED_OPTIMIZER_FEDSEG,
    FEDML_FEDERATED_OPTIMIZER_HIERACHICAL_FL,
    FEDML_FEDERATED_OPTIMIZER_SPLIT_NN,
    FEDML_FEDERATED_OPTIMIZER_TURBO_AGGREGATE,
)


class SimulatorSingleProcess:
    def __init__(self, args: Any, device: Any, dataset, model, client_trainer=None,
                 server_aggregator=None):
        from ..core.fhe.fhe_agg import refuse_fhe_front

        opt = str(getattr(args, "federated_optimizer", "FedAvg"))
        refuse_fhe_front(args, "sp")
        if opt == FEDML_FEDERATED_OPTIMIZER_HIERACHICAL_FL:
            from .sp.hierarchical_fl import HierarchicalTrainer as API
        elif opt == FEDML_FEDERATED_OPTIMIZER_ASYNC_FEDAVG:
            from .sp.async_fedavg import AsyncFedAvgAPI as API
        elif opt == FEDML_FEDERATED_OPTIMIZER_TURBO_AGGREGATE:
            from .sp.turboaggregate import TurboAggregateTrainer as API
        elif opt == FEDML_FEDERATED_OPTIMIZER_FEDGKT:
            from .sp.fedgkt import FedGKTAPI as API
        elif opt == FEDML_FEDERATED_OPTIMIZER_SPLIT_NN:
            from .sp.split_nn import SplitNNAPI as API
        elif opt == FEDML_FEDERATED_OPTIMIZER_FEDAVG_SEQ:
            from .sp.fedavg_seq import FedAvgSeqAPI as API
        elif opt == FEDML_FEDERATED_OPTIMIZER_FEDGAN:
            from .sp.fedgan import FedGANAPI as API
        elif opt == FEDML_FEDERATED_OPTIMIZER_FEDNAS:
            from .sp.fednas import FedNASAPI as API
        elif opt == FEDML_FEDERATED_OPTIMIZER_FEDSEG:
            from .sp.fedseg import FedSegAPI as API
        else:
            from .sp.fedavg_api import FedAvgAPI as API

        if opt != FEDML_FEDERATED_OPTIMIZER_FEDSEG and dataset is not None:
            y = getattr(dataset[2], "y", None)  # train_global labels
            if y is not None and getattr(y, "ndim", 0) >= 3:
                raise ValueError(
                    "segmentation dataset (per-pixel labels) requires "
                    'federated_optimizer: "FedSeg"'
                )
        self.fl_trainer = API(args, device, dataset, model, client_trainer, server_aggregator)

    def run(self):
        return self.fl_trainer.train()


class SimulatorVmap:
    def __init__(self, args: Any, device: Any, dataset, model, client_trainer=None,
                 server_aggregator=None):
        from ..core.fhe.fhe_agg import refuse_fhe_front

        refuse_fhe_front(args, "vmap")
        if getattr(args, "async_rounds", False):
            # non-barrier variant: event-driven async federation, a publish
            # every args.async_publish_k merges (comm_round counts publishes)
            from .vmapped.async_driver import VmapAsyncFedAvgAPI as API
        else:
            from .vmapped.vmap_fedavg import VmapFedAvgAPI as API

        self.fl_trainer = API(args, device, dataset, model)

    def run(self):
        return self.fl_trainer.train()


class SimulatorCollective:
    """Parrot-NCCL: the cohort in client groups over the devices
    (``simulation/collective/collective_sim.py``)."""

    def __init__(self, args: Any, device: Any, dataset, model, client_trainer=None,
                 server_aggregator=None):
        from ..core.fhe.fhe_agg import refuse_fhe_front
        from .collective import CollectiveSimulator

        refuse_fhe_front(args, "vmap")
        self.fl_trainer = CollectiveSimulator(args, device, dataset, model)

    def run(self):
        return self.fl_trainer.train()


class SimulatorMPI:
    """Parrot-MPI over the message plane (reference simulation/simulator.py:70):
    rank 0 runs the server manager, every other rank a client manager, as
    threads over INMEMORY or one rank a process (``mpi_sim.py``)."""

    def __init__(self, args: Any, device: Any, dataset, model, client_trainer=None,
                 server_aggregator=None):
        from .mpi_sim import FedMLDistributedRunner

        self.runner = FedMLDistributedRunner(args, device, dataset, model, client_trainer,
                                             server_aggregator)

    def run(self):
        return self.runner.run()
