"""Cross-silo client entry: the counterpart of
``fedml_tpu/cross_silo/fedml_client.py`` (reference cross_silo/fedml_client.py:5).

A silo is one process on one device here: ``init`` refuses
``num_processes > 1``, so the JAX package's multi-host silo (slave processes
fed over a device broadcast, ``ClientSlaveManager``) is not ported
(ROADMAP.md, Queue 1)."""

from __future__ import annotations

from typing import Any

from .client.fedml_client_master_manager import ClientMasterManager
from .client.fedml_trainer_dist_adapter import TrainerDistAdapter


class FedMLCrossSiloClient:
    def __init__(self, args: Any, device, dataset, model, model_trainer=None):
        [
            train_data_num,
            test_data_num,
            train_data_global,
            test_data_global,
            train_data_local_num_dict,
            train_data_local_dict,
            test_data_local_dict,
            class_num,
        ] = dataset
        backend = str(getattr(args, "backend", "INMEMORY"))
        client_rank = int(getattr(args, "rank", 1))
        size = int(getattr(args, "client_num_per_round", getattr(args, "client_num_in_total", 1))) + 1
        trainer_dist_adapter = TrainerDistAdapter(
            args,
            device,
            client_rank,
            model,
            train_data_num,
            train_data_local_num_dict,
            train_data_local_dict,
            test_data_local_dict,
            model_trainer,
        )
        self.client_manager = ClientMasterManager(
            args, trainer_dist_adapter, rank=client_rank, size=size, backend=backend
        )

    def run(self) -> None:
        self.client_manager.run()


Client = FedMLCrossSiloClient
