"""Cross-silo client entry: the counterpart of
``fedml_tpu/cross_silo/fedml_client.py`` (reference cross_silo/fedml_client.py:5).

A silo may be several processes: ``parallel/multihost.init_distributed``
joins them into one process group (``fedml_tpu_torch.init`` already did;
this call is the idempotent safety net for direct construction). Exactly
one, rank 0, builds the WAN-talking ``ClientMasterManager``; every other
rank builds a ``ClientSlaveManager``, which receives each round's metadata
and params over the group and trains the same round (reference rank-0
gating, fedml_client_master_manager.py:67-70)."""

from __future__ import annotations

from typing import Any

from ..parallel.multihost import init_distributed, is_main_process, shutdown_distributed
from .client.fedml_client_master_manager import ClientMasterManager
from .client.fedml_client_slave_manager import ClientSlaveManager
from .client.fedml_trainer_dist_adapter import TrainerDistAdapter


class FedMLCrossSiloClient:
    def __init__(self, args: Any, device, dataset, model, model_trainer=None):
        init_distributed(device=device)
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
        if is_main_process():
            self.client_manager = ClientMasterManager(
                args, trainer_dist_adapter, rank=client_rank, size=size, backend=backend
            )
        else:
            # slave ranks never open a WAN connection
            self.client_manager = ClientSlaveManager(args, trainer_dist_adapter)

    def run(self) -> None:
        self.client_manager.run()
        # the silo's ranks leave their group together once the last
        # broadcast (finished) is through
        shutdown_distributed()


Client = FedMLCrossSiloClient
