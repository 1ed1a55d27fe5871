"""SecAgg cross-silo runtime: the counterpart of
``fedml_tpu/cross_silo/secagg`` (reference: cross_silo/secagg/).

``sa_fedml_api.py`` equivalents: Client/Server entries mirroring the plain
cross-silo pair but running the Bonawitz masked-aggregation protocol. They
run over INMEMORY only (``runner.py`` refuses the other backends), as the
JAX package's do: its shares travel as numpy arrays in the control message.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ...device import resolve_device
from ..client.fedml_trainer_dist_adapter import TrainerDistAdapter
from .sa_fedml_aggregator import SecAggAggregator
from .sa_fedml_client_manager import SecAggClientManager
from .sa_fedml_server_manager import SecAggServerManager


class SecAggClient:
    """Reference: sa_fedml_api.py FedML_SA_Horizontal client branch."""

    def __init__(self, args: Any, device, dataset, model, model_trainer=None):
        device = resolve_device(device)  # CUDA without a card raises here
        [
            train_data_num, _test_data_num, _train_data_global, _test_data_global,
            train_data_local_num_dict, train_data_local_dict, test_data_local_dict, _class_num,
        ] = dataset
        backend = str(getattr(args, "backend", "INMEMORY"))
        client_rank = int(getattr(args, "rank", 1))
        size = int(getattr(args, "client_num_per_round", getattr(args, "client_num_in_total", 1))) + 1
        adapter = TrainerDistAdapter(
            args, device, client_rank, model, train_data_num,
            train_data_local_num_dict, train_data_local_dict, test_data_local_dict, model_trainer,
        )
        self.client_manager = SecAggClientManager(args, adapter, rank=client_rank, size=size, backend=backend)

    def run(self) -> None:
        self.client_manager.run()


class SecAggServer:
    """Reference: sa_fedml_api.py FedML_SA_Horizontal server branch."""

    def __init__(self, args: Any, device, dataset, model, server_aggregator=None):
        from ...ml.aggregator import create_server_aggregator

        device = resolve_device(device)  # CUDA without a card raises here
        [
            _train_data_num, _test_data_num, _train_data_global, test_data_global,
            _train_data_local_num_dict, _train_data_local_dict, _test_data_local_dict, _class_num,
        ] = dataset
        backend = str(getattr(args, "backend", "INMEMORY"))
        if server_aggregator is None:
            server_aggregator = create_server_aggregator(model, args)
        server_aggregator.set_id(0)
        client_num = int(getattr(args, "client_num_per_round", getattr(args, "client_num_in_total", 1)))
        aggregator = SecAggAggregator(
            test_data_global, client_num, device, args, server_aggregator
        )
        self.server_manager = SecAggServerManager(
            args, aggregator, client_rank=0, client_num=client_num, backend=backend
        )

    def run(self) -> Optional[Dict[str, float]]:
        self.server_manager.run()
        return self.server_manager.final_metrics


Client = SecAggClient
Server = SecAggServer
