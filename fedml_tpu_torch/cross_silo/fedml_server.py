"""Cross-silo server entry: the counterpart of
``fedml_tpu/cross_silo/fedml_server.py`` (reference cross_silo/fedml_server.py)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..ml.aggregator import create_server_aggregator
from .server.fedml_aggregator import FedMLAggregator
from .server.fedml_server_manager import FedMLServerManager


class FedMLCrossSiloServer:
    def __init__(self, args: Any, device, dataset, model, server_aggregator=None):
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
        if server_aggregator is None:
            server_aggregator = create_server_aggregator(model, args)
        server_aggregator.set_id(0)
        # the connected world can exceed the per-round cohort k: with
        # straggler-aware over-provisioning the server needs spare clients to
        # sample from (args.client_num_connected > client_num_per_round)
        client_num = int(
            getattr(args, "client_num_connected", None)
            or getattr(args, "client_num_per_round", getattr(args, "client_num_in_total", 1))
        )
        aggregator = FedMLAggregator(
            train_data_global,
            test_data_global,
            train_data_num,
            train_data_local_dict,
            test_data_local_dict,
            train_data_local_num_dict,
            client_num,
            device,
            args,
            server_aggregator,
        )
        self.server_manager = FedMLServerManager(args, aggregator, client_rank=0, client_num=client_num, backend=backend)

    def run(self) -> Optional[Dict[str, float]]:
        self.server_manager.run()
        return self.server_manager.final_metrics


Server = FedMLCrossSiloServer
