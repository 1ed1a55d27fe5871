"""Hierarchical FL: group-level FedAvg between global aggregations.
Counterpart of ``fedml_tpu/simulation/sp/hierarchical_fl.py`` (reference
``simulation/sp/hierarchical_fl/{trainer,group,client}.py``).

Clients are assigned to groups (``group_method='random'`` over
``group_num`` groups, from ``np.random.RandomState(random_seed)``, bit for
bit the JAX package's assignment); each global round, every group runs
``group_comm_round`` intra-group FedAvg rounds from the global weights, and
the groups are averaged sample-weighted into the new global model.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Tuple

import numpy as np

from ...core.engine import GroupedSequentialStrategy, HookedAverageSink, RoundEngine
from .client import Client
from .fedavg_api import FedAvgAPI

log = logging.getLogger(__name__)


class HierarchicalTrainer(FedAvgAPI):
    """Two-level FedAvg (reference hierarchical_fl/trainer.py)."""

    def _setup_clients(self, train_data_local_num_dict, train_data_local_dict,
                       test_data_local_dict) -> None:
        args = self.args
        group_method = str(getattr(args, "group_method", "random"))
        group_num = int(getattr(args, "group_num", 2))
        n_total = int(args.client_num_in_total)
        if group_method != "random":
            raise ValueError(f"unsupported group_method {group_method!r}")
        rng = np.random.RandomState(int(getattr(args, "random_seed", 0)))
        self.group_indexes = rng.randint(0, group_num, n_total)
        self.group_to_clients: Dict[int, List[int]] = {}
        for client_idx, gidx in enumerate(self.group_indexes):
            self.group_to_clients.setdefault(int(gidx), []).append(client_idx)
        log.info("group assignment: %s", self.group_to_clients)
        # one reusable Client slot (datasets swapped in per sampled client)
        self.client_list = [
            Client(0, train_data_local_dict[0], test_data_local_dict[0],
                   train_data_local_num_dict[0], args, self.device, self.model_trainer)
        ]

    def _train_one_client(self, client_idx: int, w) -> Tuple[int, Any]:
        client = self.client_list[0]
        client.update_local_dataset(
            client_idx,
            self.train_data_local_dict[client_idx],
            self.test_data_local_dict[client_idx],
            self.train_data_local_num_dict[client_idx],
        )
        return client.get_sample_number(), client.train(w)

    def _group_train(self, group_clients: List[int], w_global):
        """``group_comm_round`` rounds of FedAvg inside the group (reference
        group.py Group.train)."""
        w_group = w_global
        for _ in range(int(getattr(self.args, "group_comm_round", 1))):
            w_locals = [self._train_one_client(ci, w_group) for ci in group_clients]
            lst = self.aggregator.on_before_aggregation(w_locals)
            w_group = self.aggregator.aggregate(lst)
        n_group = sum(self.train_data_local_num_dict[ci] for ci in group_clients)
        return n_group, w_group

    def train(self) -> Dict[str, float]:
        """One engine run: the grouped-sequential strategy (an inner FedAvg
        a group) feeding the plain hooks-and-average sink."""
        engine = RoundEngine(
            self.args,
            GroupedSequentialStrategy(self),
            HookedAverageSink(self.aggregator),
            sample_fn=lambda r: self._client_sampling(
                r, int(self.args.client_num_in_total), int(self.args.client_num_per_round)
            ),
            install_fn=self._install_global,
            eval_fn=self._test_global,
            round_span_attrs={"optimizer": "HierarchicalFL"},
            metrics_history=self.metrics_history,
        )
        engine.run(self.model_trainer.get_model_params())
        return self.metrics_history[-1] if self.metrics_history else {}
