"""Trainer adapter: the counterpart of
``fedml_tpu/cross_silo/client/fedml_trainer_dist_adapter.py``.

Reference: ``cross_silo/client/fedml_trainer_dist_adapter.py:9`` — in the
reference this wraps the model in DDP for intra-silo parallelism; the JAX
package re-jits the local round over a device mesh for the hierarchical
scenario. Here the hierarchical scenario splits the local round over the
silo's ranks (``parallel/dp.py``): the silo's processes are the ranks of
one process group (``parallel/multihost.py``), and each step all-reduces
their gradients.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from ...constants import CROSS_SILO_SCENARIO_HIERARCHICAL
from ...ml.trainer.trainer_creator import create_model_trainer
from ...parallel.multihost import backend, process_count, process_index
from .fedml_trainer import FedMLTrainer

log = logging.getLogger(__name__)


class TrainerDistAdapter:
    def __init__(
        self,
        args: Any,
        device,
        client_rank: int,
        model,
        train_data_num,
        train_data_local_num_dict,
        train_data_local_dict,
        test_data_local_dict,
        model_trainer=None,
    ):
        self.args = args
        self.device = device
        self.client_rank = client_rank
        client_index = client_rank - 1
        if model_trainer is None:
            model_trainer = create_model_trainer(model, args)
        model_trainer.set_id(client_index)
        self.dp_width = 1
        if str(getattr(args, "scenario", "horizontal")) == CROSS_SILO_SCENARIO_HIERARCHICAL:
            self._wrap_hierarchical(model_trainer)
        self.trainer = FedMLTrainer(
            client_index,
            train_data_local_dict,
            train_data_local_num_dict,
            test_data_local_dict,
            train_data_num,
            device,
            args,
            model_trainer,
        )

    def _wrap_hierarchical(self, model_trainer) -> None:
        """Replace the trainer's local round with its data-parallel form over
        the silo's ranks. The width is JAX's rule with the silo's ranks in
        place of local devices: ``n = min(n_proc_in_silo or ranks, ranks)``,
        ``ranks`` the process group's size (1 without one); the first n
        ranks split every batch and any rank past them trains the whole
        batch alone, as a JAX process whose devices lie outside the mesh
        does. Width 1 trains unsharded and says so."""
        import torch.distributed as dist

        from ...parallel.dp import DataParallelGroup, shard_local_train

        ranks = process_count()
        n = min(int(getattr(self.args, "n_proc_in_silo", 0) or 0) or ranks, ranks)
        if n <= 1:
            log.info("hierarchical scenario with 1 rank; running unsharded")
            return
        # every rank joins the group's creation, members or not
        group = None if n == ranks else dist.new_group(list(range(n)))
        rank = process_index()
        if rank >= n:
            log.info("hierarchical scenario: rank %d is outside the %d-rank data-parallel group; "
                     "it trains the whole batch", rank, n)
            return
        if not hasattr(model_trainer, "_local_train"):
            log.info("hierarchical scenario: %s has no local round to split; running unsharded",
                     type(model_trainer).__name__)
            return
        model_trainer._local_train = shard_local_train(
            model_trainer._local_train, DataParallelGroup(n, rank, group))
        self.dp_width = n
        log.info("intra-silo DP over %d ranks (%s)", n, backend())

    def train(self, round_idx: Optional[int] = None):
        return self.trainer.train(round_idx)

    def update_model(self, model_params) -> None:
        self.trainer.update_model(model_params)

    def get_model_params(self):
        return self.trainer.trainer.get_model_params()

    def update_dataset(self, client_index: Optional[int] = None) -> None:
        self.trainer.update_dataset(int(client_index if client_index is not None else self.trainer.client_index))
