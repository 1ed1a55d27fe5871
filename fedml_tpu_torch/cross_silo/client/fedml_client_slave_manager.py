"""Cross-silo client SLAVE manager, the silo's ranks past rank 0: the
counterpart of ``fedml_tpu/cross_silo/client/fedml_client_slave_manager.py``.

Reference: ``cross_silo/client/fedml_client_slave_manager.py`` — torchrun
slave ranks block in ``await_sync_process_group`` for the round metadata the
master broadcasts (``fedml_client_master_manager.py:200-212``), then run the
same local round so the data-parallel collectives line up. A slave opens no
WAN connection: the master's broadcasts (``parallel/multihost.py``: the
metadata, then the global params) are its only source of the round, and it
runs the round's collectives with the master and the other ranks.
"""

from __future__ import annotations

import logging
from typing import Any

from ...parallel.multihost import broadcast_model_params, broadcast_round_metadata

log = logging.getLogger(__name__)


class ClientSlaveManager:
    def __init__(self, args: Any, trainer_dist_adapter):
        self.args = args
        self.trainer_dist_adapter = trainer_dist_adapter
        self.round_idx = 0
        self.finished = False

    def await_sync_process_group(self):
        """Block for the master's round metadata (reference slave manager)."""
        meta = broadcast_round_metadata(None)
        log.debug("slave got round metadata: %s", meta)
        return meta

    def train(self, meta) -> None:
        """The round the metadata names: receive the global params (a slave
        training on stale weights would corrupt the lock-stepped round),
        take the silo's data index, and train."""
        if meta.get("model_version") is not None:
            self.round_idx = int(meta["model_version"])
        params = broadcast_model_params(self.trainer_dist_adapter.get_model_params(),
                                        is_source=False)
        self.trainer_dist_adapter.update_model(params)
        if meta.get("client_index") is not None:
            self.trainer_dist_adapter.update_dataset(int(meta["client_index"]))
        self.trainer_dist_adapter.train(self.round_idx)

    def run(self) -> None:
        while not self.finished:
            meta = self.await_sync_process_group()
            if meta.get("finished"):
                self.finished = True
                log.info("slave finished")
                break
            self.train(meta)
