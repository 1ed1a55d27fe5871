"""SecAgg server-side manager: the counterpart of
``fedml_tpu/cross_silo/secagg/sa_fedml_server_manager.py``.

Reference: ``cross_silo/secagg/sa_fedml_server_manager.py`` — key-directory
broadcast, share routing, masked-model gating, reveal round, reconstruction,
sync. ``run`` runs under the flight recorder, as the JAX manager's does.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.engine import flight_recorded
from .sa_message_define import MyMessage

log = logging.getLogger(__name__)


class SecAggServerManager(FedMLCommManager):
    def __init__(self, args: Any, aggregator, comm=None, client_rank=0, client_num=0, backend="INMEMORY"):
        super().__init__(args, comm, client_rank, client_num + 1, backend)
        self.aggregator = aggregator
        self.round_num = int(getattr(args, "comm_round", 10))
        self.args.round_idx = 0
        self.client_online_status: Dict[int, bool] = {}
        self.is_initialized = False
        self.directory_sent = False
        self.unmask_requested = False
        self.final_metrics: Optional[Dict[str, float]] = None

    def run(self) -> None:
        # a handler exception (mid share routing, mid reconstruction) writes
        # one flight-recorder dump with the comm breadcrumbs attached
        with flight_recorded(role="secagg_server"):
            super().run()

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.handle_message_client_status)
        self.register_message_receive_handler(MyMessage.MSG_TYPE_C2S_PK, self.handle_message_pk)
        self.register_message_receive_handler(MyMessage.MSG_TYPE_C2S_SHARE, self.handle_message_route_share)
        self.register_message_receive_handler(MyMessage.MSG_TYPE_C2S_MASKED_MODEL, self.handle_message_masked_model)
        self.register_message_receive_handler(MyMessage.MSG_TYPE_C2S_REVEAL, self.handle_message_reveal)

    # --- handlers ---------------------------------------------------------
    def handle_message_client_status(self, msg_params: Message) -> None:
        status = msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_STATUS)
        if status is not None and status != MyMessage.MSG_CLIENT_STATUS_ONLINE:
            return  # only ONLINE counts toward the init gate
        self.client_online_status[msg_params.get_sender_id()] = True
        if len(self.client_online_status) == self.size - 1 and not self.is_initialized:
            self.is_initialized = True
            global_model_params = self.aggregator.get_global_model_params()
            for client_id in range(1, self.size):
                msg = Message(MyMessage.MSG_TYPE_S2C_INIT_CONFIG, 0, client_id)
                msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, global_model_params)
                msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, client_id - 1)
                self.send_message(msg)

    def handle_message_pk(self, msg_params: Message) -> None:
        self.aggregator.register_key(
            msg_params.get_sender_id() - 1, int(msg_params.get(MyMessage.MSG_ARG_KEY_PUBLIC_KEY))
        )
        if self.aggregator.all_keys_received() and not self.directory_sent:
            self.directory_sent = True
            directory = dict(self.aggregator.server.public_keys)
            for client_id in range(1, self.size):
                msg = Message(MyMessage.MSG_TYPE_S2C_KEY_DIRECTORY, 0, client_id)
                msg.add_params(MyMessage.MSG_ARG_KEY_KEY_DIRECTORY, directory)
                self.send_message(msg)

    def handle_message_route_share(self, msg_params: Message) -> None:
        dst0 = int(msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_ID))
        msg = Message(MyMessage.MSG_TYPE_S2C_SHARE_TO_CLIENT, 0, dst0 + 1)
        msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_ID, msg_params.get_sender_id() - 1)
        msg.add_params(MyMessage.MSG_ARG_KEY_SK_SHARE, msg_params.get(MyMessage.MSG_ARG_KEY_SK_SHARE))
        msg.add_params(MyMessage.MSG_ARG_KEY_B_SHARE, msg_params.get(MyMessage.MSG_ARG_KEY_B_SHARE))
        self.send_message(msg)

    def handle_message_masked_model(self, msg_params: Message) -> None:
        self.aggregator.add_masked_model(
            msg_params.get_sender_id() - 1, msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        )
        if self.aggregator.all_models_received() and not self.unmask_requested:
            self.unmask_requested = True
            survivors = sorted(self.aggregator.server.masked.keys())
            dropouts = sorted(set(self.aggregator.server.public_keys) - set(survivors))
            for cid in survivors:
                msg = Message(MyMessage.MSG_TYPE_S2C_UNMASK_REQUEST, 0, cid + 1)
                msg.add_params(MyMessage.MSG_ARG_KEY_SURVIVORS, survivors)
                msg.add_params(MyMessage.MSG_ARG_KEY_DROPOUTS, dropouts)
                self.send_message(msg)

    def handle_message_reveal(self, msg_params: Message) -> None:
        self.aggregator.add_reveal(
            msg_params.get_sender_id() - 1, msg_params.get(MyMessage.MSG_ARG_KEY_REVEAL)
        )
        if not self.aggregator.all_reveals_received():
            return
        self.aggregator.aggregate_model_reconstruction()
        metrics = self.aggregator.test_on_server_for_all_clients(self.args.round_idx)
        if metrics is not None:
            self.final_metrics = metrics

        self.args.round_idx += 1
        if self.args.round_idx >= self.round_num:
            for client_id in range(1, self.size):
                self.send_message(Message(MyMessage.MSG_TYPE_S2C_FINISH, 0, client_id))
            self.finish()
            return
        self.aggregator.new_round()
        self.directory_sent = False
        self.unmask_requested = False
        global_model_params = self.aggregator.get_global_model_params()
        for client_id in range(1, self.size):
            msg = Message(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, client_id)
            msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, global_model_params)
            msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, client_id - 1)
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.args.round_idx)
            self.send_message(msg)
