"""LightSecAgg server-side manager: the counterpart of
``fedml_tpu/cross_silo/lightsecagg/lsa_fedml_server_manager.py``.

Reference: ``cross_silo/lightsecagg/lsa_fedml_server_manager.py`` — routes
encoded-mask shares between clients, gates on all masked models, queries the
active set for aggregate masks, then reconstructs + syncs. ``run`` runs
under the flight recorder, as the JAX manager's does; its mlops events are
not ported (ROADMAP.md, Queue 4).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.engine import flight_recorded
from .lsa_message_define import MyMessage

log = logging.getLogger(__name__)


class LightSecAggServerManager(FedMLCommManager):
    def __init__(self, args: Any, aggregator, comm=None, client_rank=0, client_num=0, backend="INMEMORY"):
        super().__init__(args, comm, client_rank, client_num + 1, backend)
        self.aggregator = aggregator
        self.round_num = int(getattr(args, "comm_round", 10))
        self.args.round_idx = 0
        self.client_online_status: Dict[int, bool] = {}
        self.is_initialized = False
        self.mask_request_sent = False
        self.final_metrics: Optional[Dict[str, float]] = None

    def run(self) -> None:
        # a handler exception (mid share routing, mid reconstruction) writes
        # one flight-recorder dump with the comm breadcrumbs attached
        with flight_recorded(role="lightsecagg_server"):
            super().run()

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.handle_message_client_status)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_ENCODED_MASK_TO_SERVER, self.handle_message_route_encoded_mask
        )
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.handle_message_receive_model
        )
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MASK_TO_SERVER, self.handle_message_receive_aggregate_mask
        )

    # --- handlers ---------------------------------------------------------
    def handle_message_client_status(self, msg_params: Message) -> None:
        status = msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_STATUS)
        if status is not None and status != MyMessage.MSG_CLIENT_STATUS_ONLINE:
            return  # only ONLINE counts toward the init gate
        sender = msg_params.get_sender_id()
        self.client_online_status[sender] = True
        if len(self.client_online_status) == self.size - 1 and not self.is_initialized:
            self.is_initialized = True
            global_model_params = self.aggregator.get_global_model_params()
            for client_id in range(1, self.size):
                msg = Message(MyMessage.MSG_TYPE_S2C_INIT_CONFIG, 0, client_id)
                msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, global_model_params)
                msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, client_id - 1)
                self.send_message(msg)

    def handle_message_route_encoded_mask(self, msg_params: Message) -> None:
        """Share from client i for (0-based) client j — forward (reference
        lsa_fedml_server_manager handle_message_receive_encoded_mask)."""
        src_rank = msg_params.get_sender_id()
        dst0 = int(msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_ID))
        msg = Message(MyMessage.MSG_TYPE_S2C_ENCODED_MASK_TO_CLIENT, 0, dst0 + 1)
        msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_ID, src_rank - 1)
        msg.add_params(
            MyMessage.MSG_ARG_KEY_ENCODED_MASK, msg_params.get(MyMessage.MSG_ARG_KEY_ENCODED_MASK)
        )
        self.send_message(msg)

    def handle_message_receive_model(self, msg_params: Message) -> None:
        sender = msg_params.get_sender_id()
        self.aggregator.add_local_trained_result(
            sender - 1, msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        )
        if self.aggregator.check_whether_all_receive() and not self.mask_request_sent:
            self.mask_request_sent = True
            active = sorted(self.aggregator.masked_models.keys())
            # ask U actives for their aggregate encoded masks (reference
            # "the server asks the active users to upload the aggregate mask")
            for idx in active[: self.aggregator.cfg.target_active]:
                msg = Message(MyMessage.MSG_TYPE_S2C_SEND_TO_ACTIVE_CLIENT, 0, idx + 1)
                msg.add_params(MyMessage.MSG_ARG_KEY_ACTIVE_CLIENTS, active)
                self.send_message(msg)

    def handle_message_receive_aggregate_mask(self, msg_params: Message) -> None:
        sender = msg_params.get_sender_id()
        self.aggregator.add_local_aggregate_encoded_mask(
            sender - 1, msg_params.get(MyMessage.MSG_ARG_KEY_AGGREGATE_ENCODED_MASK)
        )
        if not self.aggregator.check_whether_all_aggregate_encoded_mask_receive():
            return
        self.aggregator.aggregate_model_reconstruction()
        metrics = self.aggregator.test_on_server_for_all_clients(self.args.round_idx)
        if metrics is not None:
            self.final_metrics = metrics
        self.mask_request_sent = False

        self.args.round_idx += 1
        if self.args.round_idx >= self.round_num:
            for client_id in range(1, self.size):
                self.send_message(Message(MyMessage.MSG_TYPE_S2C_FINISH, 0, client_id))
            self.finish()
            return
        global_model_params = self.aggregator.get_global_model_params()
        for client_id in range(1, self.size):
            msg = Message(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, client_id)
            msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, global_model_params)
            msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, client_id - 1)
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.args.round_idx)
            self.send_message(msg)
