"""Cross-silo client manager (the WAN state machine, client side): the
synchronous path of ``fedml_tpu/cross_silo/client/fedml_client_master_manager.py``.

Reference: ``cross_silo/client/fedml_client_master_manager.py:22`` — ONLINE
report (:178), handle_message_init (:100), __train (:232), model upload
(:164).

Uplink compression (``comm_compressor``: topk, eftopk, quantize, qsgd) runs
at the upload through the engine's ``compress_upload`` (``client.compress``),
the whole model as one flat vector (``utils/compression.py``); the server
decompresses every arrival. The payload is a dict of tensors and a flat spec
of names, shapes and dtypes. Over MQTT_S3 the npz codec
(``serialization.py``, no pickle) cannot carry that spec, and the JAX
package's own codec fails on its payload at the receiver (its treedef
pickles on the way out and ``allow_pickle=False`` refuses it on the way
in), so the port refuses ``comm_compressor`` with MQTT_S3 up front.

Every upload carries the client's telemetry delta (the spans, counters
and histograms since its last upload, JSON) in the reserved header, as in
the JAX package (``:350-372``): the server's fleet view merges it, and its
health tracker reads each ``client.train`` span as the rank's round time.
The local round runs through the engine's ``run_local_round`` with the
chaos knobs (straggler delay, scheduled raise, NaN poison, delta scaling);
a client whose local round raises dies alone: the exception ends its own
receive loop, and the broker and the other silos carry on.

Not ported (ROADMAP.md, Queue 1): privacy (``privacy``) raises
NotImplementedError; the link-probe and SecAgg handlers are absent, and the
delta carries no link estimates (netlink). ``init`` refuses
``num_processes > 1``, so a silo is one process and there are no slave
processes to synchronise.
"""

from __future__ import annotations

import logging
import platform
import threading
from typing import Any, Optional

from ...core import telemetry as tel
from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.engine import (compress_upload, knob_set, refuse_chaos_knobs, refuse_knobs,
                            run_local_round)
from ...core.telemetry import trace_context
from ...utils.compression import make_comm_compressor
from ..message_define import MyMessage

log = logging.getLogger(__name__)

_KNOBS = (("privacy", knob_set),)


class ClientMasterManager(FedMLCommManager):
    def __init__(self, args: Any, trainer_dist_adapter, comm=None, rank=0, size=0, backend="INMEMORY"):
        refuse_knobs(args, _KNOBS, "privacy is")
        refuse_chaos_knobs(args)
        # opt-in uplink compression at the flat-vector boundary; eftopk keeps
        # its residual here
        self._comm_compressor = make_comm_compressor(args)
        if self._comm_compressor is not None and str(backend).upper() == "MQTT_S3":
            raise NotImplementedError(
                "comm_compressor over MQTT_S3: the npz codec cannot carry the compressed "
                "payload's spec; compressed uplinks over a byte backend are not ported to "
                "fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")
        super().__init__(args, comm, rank, size, backend)
        self.trainer_dist_adapter = trainer_dist_adapter
        self.num_rounds = int(getattr(args, "comm_round", 10))
        self.args.round_idx = 0
        self.rank = rank
        self.client_real_id = rank
        self.has_sent_online_msg = False
        self.is_inited = False
        # the published-model version this client last trained on; echoed on
        # upload (the JAX server's async buffer reads it)
        self._model_version: Optional[int] = None
        # telemetry shipping: spans after this seq go out with the next upload.
        # It starts at the registry's newest span, not at 0 (the JAX
        # package's start): over INMEMORY the delta is this thread's spans,
        # and a thread ident of an earlier, ended party is reused, so a
        # cursor of 0 would ship that party's spans as this client's
        self._tel_cursor = tel.get_telemetry().delta_snapshot(tid=-1)["cursor"]

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(MyMessage.MSG_TYPE_CONNECTION_IS_READY, self.handle_message_connection_ready)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_CHECK_CLIENT_STATUS, self.handle_message_check_status
        )
        self.register_message_receive_handler(MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.handle_message_init)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, self.handle_message_receive_model_from_server
        )
        self.register_message_receive_handler(MyMessage.MSG_TYPE_S2C_FINISH, self.handle_message_finish)

    def handle_message_connection_ready(self, msg_params: Message) -> None:
        if not self.has_sent_online_msg:
            self.has_sent_online_msg = True
            self.send_client_status(0, MyMessage.MSG_CLIENT_STATUS_ONLINE)

    def handle_message_check_status(self, msg_params: Message) -> None:
        """A server probing liveness before init (reference server
        fedml_server_manager.py:113-121 sends CHECK_CLIENT_STATUS to clients
        that may have started earlier; reference client :97 answers with its
        status). Answering keeps us interoperable with the reference server."""
        self.send_client_status(0, MyMessage.MSG_CLIENT_STATUS_ONLINE)

    def handle_message_init(self, msg_params: Message) -> None:
        if self.is_inited:
            return
        self.is_inited = True
        global_model_params = msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        data_silo_index = msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX)
        self.client_index = int(data_silo_index)
        self.trainer_dist_adapter.update_dataset(int(data_silo_index))
        self.trainer_dist_adapter.update_model(global_model_params)
        # a resumed server's first round is not 0 — adopt its round index so
        # local-training seeds replay exactly
        self.args.round_idx = int(msg_params.get(MyMessage.MSG_ARG_KEY_ROUND_IDX) or 0)
        self._adopt_model_version(msg_params)
        self.__train()

    def handle_message_receive_model_from_server(self, msg_params: Message) -> None:
        model_params = msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        client_index = msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX)
        self.client_index = int(client_index)
        self.trainer_dist_adapter.update_dataset(int(client_index))
        self.trainer_dist_adapter.update_model(model_params)
        self._adopt_model_version(msg_params)
        ridx = msg_params.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        if ridx is not None:
            # our server stamps every sync with its round index; adopt it —
            # with subset cohorts or a resumed server the local +1 counter
            # would drift from the true round
            self.args.round_idx = int(ridx)
            self.__train()
        elif self.args.round_idx + 1 < self.num_rounds:
            self.args.round_idx += 1
            self.__train()
        else:
            # The CLIENT gates round completion in the reference protocol:
            # its server always syncs the final aggregate back and waits for
            # every client's FINISHED status before exiting
            # (fedml_client_master_manager.py:143-152, server
            # process_finished_status:147-165). Our own server instead sends
            # S2C_FINISH after the last aggregation, so this branch only
            # fires against a reference server — without it the pair would
            # train forever.
            self.args.round_idx += 1
            self.send_client_status(0, MyMessage.MSG_CLIENT_STATUS_FINISHED)
            self.finish()

    def handle_message_finish(self, msg_params: Message) -> None:
        log.info("====== training finished ======")
        self.finish()

    def _adopt_model_version(self, msg_params: Message) -> None:
        v = msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_VERSION)
        if v is not None:
            self._model_version = int(v)

    def send_client_status(self, receive_id: int, status: str) -> None:
        message = Message(MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.client_real_id, receive_id)
        message.add_params(MyMessage.MSG_ARG_KEY_CLIENT_STATUS, status)
        message.add_params(MyMessage.MSG_ARG_KEY_CLIENT_OS, platform.system())
        self.send_message(message)

    def send_model_to_server(self, receive_id: int, weights, local_sample_num) -> None:
        with tel.span("client.upload", round=int(self.args.round_idx)):
            weights = compress_upload(self._comm_compressor, weights)
            message = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.client_real_id, receive_id)
            message.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, weights)
            message.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, int(local_sample_num))
            # round tag: a JAX server's quorum discards deltas from past rounds
            message.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, int(self.args.round_idx))
            if self._model_version is not None:
                # staleness tag: which published model this delta trained on
                message.add_params(MyMessage.MSG_ARG_KEY_MODEL_VERSION, int(self._model_version))
            self._attach_telemetry_delta(message)
            self.send_message(message)

    def _attach_telemetry_delta(self, message: Message) -> None:
        """Ship the spans and counters accumulated since the last upload
        under the reserved header; the server folds them into its fleet
        view. Over INMEMORY every party shares this process's registry, so
        only this client's thread is shipped; a byte backend's party owns
        its registry and ships every thread."""
        t = tel.get_telemetry()
        if not t.enabled:
            return
        tid = threading.get_ident() if self.backend == "INMEMORY" else None
        delta = t.delta_snapshot(self._tel_cursor, tid=tid)
        self._tel_cursor = delta.pop("cursor")
        delta["rank"] = int(self.client_real_id)
        message.add_params(Message.MSG_ARG_KEY_TELEMETRY, {trace_context.DELTA_FIELD: delta})

    def __train(self) -> None:
        log.info("====== training on round %d ======", self.args.round_idx)
        # the client.train span and the chaos knobs live in the engine's
        # shared local-round scaffolding
        weights, local_sample_num = run_local_round(
            lambda: self.trainer_dist_adapter.train(self.args.round_idx),
            self.args,
            int(self.args.round_idx),
            rank=self.client_real_id,
        )
        self.send_model_to_server(0, weights, local_sample_num)
