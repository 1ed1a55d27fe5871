"""Cross-silo server manager (the WAN state machine, server side): the
synchronous FedAvg path of ``fedml_tpu/cross_silo/server/fedml_server_manager.py``.

Reference: ``cross_silo/server/fedml_server_manager.py:15`` — gate on all
clients ONLINE (:124-144), send_init_msg (:48-67), per-model receive ->
aggregate -> sync (steps 3-8 of SURVEY §3.2).

Spans: ``server.round`` (one per round, the trace root whose context rides
every broadcast), ``server.broadcast`` (the engine's ``RemoteCommStrategy``),
``server.receive_model`` (one per arrival), ``server.aggregate`` (the
aggregator) and ``server.eval``. The server's wait for its cohort is
``server.round`` less the others. As in the JAX package, round 0's INIT
messages go out inside ``server.round`` but outside ``server.broadcast``.

Async rounds (``async_rounds``, JAX ``:753-866``): every arrival folds into
the aggregator's FedBuff buffer at once (``server.async_receive``), a model
publishes every ``async_publish_k`` merges, and each upload is answered to
its sender alone with the newest global and its ``MODEL_VERSION``;
``round_idx`` counts publishes and the run finishes after ``comm_round`` of
them. A compressed upload (``comm_compressor`` on the clients) is
decompressed on arrival (``server.decompress``) on either path.

Not ported, each raising NotImplementedError when its knob is set
(ROADMAP.md, Queue 1): mid-window buffer checkpoints
(``async_checkpoint_every_merges``) and link-cost admission
(``async_link_admission``); quorum, over-provisioning and round deadlines;
resume and durable round state (``resilience_dir``); link probing and
WAN-aware health; statusz; the SLO engine; fleet trace export; SecAgg
windows (with ``privacy``, refused by the aggregator); the chaos knobs.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from ...core import telemetry as tel
from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.engine import (RemoteCommStrategy, decompress_arrival, knob_set,
                            refuse_chaos_knobs, refuse_knobs)
from ...core.telemetry import trace_context
from ..message_define import MyMessage

log = logging.getLogger(__name__)

_KNOBS = (
    ("async_checkpoint_every_merges", knob_set),
    ("async_link_admission", knob_set),
    ("round_deadline_s", lambda v: v is not None),
    ("quorum_frac", lambda v: v is not None and float(v) < 1.0),
    ("adaptive_deadline", knob_set),
    ("overprovision_frac", knob_set),
    ("client_num_connected", knob_set),
    ("resilience_dir", knob_set),
    ("resume", knob_set),
    ("link_probe_interval_s", knob_set),
    ("link_wan_health", knob_set),
    ("statusz_port", lambda v: v is not None),
    ("slo_spec", knob_set),
    ("slo_tick_s", knob_set),
    ("fleet_trace", knob_set),
)


class FedMLServerManager(FedMLCommManager):
    def __init__(self, args: Any, aggregator, comm=None, client_rank=0, client_num=0, backend="INMEMORY"):
        refuse_knobs(args, _KNOBS, "async checkpoints and link admission, quorum rounds and "
                                   "deadlines, resume, link probing, statusz, the SLO engine "
                                   "and fleet telemetry are")
        refuse_chaos_knobs(args)
        super().__init__(args, comm, client_rank, client_num + 1, backend)
        self.aggregator = aggregator
        self.round_num = int(getattr(args, "comm_round", 10))
        self.args.round_idx = 0
        self.client_online_status: Dict[int, bool] = {}
        self.client_id_list_in_this_round = None
        self.data_silo_index_list = None
        self.is_initialized = False
        self.final_metrics: Optional[Dict[str, float]] = None
        # distributed tracing: one trace id per run; each round is a
        # server.round span whose seq is the parent of everything the round's
        # broadcasts reach (clients restore it from the message header)
        self.trace_id = trace_context.new_trace_id()
        self._round_span = None
        self._round_span_idx: Optional[int] = None
        # async (non-barrier) rounds: round_idx counts PUBLISHES, every upload
        # gets an immediate model reply, and each client's silo assignment is
        # remembered for those replies
        self._async_mode = bool(getattr(args, "async_rounds", False))
        self._silo_of: Dict[int, int] = {}
        # broadcast half of the engine's remote-comm strategy: arrivals come
        # back through the message handlers, so only the server.broadcast
        # side runs here
        self._strategy = RemoteCommStrategy(self.send_message_sync_model_to_client)

    def _begin_round_trace(self) -> None:
        self._end_round_trace()
        sp = tel.get_telemetry().span("server.round", round=int(self.args.round_idx))
        sp.__enter__()
        self._round_span = sp
        self._round_span_idx = int(self.args.round_idx)
        trace_context.set_current(
            trace_context.TraceContext(self.trace_id, getattr(sp, "seq", None), int(self.args.round_idx))
        )

    def _end_round_trace(self) -> None:
        if self._round_span is None:
            return
        # the round span is the trace root: record it parentless, not
        # pointing at its own seq
        trace_context.set_current(
            trace_context.TraceContext(self.trace_id, None, self._round_span_idx)
        )
        self._round_span.__exit__(None, None, None)
        self._round_span = None
        trace_context.set_current(None)

    # --- round bootstrap --------------------------------------------------
    def send_init_msg(self) -> None:
        self._begin_round_trace()
        global_model_params = self.aggregator.get_global_model_params()
        for idx, client_id in enumerate(self.client_id_list_in_this_round):
            self.send_message_init_config(
                client_id, global_model_params, self.data_silo_index_list[idx]
            )

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(MyMessage.MSG_TYPE_CONNECTION_IS_READY, self.handle_message_connection_ready)
        self.register_message_receive_handler(MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.handle_message_client_status_update)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.handle_message_receive_model_from_client
        )

    # --- cohort selection -------------------------------------------------
    def _select_cohort(self) -> None:
        """Pick this round's cohort of client ranks and their data silos."""
        k = int(getattr(self.args, "client_num_per_round", self.size - 1))
        self.client_id_list_in_this_round = self.aggregator.client_selection(
            self.args.round_idx, list(range(1, self.size)), k
        )
        self.data_silo_index_list = self.aggregator.data_silo_selection(
            self.args.round_idx,
            int(getattr(self.args, "client_num_in_total", self.size - 1)),
            len(self.client_id_list_in_this_round),
        )
        # async replies go to one sender at a time, long after the cohort
        # list was built: remember each client's silo
        self._silo_of = {int(cid): int(self.data_silo_index_list[i])
                         for i, cid in enumerate(self.client_id_list_in_this_round)}

    # --- handlers ---------------------------------------------------------
    def handle_message_connection_ready(self, msg_params: Message) -> None:
        if self.is_initialized:
            return
        self._select_cohort()

    def handle_message_client_status_update(self, msg_params: Message) -> None:
        status = msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_STATUS)
        sender = msg_params.get_sender_id()
        if status == MyMessage.MSG_CLIENT_STATUS_ONLINE:
            self.client_online_status[sender] = True
            log.info("client %d online (%d/%d)", sender, len(self.client_online_status), self.size - 1)
        all_online = all(self.client_online_status.get(cid, False) for cid in range(1, self.size))
        if all_online and not self.is_initialized:
            self.is_initialized = True
            self.send_init_msg()

    def handle_message_receive_model_from_client(self, msg_params: Message) -> None:
        sender_id = msg_params.get_sender_id()
        model_params = decompress_arrival(msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS),
                                          sender_id)
        local_sample_number = msg_params.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES)
        if self._async_mode:
            self._handle_async_upload(sender_id, model_params, local_sample_number, msg_params)
            return
        with tel.span("server.receive_model", round=int(self.args.round_idx), sender=int(sender_id)):
            self.aggregator.add_local_trained_result(sender_id - 1, model_params, local_sample_number)
        if not self.aggregator.check_whether_all_receive():
            return
        self._complete_round()

    def _complete_round(self) -> None:
        """Aggregate every arrival, evaluate, and advance — or finish the
        run."""
        round_idx = int(self.args.round_idx)
        # FedMLAggregator.aggregate opens the server.aggregate span itself
        global_model_params = self.aggregator.aggregate()
        with tel.span("server.eval", round=round_idx):
            metrics = self.aggregator.test_on_server_for_all_clients(round_idx)
        if metrics is not None:
            self.final_metrics = metrics
        tel.counter("engine.rounds").add(1)
        self.args.round_idx += 1
        if self.args.round_idx >= self.round_num:
            self.send_finish_to_all()
            self._end_round_trace()
            self.finish()
            return
        self._select_cohort()
        self._begin_round_trace()
        self._strategy.broadcast(
            int(self.args.round_idx), global_model_params,
            self.client_id_list_in_this_round, self.data_silo_index_list,
        )

    # --- async (non-barrier) flow ------------------------------------------
    def _handle_async_upload(self, sender_id: int, model_params, local_sample_number,
                             msg_params: Message) -> None:
        """One async arrival: fold it at once, publish if the window filled,
        and reply to THIS sender with the newest global model so it starts
        its next local round while the others still train."""
        client_version = msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_VERSION)
        buf = self.aggregator.async_buffer
        with tel.span("server.async_receive", sender=int(sender_id), version=buf.version):
            self.aggregator.submit_async_result(
                sender_id - 1, model_params, local_sample_number,
                None if client_version is None else int(client_version))
        if buf.ready():
            self._complete_async_publish()
            if self.args.round_idx >= self.round_num:
                return  # finished: S2C_FINISH already sent to everyone
        self.send_message_sync_model_to_client(
            sender_id, self.aggregator.get_global_model_params(),
            self._silo_of.get(int(sender_id), sender_id - 1))

    def _complete_async_publish(self) -> None:
        """Publish one model generation and do its bookkeeping."""
        if self.aggregator.publish_async() is None:
            return
        self._after_async_publish()

    def _after_async_publish(self) -> None:
        """Evaluate the generation just published on the test cadence, and
        finish the run after ``comm_round`` publishes. The new global is
        installed."""
        buf = self.aggregator.async_buffer
        round_idx = buf.version - 1  # the generation just published
        self.args.round_idx = buf.version
        with tel.span("server.eval", round=round_idx):
            metrics = self.aggregator.test_on_server_for_all_clients(round_idx)
        if metrics is not None:
            self.final_metrics = metrics
        tel.counter("engine.rounds").add(1)
        if buf.version >= self.round_num:
            self.send_finish_to_all()
            self._end_round_trace()
            self.finish()
            return
        self._begin_round_trace()

    def _model_version(self) -> int:
        """The published-model version stamped on every model sync: the
        async buffer's version in async mode, the round index otherwise (one
        publish a round makes them the same synchronously)."""
        buf = getattr(self.aggregator, "async_buffer", None)
        return int(buf.version) if buf is not None else int(self.args.round_idx)

    # --- senders ----------------------------------------------------------
    def send_message_init_config(self, receive_id: int, global_model_params, datasilo_index) -> None:
        message = Message(MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.get_sender_id(), receive_id)
        message.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, global_model_params)
        message.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, int(datasilo_index))
        message.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, int(self.args.round_idx))
        message.add_params(MyMessage.MSG_ARG_KEY_MODEL_VERSION, self._model_version())
        self.send_message(message)

    def send_message_sync_model_to_client(self, receive_id: int, global_model_params, client_index) -> None:
        message = Message(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, self.get_sender_id(), receive_id)
        message.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, global_model_params)
        message.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, int(client_index))
        message.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.args.round_idx)
        message.add_params(MyMessage.MSG_ARG_KEY_MODEL_VERSION, self._model_version())
        self.send_message(message)

    def send_finish_to_all(self) -> None:
        for client_id in range(1, self.size):
            message = Message(MyMessage.MSG_TYPE_S2C_FINISH, self.get_sender_id(), client_id)
            self.send_message(message)
