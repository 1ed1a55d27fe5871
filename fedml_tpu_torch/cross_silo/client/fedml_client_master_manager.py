"""Cross-silo client manager (the WAN state machine, client side): the
synchronous path of ``fedml_tpu/cross_silo/client/fedml_client_master_manager.py``.

Reference: ``cross_silo/client/fedml_client_master_manager.py:22`` — ONLINE
report (:178), handle_message_init (:100), __train (:232), model upload
(:164).

Uplink compression (``comm_compressor``: topk, eftopk, quantize, qsgd) runs
at the upload through the engine's ``compress_upload`` (``client.compress``),
the whole model as one flat vector (``utils/compression.py``); the server
decompresses every arrival. The payload is a dict of tensors and a flat spec
of names, shapes and dtypes. Over a byte backend (MQTT_S3, MQTT_WEB3,
MQTT_THETASTORE, TRPC, GRPC, MPI) the codecs (``serialization.py``, no
pickle) cannot carry that spec, and the JAX package's own codecs fail on its
payload at the receiver (ROADMAP.md, Queue 3, R6: over MQTT_S3 its treedef
pickles on the way out and ``allow_pickle=False`` refuses it on the way in;
over TRPC the spec's dtype-name array has no raw dtype), so the port refuses
``comm_compressor`` with a byte backend up front.

Every upload carries the client's telemetry delta (the spans, counters
and histograms since its last upload, JSON) in the reserved header, as in
the JAX package (``:350-372``): the server's fleet view merges it, and its
health tracker reads each ``client.train`` span as the rank's round time.
The local round runs through the engine's ``run_local_round`` with the
chaos knobs (straggler delay, scheduled raise, NaN poison, delta scaling);
a client whose local round raises dies alone: the exception ends its own
receive loop, and the broker and the other silos carry on.

Privacy (``privacy``: ``secagg``, ``dp``, ``secagg+dp``; JAX ``:110-125``,
``:184-348``). With ``dp`` the client keeps the last global it received as
its anchor and clips each upload's delta against it onto the L2 ball of
``dp_l2_clip`` before anything else. With ``secagg`` an upload leaves this
process only as a masked ring payload: the four SecAgg handlers build the
window member on each ANNOUNCE (a fresh DH keypair, its public key sent
back), install the key DIRECTORY (deriving the pair seeds and dealing
Shamir shares of the window key through the server's relay), hold the
relayed shares, and answer a REVEAL_REQUEST with the shares of the dropped
ranks. The member is kept after it masks (the reveal needs its shares) and
masks once; an upload before the directory, or after the member masked,
waits for the next one. The masked uplink replaces the compressor: with
``comm_compressor`` topk or eftopk it gathers the window's shared rand-k
support. ``core.privacy.outbound_delta`` gates every upload.
``chaos_secagg_drop_upload_at_round`` drops the masked upload of that round
after key exchange (the reveal drill).

Not ported (ROADMAP.md, Queue 1): the link-probe handler is absent, and the
delta carries no link estimates (netlink). ``init`` refuses
``num_processes > 1``, so a silo is one process and there are no slave
processes to synchronise.
"""

from __future__ import annotations

import logging
import platform
import threading
from typing import Any, Optional

import numpy as np

from ...core import telemetry as tel
from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import _BYTE_BACKENDS, FedMLCommManager
from ...core.engine import compress_upload, refuse_chaos_knobs, run_local_round
from ...core.privacy import (QuantSpec, WindowMember, clip_to_reference, masked_uplink_payload,
                             outbound_delta, privacy_from_args)
from ...core.telemetry import trace_context
from ...utils.compression import make_comm_compressor, secagg_support
from ..message_define import MyMessage

log = logging.getLogger(__name__)


class ClientMasterManager(FedMLCommManager):
    def __init__(self, args: Any, trainer_dist_adapter, comm=None, rank=0, size=0, backend="INMEMORY"):
        refuse_chaos_knobs(args)
        # opt-in uplink compression at the flat-vector boundary; eftopk keeps
        # its residual here
        self._comm_compressor = make_comm_compressor(args)
        # under secagg the masked uplink replaces the compressor (its payload
        # is a flat dict the codec carries)
        if self._comm_compressor is not None and str(backend).upper() in _BYTE_BACKENDS \
                and not privacy_from_args(args).secagg:
            # JAX's compressed payload fails on every byte backend (its spec
            # is not a codec leaf: ROADMAP.md, Queue 3, R6); the port adds no
            # compressed wire that JAX lacks
            raise NotImplementedError(
                f"comm_compressor over {str(backend).upper()}: the byte codecs cannot carry "
                "the compressed payload's spec, in the JAX package too; compressed uplinks "
                "run over INMEMORY only (see ROADMAP.md, Queue 3, R6)")
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
        # privacy: with secagg on, an upload leaves this process ONLY as a
        # masked ring payload; the window member is built per ANNOUNCE and
        # an upload waits until its key directory is complete
        self._privacy = privacy_from_args(args)
        self._secagg_member: Optional[WindowMember] = None
        self._secagg_support_ratio: Optional[float] = None
        self._pending_upload: Optional[tuple] = None
        # DP sensitivity: the last global model received, the anchor each
        # upload's delta is clipped against (clients ship full weights)
        self._dp_anchor = None

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
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SECAGG_ANNOUNCE, self.handle_message_secagg_announce)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SECAGG_DIRECTORY, self.handle_message_secagg_directory)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SECAGG_SHARE_RELAY, self.handle_message_secagg_share_relay)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SECAGG_REVEAL_REQUEST, self.handle_message_secagg_reveal_request)

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
        if self._privacy.dp:
            self._dp_anchor = global_model_params
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
        if self._privacy.dp:
            self._dp_anchor = model_params
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

    # --- windowed SecAgg (the client side of core/privacy) -----------------
    def handle_message_secagg_announce(self, msg_params: Message) -> None:
        """A masking window opened for a cohort holding this rank: build the
        window member (a fresh DH keypair) and answer with its public key.
        The member replaces the previous one: windows are single-use."""
        spec_doc = dict(msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_SPEC) or {})
        self._secagg_support_ratio = spec_doc.pop("support_ratio", None)
        self._secagg_member = WindowMember(
            int(self.client_real_id),
            int(msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID)),
            int(msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_NONCE)),
            [int(r) for r in msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_COHORT)],
            QuantSpec(**spec_doc),
            int(msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_THRESHOLD)),
        )
        reply = Message(MyMessage.MSG_TYPE_C2S_SECAGG_PUBKEY, self.client_real_id,
                        msg_params.get_sender_id())
        reply.add_params(MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID, self._secagg_member.window_id)
        reply.add_params(MyMessage.MSG_ARG_KEY_SECAGG_PUBKEY, int(self._secagg_member.public_key))
        self.send_message(reply)

    def handle_message_secagg_directory(self, msg_params: Message) -> None:
        """Every cohort member's public key is in: derive the pair seeds,
        deal Shamir shares of this member's window key through the server's
        relay, and flush an upload that waited for the directory."""
        member = self._secagg_member
        if member is None:
            return
        directory = {int(r): int(pk) for r, pk in
                     dict(msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_PUBKEY)).items()}
        member.install_directory(directory)
        shares = {int(peer): [int(v) for v in np.asarray(share).ravel()]
                  for peer, share in member.deal_shares().items() if int(peer) != member.rank}
        relay = Message(MyMessage.MSG_TYPE_C2S_SECAGG_SHARES, self.client_real_id,
                        msg_params.get_sender_id())
        relay.add_params(MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID, member.window_id)
        relay.add_params(MyMessage.MSG_ARG_KEY_SECAGG_SHARES, shares)
        self.send_message(relay)
        if self._pending_upload is not None:
            receive_id, weights, n = self._pending_upload
            self._pending_upload = None
            self.send_model_to_server(receive_id, weights, n)

    def handle_message_secagg_share_relay(self, msg_params: Message) -> None:
        member = self._secagg_member
        if member is None:
            return
        member.receive_share(
            int(msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_DEALER)),
            np.asarray(list(msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_SHARE)), np.int64))

    def handle_message_secagg_reveal_request(self, msg_params: Message) -> None:
        """The mask-share reveal for a partial close: this survivor's shares
        of each dropped member's window key. The client refuses only its OWN
        rank: it cannot see whether a peer submitted, so the server is
        trusted not to equivocate on the dropped set (docs/privacy.md).
        Requests for another window than the member's are ignored: their
        shares would be reconstructed against the wrong nonce's masks."""
        member = self._secagg_member
        if member is None:
            return
        req_window = msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID)
        if req_window is not None and int(req_window) != member.window_id:
            return
        dropped = [int(r) for r in msg_params.get(MyMessage.MSG_ARG_KEY_SECAGG_DROPPED)]
        reply = Message(MyMessage.MSG_TYPE_C2S_SECAGG_REVEAL, self.client_real_id,
                        msg_params.get_sender_id())
        reply.add_params(MyMessage.MSG_ARG_KEY_SECAGG_WINDOW_ID, member.window_id)
        reply.add_params(MyMessage.MSG_ARG_KEY_SECAGG_REVEALS, member.reveal_shares(dropped))
        self.send_message(reply)

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
        if self._privacy.dp and self._dp_anchor is not None:
            # enforce the sensitivity bound the server's sigma is calibrated
            # against: the delta against the anchor onto the L2 ball BEFORE
            # masking or compression (the input itself within the ball).
            # Idempotent, so re-clipping a queued upload's replay is safe.
            weights = clip_to_reference(weights, self._dp_anchor, self._privacy.l2_clip)
        if self._privacy.secagg:
            # the masked uplink replaces the compressor: sparsification is
            # the window's shared rand-k support, and the payload reaches
            # the wire as it is
            weights = self._mask_upload(receive_id, weights, local_sample_num)
            if weights is None:
                return  # queued for the window's directory (or dropped by chaos)
        with tel.span("client.upload", round=int(self.args.round_idx)):
            if not self._privacy.secagg:
                weights = compress_upload(self._comm_compressor, weights)
            weights = outbound_delta(weights, cfg=self._privacy)
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

    def _mask_upload(self, receive_id: int, weights, local_sample_num):
        """Quantize and mask the upload into its window's ring, or queue it
        when the window's key directory is not complete yet. Returns the
        masked payload dict (the only form a secagg upload takes on the
        wire), or None when queued. A member masks exactly once (its
        nonce-derived masks are one-time pads), so an upload after it masked
        waits for the next ANNOUNCE. The member is KEPT after masking: the
        window stays open on the server until the cohort completes or the
        deadline's reveal runs, and answering a REVEAL_REQUEST needs its
        held shares."""
        member = self._secagg_member
        if member is None or member.submitted or not member._pair_seeds:
            self._pending_upload = (receive_id, weights, local_sample_num)
            return None
        drop_at = getattr(self.args, "chaos_secagg_drop_upload_at_round", None)
        if drop_at is not None and int(self.args.round_idx) == int(drop_at):
            # chaos drill: vanish mid-window AFTER key exchange; the server
            # sees this rank missing while the survivors hold its shares:
            # the mask-share reveal's recovery path
            log.warning("chaos: dropping the secagg upload at round %d (window %d)",
                        int(self.args.round_idx), member.window_id)
            return None
        support = None
        if self._secagg_support_ratio:
            d = sum(v.numel() for v in weights.values())
            support = secagg_support(member.nonce, d, float(self._secagg_support_ratio))
        with tel.span("client.secagg_mask", window=member.window_id):
            return masked_uplink_payload(member, weights, support=support)

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
