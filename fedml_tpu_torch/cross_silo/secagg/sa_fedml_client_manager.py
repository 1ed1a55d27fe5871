"""SecAgg client-side manager: the counterpart of
``fedml_tpu/cross_silo/secagg/sa_fedml_client_manager.py``.

Reference: ``cross_silo/secagg/sa_fedml_client_manager.py`` — drives one
Bonawitz exchange per FL round: fresh keys, Shamir share distribution (routed
via the server), masked upload, and the reveal phase. The crypto lives in
``core/mpc/secagg.SecAggClient``; this class is the message-plane state
machine around it.

The trained state dict is quantized on its device in the JAX flat order
(``wire_vector``, each leaf cast to float32 first, as JAX does) and comes
to the host in one copy; keys, shares and masks are host numpy from JAX's
generator (``random_seed * 977 + rank``), so this client masks as a JAX
client of the same seed does (``client.train``, ``sa.quantize``,
``sa.mask`` spans). The JAX manager also runs under the flight recorder
and logs mlops events; this one does neither (the server managers run
under the recorder; mlops is ROADMAP.md, Queue 4).
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ...core import telemetry as tel
from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.mpc.finite_field import DEFAULT_PRIME, quantize
from ...core.mpc.secagg import SecAggClient, SecAggConfig
from ...models.convert import wire_vector
from .sa_message_define import MyMessage

log = logging.getLogger(__name__)


class SecAggClientManager(FedMLCommManager):
    def __init__(self, args: Any, trainer_dist_adapter, comm=None, rank=0, size=0, backend="INMEMORY"):
        super().__init__(args, comm, rank, size, backend)
        self.trainer_dist_adapter = trainer_dist_adapter
        self.args.round_idx = 0
        self.client_num = size - 1
        self.q_bits = int(getattr(args, "quantize_bits", 16))
        self.cfg = SecAggConfig(
            num_clients=self.client_num,
            threshold=int(getattr(args, "secagg_threshold", max(1, self.client_num // 2))),
            prime=int(getattr(args, "mpc_prime", DEFAULT_PRIME)),
        )
        self._rng = np.random.default_rng(int(getattr(args, "random_seed", 0)) * 977 + rank)
        self.has_sent_online_msg = False
        self.sa: Optional[SecAggClient] = None
        self._pending_shares: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self._trained_flat: Optional[np.ndarray] = None
        self._sample_num = 0
        self._model_sent = False
        self._have_directory = False

    @property
    def my_id(self) -> int:
        return self.rank - 1

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(MyMessage.MSG_TYPE_CONNECTION_IS_READY, self.handle_message_connection_ready)
        self.register_message_receive_handler(MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.handle_message_init)
        self.register_message_receive_handler(MyMessage.MSG_TYPE_S2C_KEY_DIRECTORY, self.handle_message_key_directory)
        self.register_message_receive_handler(MyMessage.MSG_TYPE_S2C_SHARE_TO_CLIENT, self.handle_message_share)
        self.register_message_receive_handler(MyMessage.MSG_TYPE_S2C_UNMASK_REQUEST, self.handle_message_unmask_request)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, self.handle_message_receive_model_from_server
        )
        self.register_message_receive_handler(MyMessage.MSG_TYPE_S2C_FINISH, self.handle_message_finish)

    # --- handlers ---------------------------------------------------------
    def handle_message_connection_ready(self, msg_params: Message) -> None:
        if not self.has_sent_online_msg:
            self.has_sent_online_msg = True
            msg = Message(MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.rank, 0)
            msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_STATUS, MyMessage.MSG_CLIENT_STATUS_ONLINE)
            self.send_message(msg)

    def handle_message_init(self, msg_params: Message) -> None:
        self.trainer_dist_adapter.update_dataset(int(msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX)))
        self.trainer_dist_adapter.update_model(msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS))
        self.args.round_idx = 0
        self._run_round()

    def handle_message_receive_model_from_server(self, msg_params: Message) -> None:
        self.trainer_dist_adapter.update_dataset(int(msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX)))
        self.trainer_dist_adapter.update_model(msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS))
        # the server stamps every sync with its round index; adopt it so a
        # resumed server can't drift from the local +1 counter
        ridx = msg_params.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        self.args.round_idx = int(ridx) if ridx is not None else self.args.round_idx + 1
        self._run_round()

    def handle_message_key_directory(self, msg_params: Message) -> None:
        directory = msg_params.get(MyMessage.MSG_ARG_KEY_KEY_DIRECTORY)
        self.sa.peer_public = {int(k): int(v) for k, v in directory.items()}
        self._have_directory = True
        # distribute my Shamir shares now that everyone is present
        for peer, sh in self.sa.share_keys().items():
            if peer == self.my_id:
                self.sa.receive_share(self.my_id, sh["sk"], sh["b"])
                continue
            msg = Message(MyMessage.MSG_TYPE_C2S_SHARE, self.rank, 0)
            msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_ID, peer)
            msg.add_params(MyMessage.MSG_ARG_KEY_SK_SHARE, sh["sk"])
            msg.add_params(MyMessage.MSG_ARG_KEY_B_SHARE, sh["b"])
            self.send_message(msg)
        self._maybe_send_masked_model()

    def handle_message_share(self, msg_params: Message) -> None:
        owner = int(msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_ID))
        sk_share = np.asarray(msg_params.get(MyMessage.MSG_ARG_KEY_SK_SHARE), np.int64)
        b_share = np.asarray(msg_params.get(MyMessage.MSG_ARG_KEY_B_SHARE), np.int64)
        if self.sa is None:
            # a faster peer's share can arrive before this client has built
            # its round state
            self._pending_shares.append((owner, sk_share, b_share))
            return
        self.sa.receive_share(owner, sk_share, b_share)
        self._maybe_send_masked_model()

    def handle_message_unmask_request(self, msg_params: Message) -> None:
        survivors = [int(s) for s in msg_params.get(MyMessage.MSG_ARG_KEY_SURVIVORS)]
        dropouts = [int(s) for s in msg_params.get(MyMessage.MSG_ARG_KEY_DROPOUTS)]
        reveal = self.sa.reveal(survivors, dropouts)
        msg = Message(MyMessage.MSG_TYPE_C2S_REVEAL, self.rank, 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_REVEAL, reveal)
        self.send_message(msg)

    def handle_message_finish(self, msg_params: Message) -> None:
        log.info("====== SecAgg client %d finished ======", self.rank)
        self.finish()

    # --- round body -------------------------------------------------------
    def _run_round(self) -> None:
        with tel.span("client.train", round=int(self.args.round_idx)):
            weights, local_sample_num = self.trainer_dist_adapter.train(self.args.round_idx)
        with tel.span("sa.quantize"):
            self._trained_flat = self.quantize(weights)
        self._sample_num = int(local_sample_num)
        self._model_sent = False
        self._have_directory = False

        # fresh keys every round (masks must not repeat)
        self.sa = SecAggClient(self.my_id, self.cfg, self._rng)
        pk = self.sa.advertise_keys()
        for owner, sk_share, b_share in self._pending_shares:
            self.sa.receive_share(owner, sk_share, b_share)
        self._pending_shares = []
        msg = Message(MyMessage.MSG_TYPE_C2S_PK, self.rank, 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_PUBLIC_KEY, pk)
        self.send_message(msg)

    def quantize(self, weights) -> np.ndarray:
        """The trained state dict as one GF(p) vector in the JAX flat order:
        quantized on its device, then one copy to the host."""
        return quantize(wire_vector(weights, torch.float32), self.q_bits, self.cfg.prime).cpu().numpy()

    def _maybe_send_masked_model(self) -> None:
        if self._model_sent or self._trained_flat is None or not self._have_directory:
            return
        # need a share from every peer before going quiet (they need ours too)
        if len(self.sa.b_shares) < self.client_num:
            return
        with tel.span("sa.mask"):
            y = self.sa.masked_input(self._trained_flat)
        msg = Message(MyMessage.MSG_TYPE_C2S_MASKED_MODEL, self.rank, 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, y)
        msg.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, self._sample_num)
        self.send_message(msg)
        self._model_sent = True
