"""LightSecAgg client-side manager: the counterpart of
``fedml_tpu/cross_silo/lightsecagg/lsa_fedml_client_manager.py``.

Reference: ``cross_silo/lightsecagg/lsa_fedml_client_manager.py`` — the
client state machine: on INIT/SYNC train locally, LCC-encode a fresh mask and
route one share per peer through the server, upload the masked quantized
model once every peer share has arrived, and answer the server's
active-client query with the aggregate encoded mask.

The trained state dict is quantized on its device in the JAX flat order
(``wire_vector``, each leaf cast to float32 first, as JAX does) and comes
to the host in one copy. The mask and noise draws are host numpy from JAX's
generator (``random_seed * 1000 + rank``); their Lagrange encoding runs on
the trainer's device, and the shares come back to the host in one copy, so
this client masks and encodes as a JAX client of the same seed does. The
masking and the sum of the received shares are host numpy
(``client.train``, ``lsa.quantize``, ``lsa.encode``, ``lsa.mask`` spans).
The JAX manager also runs under the flight recorder and logs mlops
events; this one does neither (the server managers run under the
recorder; mlops is ROADMAP.md, Queue 4).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core import telemetry as tel
from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.mpc.finite_field import DEFAULT_PRIME, quantize
from ...core.mpc.lightsecagg import (
    ClientMaskState,
    LightSecAggConfig,
    aggregate_encoded_mask,
    encode_mask,
    mask_vector,
)
from ...models.convert import wire_vector
from .lsa_message_define import MyMessage

log = logging.getLogger(__name__)


class LightSecAggClientManager(FedMLCommManager):
    def __init__(self, args: Any, trainer_dist_adapter, comm=None, rank=0, size=0, backend="INMEMORY"):
        super().__init__(args, comm, rank, size, backend)
        self.trainer_dist_adapter = trainer_dist_adapter
        self.args.round_idx = 0
        self.client_num = size - 1
        self.q_bits = int(getattr(args, "quantize_bits", 16))
        self.prime = int(getattr(args, "mpc_prime", DEFAULT_PRIME))
        self.cfg = LightSecAggConfig(
            num_clients=self.client_num,
            target_active=int(getattr(args, "lsa_target_active", self.client_num)),
            privacy_guarantee=int(getattr(args, "lsa_privacy_guarantee", max(1, self.client_num // 2))),
            prime=self.prime,
        )
        self._rng = np.random.default_rng(int(getattr(args, "random_seed", 0)) * 1000 + rank)
        self.has_sent_online_msg = False
        self.mask_state: Optional[ClientMaskState] = None
        self._pending_shares: Dict[int, np.ndarray] = {}
        self._trained_flat: Optional[np.ndarray] = None
        self._sample_num = 0
        self._model_sent = False

    @property
    def my_id(self) -> int:
        return self.rank - 1  # 0-based mpc id

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(MyMessage.MSG_TYPE_CONNECTION_IS_READY, self.handle_message_connection_ready)
        self.register_message_receive_handler(MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.handle_message_init)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_ENCODED_MASK_TO_CLIENT, self.handle_message_encoded_mask
        )
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SEND_TO_ACTIVE_CLIENT, self.handle_message_active_request
        )
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
        global_model_params = msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        data_silo_index = msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX)
        self.trainer_dist_adapter.update_dataset(int(data_silo_index))
        self.trainer_dist_adapter.update_model(global_model_params)
        self.args.round_idx = 0
        self._run_round()

    def handle_message_receive_model_from_server(self, msg_params: Message) -> None:
        model_params = msg_params.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        client_index = msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX)
        self.trainer_dist_adapter.update_dataset(int(client_index))
        self.trainer_dist_adapter.update_model(model_params)
        # the server stamps every sync with its round index; adopt it so a
        # resumed server can't drift from the local +1 counter
        ridx = msg_params.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        self.args.round_idx = int(ridx) if ridx is not None else self.args.round_idx + 1
        self._run_round()

    def handle_message_encoded_mask(self, msg_params: Message) -> None:
        src = int(msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_ID))
        share = np.asarray(msg_params.get(MyMessage.MSG_ARG_KEY_ENCODED_MASK), np.int64)
        if self.mask_state is None:
            # a faster peer's share can arrive before this client finished
            # its own round setup (the parties are threads)
            self._pending_shares[src] = share
            return
        self.mask_state.received[src] = share
        self._maybe_send_masked_model()

    def handle_message_active_request(self, msg_params: Message) -> None:
        active = [int(a) for a in msg_params.get(MyMessage.MSG_ARG_KEY_ACTIVE_CLIENTS)]
        agg = aggregate_encoded_mask(self.cfg, self.mask_state, active)
        msg = Message(MyMessage.MSG_TYPE_C2S_SEND_MASK_TO_SERVER, self.rank, 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_AGGREGATE_ENCODED_MASK, agg)
        self.send_message(msg)

    def handle_message_finish(self, msg_params: Message) -> None:
        log.info("====== LSA client %d finished ======", self.rank)
        self.finish()

    # --- round body -------------------------------------------------------
    def _run_round(self) -> None:
        with tel.span("client.train", round=int(self.args.round_idx)):
            weights, local_sample_num = self.trainer_dist_adapter.train(self.args.round_idx)
        with tel.span("lsa.quantize"):
            flat = self.quantize(weights)
        self._sample_num = int(local_sample_num)

        # offline phase: fresh mask per round, one encoded share per peer
        with tel.span("lsa.encode"):
            state = encode_mask(self.cfg, flat.size, self._rng, device=self.trainer_dist_adapter.device)
        state.received[self.my_id] = state.encoded_shares[self.my_id]
        state.received.update(self._pending_shares)
        self._pending_shares = {}
        self.mask_state = state
        self._trained_flat = flat
        self._model_sent = False
        for peer in range(self.client_num):
            if peer == self.my_id:
                continue
            msg = Message(MyMessage.MSG_TYPE_C2S_SEND_ENCODED_MASK_TO_SERVER, self.rank, 0)
            msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_ID, peer)  # routing target (0-based)
            msg.add_params(MyMessage.MSG_ARG_KEY_ENCODED_MASK, state.encoded_shares[peer])
            self.send_message(msg)
        self._maybe_send_masked_model()

    def quantize(self, weights) -> np.ndarray:
        """The trained state dict as one GF(p) vector in the JAX flat order:
        quantized on its device, then one copy to the host."""
        return quantize(wire_vector(weights, torch.float32), self.q_bits, self.prime).cpu().numpy()

    def _maybe_send_masked_model(self) -> None:
        if self._model_sent or self._trained_flat is None:
            return
        if len(self.mask_state.received) < self.client_num:
            return
        with tel.span("lsa.mask"):
            y = mask_vector(self.cfg, self._trained_flat, self.mask_state)
        msg = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, y)
        msg.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, self._sample_num)
        self.send_message(msg)
        self._model_sent = True
