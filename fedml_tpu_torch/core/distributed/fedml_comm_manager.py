"""FedMLCommManager: observer + handler registry + backend factory, the
port's counterpart of ``fedml_tpu/core/distributed/fedml_comm_manager.py``.

Reference: ``core/distributed/fedml_comm_manager.py:11`` (run:25, handler
registry :34-51, ``_init_manager``:131-209 incl. the "self-defined backend"
seam at :204-207). Backends, each the JAX package's:

- INMEMORY: in-process, payloads by reference;
- MQTT_S3: control JSON over an MQTT-semantics broker, payloads in an
  object store (npz) or, under ``mqtt_s3_wire='fedml'``, in the reference's
  pickled bucket;
- MQTT_WEB3 and MQTT_THETASTORE: MQTT_S3's control plane, payloads in a
  content-addressed store (``communication/web3/``);
- TRPC: tensor-native frames over raw TCP, a listener at
  ``trpc_base_port + run-id offset + rank`` (``communication/trpc/``);
- GRPC, and MPI, which maps onto it: one gRPC server per rank at
  ``grpc_base_port + run-id offset + rank``, the codec's frame or, under
  ``grpc_wire='fedml'``, the reference's pickled ``CommRequest``
  (``communication/grpc/``; the only module that needs ``grpc``).

A backend that cannot start raises, naming itself; no backend stands in for
another. ``chaos_link_throttle`` (bytes/s) with ``chaos_link_base_delay_s``
degrades this party's link in the INMEMORY broker (``set_throttle``), as in
the JAX manager; it does nothing on the byte backends. Every message sent
or received is booked to the flight recorder (a None check when no
recorder is installed) and to netlink's per-pair accounting, whose send
hook stamps the send time (``ts``) into the reserved telemetry header, the
receiver's latency sample, as the JAX manager does on every backend.

**The weight layout on the wire.** A model payload that leaves the process
(every backend but INMEMORY: each makes bytes) travels in the JAX package's
layout, flax path names with kernels ``[in, out]`` and HWIO
(``models/convert.py``), each dict's keys in flax's sorted order, so a JAX
party and a port party share one federation and write byte-equal payloads
(equal content ids on MQTT_WEB3); the port's state dict comes back on
receipt, as CPU tensors. The conversion happens here, once per message, and
only for byte-making backends: the codecs stay layout-blind, and INMEMORY
hands the state dict over by reference, on the device it is on.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Mapping, Optional

from ...constants import (
    COMM_BACKEND_GRPC,
    COMM_BACKEND_INMEMORY,
    COMM_BACKEND_MPI,
    COMM_BACKEND_MQTT_S3,
    COMM_BACKEND_MQTT_THETASTORE,
    COMM_BACKEND_MQTT_WEB3,
    COMM_BACKEND_TRPC,
)
from ..resilience.retry import RetryPolicy, retry_call
from ..telemetry import flight_recorder, netlink
from .communication.base_com_manager import BaseCommunicationManager, Observer
from .communication.message import Message

log = logging.getLogger(__name__)

# backends whose payloads leave the process as bytes, in the wire layout
_BYTE_BACKENDS = (COMM_BACKEND_MQTT_S3, COMM_BACKEND_TRPC, COMM_BACKEND_GRPC, COMM_BACKEND_MPI,
                  COMM_BACKEND_MQTT_WEB3, COMM_BACKEND_MQTT_THETASTORE)


def _run_id_offset(run_id: Any) -> int:
    """Stable small port offset from a run id, the JAX package's rule (run
    ids may be strings: the reference's are MLOps-assigned, and
    ``fedml_comm_manager.py:193`` derives ports from them the same way)."""
    try:
        return int(run_id or 0) % 1000
    except (TypeError, ValueError):
        import zlib

        return zlib.crc32(str(run_id).encode()) % 1000


def to_wire_layout(params: Any) -> Any:
    """A state dict (``{dotted name: tensor}``) as the JAX package's nested
    flax-layout tree; any other payload unchanged."""
    import torch

    if isinstance(params, Mapping) and params and all(
            isinstance(v, torch.Tensor) for v in params.values()):
        from ...models.convert import params_to_jax, wire_order

        # flax's key order (sorted at every level), the order any JAX tree
        # operation leaves a params dict in
        return params_to_jax({k: params[k] for k in wire_order(params)})
    return params


def from_wire_layout(params: Any) -> Any:
    """A nested flax-layout tree as the port's state dict of CPU tensors;
    any other payload unchanged."""
    if isinstance(params, Mapping) and params and any(
            isinstance(v, Mapping) for v in params.values()):
        from ...models.convert import params_from_jax

        return params_from_jax(params)
    return params


class FedMLCommManager(Observer):
    def __init__(self, args: Any, comm=None, rank: int = 0, size: int = 0, backend: str = COMM_BACKEND_INMEMORY):
        self.args = args
        self.size = size
        self.rank = int(rank)
        self.backend = backend
        self.comm = comm
        self.com_manager: Optional[BaseCommunicationManager] = None
        self.message_handler_dict: Dict[Any, Callable[[Message], None]] = {}
        self._wire_layout = backend in _BYTE_BACKENDS
        # send-path retry policy; None (retries disabled) keeps send_message
        # a plain call
        self._retry_policy = RetryPolicy.from_args(args)
        self._init_manager()

    def run(self) -> None:
        self.register_message_receive_handlers()
        # connection-ready is synthesized locally once the backend is up
        # (reference: each backend emits CONNECTION_IS_READY when connected,
        # handler registry fedml_comm_manager.py:34-51)
        ready = Message(0, self.rank, self.rank)  # 0 == MSG_TYPE_CONNECTION_IS_READY
        if 0 in self.message_handler_dict:
            self.receive_message(0, ready)
        log.info("rank %d starting receive loop (%s)", self.rank, self.backend)
        self.com_manager.handle_receive_message()
        log.info("rank %d receive loop done", self.rank)

    def get_sender_id(self) -> int:
        return self.rank

    def receive_message(self, msg_type, msg_params: Message) -> None:
        # every backend dispatches through here, so the flight recorder's
        # comm breadcrumbs and netlink's per-pair accounting cover them all
        flight_recorder.record_comm("recv", msg_params)
        netlink.record_recv(msg_params, backend=self.backend.lower())
        if self._wire_layout:
            params = msg_params.get(Message.MSG_ARG_KEY_MODEL_PARAMS)
            if params is not None:
                msg_params.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, from_wire_layout(params))
        handler = self.message_handler_dict.get(msg_type)
        if handler is None:
            raise KeyError(
                f"rank {self.rank}: no handler for message type {msg_type!r} "
                f"(registered: {list(self.message_handler_dict)})"
            )
        handler(msg_params)

    def send_message(self, message: Message) -> None:
        flight_recorder.record_comm("send", message)
        # books the pair's outgoing bytes and stamps the send time into the
        # reserved header (the receiver's latency sample)
        netlink.record_send(message, backend=self.backend.lower())
        if self._wire_layout:
            params = message.get(Message.MSG_ARG_KEY_MODEL_PARAMS)
            if params is not None:
                message.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, to_wire_layout(params))
        if self._retry_policy is None:
            self.com_manager.send_message(message)
            return
        retry_call(
            lambda: self.com_manager.send_message(message),
            policy=self._retry_policy,
            label=self.backend.lower(),
        )

    def register_message_receive_handler(self, msg_type, handler_callback_func: Callable[[Message], None]) -> None:
        self.message_handler_dict[msg_type] = handler_callback_func

    def register_message_receive_handlers(self) -> None:  # overridden by managers
        ...

    def finish(self) -> None:
        log.info("rank %d finishing comm", self.rank)
        self.com_manager.stop_receive_message()

    # --- backend factory (reference _init_manager:131) -------------------
    def _init_manager(self) -> None:
        run_id = getattr(self.args, "run_id", 0)
        if self.backend == COMM_BACKEND_INMEMORY:
            from .communication.inmemory.inmemory_comm_manager import InMemoryCommManager

            self.com_manager = InMemoryCommManager(str(getattr(self.args, "run_id", "0")), self.rank, self.size)
            # chaos_link_throttle: degrade THIS party's link in the broker
            # (fault injection for the netlink estimators)
            throttle = getattr(self.args, "chaos_link_throttle", None)
            if throttle:
                self.com_manager.broker.set_throttle(
                    self.rank, float(throttle),
                    base_delay_s=float(getattr(self.args, "chaos_link_base_delay_s", 0.0) or 0.0))
        elif self.backend == COMM_BACKEND_TRPC:
            from ...constants import TRPC_BASE_PORT
            from .communication.trpc.trpc_comm_manager import TRPCCommManager

            self.com_manager = TRPCCommManager(
                ip_config_path=getattr(self.args, "trpc_ipconfig_path", None),
                client_id=self.rank,
                client_num=self.size - 1,
                base_port=int(getattr(self.args, "trpc_base_port", TRPC_BASE_PORT)) + _run_id_offset(run_id),
            )
        elif self.backend in (COMM_BACKEND_GRPC, COMM_BACKEND_MPI):
            from ...constants import GRPC_BASE_PORT

            try:
                from .communication.grpc.grpc_comm_manager import GRPCCommManager
            except ImportError as e:
                raise ImportError(f"comm backend {self.backend!r} needs the grpc package: {e}") from e
            self.com_manager = GRPCCommManager(
                ip_config_path=getattr(self.args, "grpc_ipconfig_path", None),
                client_id=self.rank,
                client_num=self.size - 1,
                base_port=int(getattr(self.args, "grpc_base_port", GRPC_BASE_PORT)) + _run_id_offset(run_id),
                wire=str(getattr(self.args, "grpc_wire", "native")),
            )
        elif self.backend == COMM_BACKEND_MQTT_S3:
            from .communication.mqtt_s3.mqtt_s3_comm_manager import MqttS3MultiClientsCommManager

            self.com_manager = MqttS3MultiClientsCommManager(
                self.args, client_rank=self.rank, client_num=self.size - 1, server_id=0
            )
        elif self.backend == COMM_BACKEND_MQTT_WEB3:
            from .communication.web3.mqtt_web3_comm_manager import MqttWeb3CommManager

            self.com_manager = MqttWeb3CommManager(
                self.args, client_rank=self.rank, client_num=self.size - 1, server_id=0
            )
        elif self.backend == COMM_BACKEND_MQTT_THETASTORE:
            from .communication.web3.mqtt_web3_comm_manager import MqttThetastoreCommManager

            self.com_manager = MqttThetastoreCommManager(
                self.args, client_rank=self.rank, client_num=self.size - 1, server_id=0
            )
        else:
            raise ValueError(f"unknown comm backend {self.backend!r}")
        self.com_manager.add_observer(self)
