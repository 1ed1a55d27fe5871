"""gRPC communication backend: the port's counterpart of
``fedml_tpu/core/distributed/communication/grpc/grpc_comm_manager.py``.

Reference: ``communication/grpc/grpc_comm_manager.py:30``: one gRPC server
per rank listening on ``base_port + rank``, peers addressed through an
ip-config CSV (rank -> ip, ``ip_config.py``). No protoc: the service is one
unary-unary bytes method registered with a generic handler, framed by
``codec.py`` (the JAX package's frame, byte for byte). Client channels are
cached per receiver; a send retries while the receiver is UNAVAILABLE.

``wire="fedml"`` also serves the reference's own protocol (proto
``CommRequest`` + pickled ``Message``, service ``gRPCCommManager``) and
sends in it: ``ref_wire.py``.

This is the one module of the port that imports ``grpc``.
"""

from __future__ import annotations

import logging
import queue
from concurrent import futures
from typing import Dict, List, Optional

import grpc

from .....constants import GRPC_BASE_PORT
from .....core.resilience.retry import RetryPolicy, retry_call
from .....core.telemetry import trace_context
from ..base_com_manager import BaseCommunicationManager, Observer
from ..codec import message_from_bytes, message_to_bytes
from ..ip_config import read_ip_config
from ..message import Message

log = logging.getLogger(__name__)

# the native wire's service name is the JAX package's, so the two packages'
# ranks call each other (a wire constant, not a module path)
SERVICE = ".".join(("fedml_tpu", "CommService"))
METHOD = "SendMessage"
_STOP = object()

_MAX_MSG = 512 * 1024 * 1024
_OPTIONS = [
    ("grpc.max_send_message_length", _MAX_MSG),
    ("grpc.max_receive_message_length", _MAX_MSG),
]


class GRPCCommManager(BaseCommunicationManager):
    def __init__(
        self,
        host: str = "0.0.0.0",
        port: Optional[int] = None,
        ip_config_path: Optional[str] = None,
        client_id: int = 0,
        client_num: int = 0,
        base_port: int = GRPC_BASE_PORT,
        wire: str = "native",
    ):
        if wire not in ("native", "fedml"):
            raise ValueError(f"grpc_wire {wire!r}: expected 'native' or 'fedml'")
        self.host = host
        self.rank = client_id
        self.size = client_num + 1
        self.base_port = base_port
        self.wire = wire
        self.port = port if port is not None else base_port + client_id
        self.ip_table = read_ip_config(ip_config_path, self.size)
        self._observers: List[Observer] = []
        self._incoming: "queue.Queue" = queue.Queue()
        self._channels: Dict[int, grpc.Channel] = {}
        self._running = False
        self._server = self._start_server()

    # --- server ----------------------------------------------------------
    def _start_server(self) -> grpc.Server:
        incoming = self._incoming

        def handle(request: bytes, context) -> bytes:
            incoming.put(message_from_bytes(request))
            return b"ok"

        handler = grpc.method_handlers_generic_handler(
            SERVICE,
            {METHOD: grpc.unary_unary_rpc_method_handler(handle, request_deserializer=None,
                                                        response_serializer=None)},
        )
        # no SO_REUSEPORT: a second server on a taken port must fail to bind,
        # not share the port and take some of its peer's messages
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=8),
                             options=_OPTIONS + [("grpc.so_reuseport", 0)])
        server.add_generic_rpc_handlers((handler,))
        if self.wire == "fedml":
            from . import ref_wire

            def handle_ref(request: bytes, context) -> bytes:
                incoming.put(ref_wire.decode_ref_message(request))
                return b""  # empty CommResponse

            ref_handler = grpc.method_handlers_generic_handler(
                ref_wire.REF_SERVICE,
                {
                    ref_wire.REF_METHOD_SEND: grpc.unary_unary_rpc_method_handler(
                        handle_ref, request_deserializer=None, response_serializer=None
                    ),
                    "handleReceiveMessage": grpc.unary_unary_rpc_method_handler(
                        lambda req, ctx: b"", request_deserializer=None, response_serializer=None
                    ),
                },
            )
            server.add_generic_rpc_handlers((ref_handler,))
        # add_insecure_port returns 0 (older grpc) or raises (newer) when the
        # port is taken: either way the backend refuses to start, naming it
        try:
            bound = server.add_insecure_port(f"{self.host}:{self.port}")
        except RuntimeError as e:
            raise OSError(f"grpc rank={self.rank}: cannot bind {self.host}:{self.port}: {e}") from e
        if not bound:
            raise OSError(f"grpc rank={self.rank}: cannot bind {self.host}:{self.port}")
        server.start()
        log.info("grpc server rank=%d listening on %s:%d", self.rank, self.host, self.port)
        return server

    # --- client ----------------------------------------------------------
    def _stub(self, receiver: int):
        if receiver not in self._channels:
            addr = f"{self.ip_table.get(receiver, '127.0.0.1')}:{self.base_port + receiver}"
            self._channels[receiver] = grpc.insecure_channel(addr, options=_OPTIONS)
        ch = self._channels[receiver]
        if self.wire == "fedml":
            from . import ref_wire

            method = f"/{ref_wire.REF_SERVICE}/{ref_wire.REF_METHOD_SEND}"
        else:
            method = f"/{SERVICE}/{METHOD}"
        return ch.unary_unary(method, request_serializer=None, response_deserializer=None)

    # peers come up in any order (the MQTT broker absorbs this for MQTT_S3;
    # point-to-point gRPC retries until the receiver's socket exists): many
    # attempts under a 120 s elapsed budget
    _SEND_RETRY = RetryPolicy(
        max_attempts=1000, base_delay_s=0.2, max_delay_s=5.0, budget_s=120.0
    )

    def send_message(self, msg: Message) -> None:
        """Send, retrying while the receiver is UNAVAILABLE."""
        trace_context.inject(msg)
        if self.wire == "fedml":
            from . import ref_wire

            data = ref_wire.encode_ref_message(msg, self.rank)
        else:
            data = message_to_bytes(msg)
        receiver = msg.get_receiver_id()

        def _unavailable(exc: BaseException) -> bool:
            return isinstance(exc, grpc.RpcError) and \
                getattr(exc, "code", lambda: None)() == grpc.StatusCode.UNAVAILABLE

        retry_call(
            lambda: self._stub(receiver)(data, timeout=600),
            policy=self._SEND_RETRY,
            label="grpc",
            is_retryable=_unavailable,
        )

    # --- loop ------------------------------------------------------------
    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        if observer in self._observers:
            self._observers.remove(observer)

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            try:
                item = self._incoming.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is _STOP:
                break
            with trace_context.activated(trace_context.extract(item)):
                for obs in list(self._observers):
                    obs.receive_message(item.get_type(), item)

    def stop_receive_message(self) -> None:
        self._running = False
        self._incoming.put(_STOP)
        self._server.stop(grace=0.5)
        for ch in self._channels.values():
            ch.close()
