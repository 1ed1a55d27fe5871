"""TRPC backend: tensor-native RPC over raw TCP, the port's counterpart of
``fedml_tpu/core/distributed/communication/trpc/trpc_comm_manager.py``.

Each rank runs a TCP listener at ``base_port + rank``; a message is one
length-prefixed frame

    [u32 header_len][header JSON][tensor_0 bytes][tensor_1 bytes]...

where the header carries the control-plane message dict, the payload's tree
skeleton and a tensor manifest (dtype/shape/nbytes per leaf, in tree order).
The frame is the JAX package's byte for byte, so a JAX rank and a port rank
talk to each other. Leaves leave from their host buffers with
``sendall(memoryview)`` and are read back with ``recv_into`` into
preallocated buffers: no npz container, no base64, no pickle. A tensor on
the card comes to the host in ``serialization._wire_leaf`` and nowhere
else. bfloat16 travels as its uint16 bits with ``"bfloat16"`` in the
manifest and decodes to a torch bfloat16 tensor (no ``ml_dtypes``).

Peer addressing: an optional CSV ``rank,ip`` table (``ip_config.py``),
default localhost. The trace context rides in the message's reserved header
(``trace_context.inject`` on send, ``activated(extract(...))`` around each
dispatch), as on every other backend.
"""

from __future__ import annotations

import json
import logging
import queue
import select
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .....constants import TRPC_BASE_PORT
from .....core.resilience.retry import RetryPolicy, retry_call
from .....core.telemetry import trace_context
from ..base_com_manager import BaseCommunicationManager, Observer
from ..ip_config import read_ip_config
from ..message import Message
from ..serialization import BF16, flatten_tree, from_wire, unflatten_tree

log = logging.getLogger(__name__)

_STOP = object()


def _hard_close(sock: socket.socket) -> None:
    """Teardown that releases the port. shutdown() first: close() alone
    neither wakes a thread blocked in recv/accept on the fd nor (while that
    syscall holds the fd's refcount) destroys the kernel socket.
    SO_LINGER(0) avoids FIN_WAIT lingering that would block a restarted
    peer's rebind; the peer's cached socket becomes readable (dead) at once."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


# --- tensor-native framing ---------------------------------------------------

def encode_frame(msg: Message) -> Tuple[bytes, List[np.ndarray]]:
    """Header bytes + the list of host buffers to follow (unserialized)."""
    leaves: List[Tuple[np.ndarray, str]] = []
    params = msg.get_params().get(Message.MSG_ARG_KEY_MODEL_PARAMS)
    skel = None
    if params is not None:
        skel = flatten_tree(params, leaves)
    manifest = [{"dtype": dname, "shape": list(w.shape), "nbytes": int(w.nbytes)}
                for w, dname in leaves]
    header = json.dumps(
        {"msg": json.loads(msg.to_json()), "skel": skel, "tensors": manifest}
    ).encode()
    return struct.pack(">I", len(header)) + header, [w for w, _ in leaves]


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    while len(view):
        n = sock.recv_into(view)
        if n == 0:
            raise ConnectionError("peer closed mid-frame")
        view = view[n:]


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf))
    return bytes(buf)


_MAX_HEADER = 256 * 1024 * 1024
_MAX_TENSOR = 16 * 1024 * 1024 * 1024


def _leaf(flat: np.ndarray, dtype_name: str, shape) -> Any:
    """A received buffer as a CPU tensor of its recorded dtype and shape."""
    buf = flat.view(np.uint16 if dtype_name == BF16 else np.dtype(dtype_name)).reshape(shape)
    return from_wire(buf, dtype_name)


def recv_frame(sock: socket.socket) -> Message:
    (hlen,) = struct.unpack(">I", _recv_exact(sock, 4))
    if hlen > _MAX_HEADER:
        raise ValueError(f"frame header {hlen} bytes exceeds cap (corrupt/hostile peer)")
    header = json.loads(_recv_exact(sock, hlen).decode())
    leaves: List[Any] = []
    for spec in header["tensors"]:
        if not (0 <= int(spec["nbytes"]) <= _MAX_TENSOR):
            raise ValueError(f"tensor of {spec['nbytes']} bytes exceeds cap")
        flat = np.empty(spec["nbytes"], dtype=np.uint8)
        _recv_exact_into(sock, memoryview(flat))
        leaves.append(_leaf(flat, spec["dtype"], spec["shape"]))
    msg = Message()
    msg.init_from_json_object(header["msg"])
    if header["skel"] is not None:
        msg.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, unflatten_tree(header["skel"], leaves))
    return msg


# --- comm manager ------------------------------------------------------------

class TRPCCommManager(BaseCommunicationManager):
    # generous connect policy: peers come up in any order, so many attempts
    # under an elapsed budget (the gRPC backend's UNAVAILABLE retry)
    _CONNECT_RETRY = RetryPolicy(
        max_attempts=1000, base_delay_s=0.1, max_delay_s=2.0, budget_s=120.0
    )

    def __init__(
        self,
        ip_config_path: Optional[str] = None,
        client_id: int = 0,
        client_num: int = 0,
        base_port: int = TRPC_BASE_PORT,
    ):
        self.rank = client_id
        self.size = client_num + 1
        self.base_port = base_port
        self.ip_table = read_ip_config(ip_config_path, self.size)
        self._observers: List[Observer] = []
        self._incoming: "queue.Queue" = queue.Queue()
        self._out_socks: Dict[int, socket.socket] = {}
        self._out_locks: Dict[int, threading.Lock] = {}
        self._connect_lock = threading.Lock()
        self._accepted: List[socket.socket] = []
        self._running = False
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._listener.bind(("0.0.0.0", base_port + self.rank))
        except OSError:
            self._listener.close()
            raise
        self._listener.listen(self.size + 4)
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True,
                                               name=f"trpc-accept-{self.rank}")
        self._accept_thread.start()
        log.info("trpc rank=%d listening on :%d", self.rank, base_port + self.rank)

    # --- server side -----------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # accepted sockets share the listener's port; without REUSEADDR a
            # lingering FIN_WAIT accepted socket blocks a restart's rebind
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._accepted.append(conn)
            threading.Thread(target=self._reader_loop, args=(conn,), daemon=True).start()

    def _reader_loop(self, conn: socket.socket) -> None:
        try:
            while True:
                self._incoming.put(recv_frame(conn))
        except (ConnectionError, OSError):
            pass  # peer closed / manager stopped: normal end of stream
        except Exception:
            # malformed frame (stray connection, version-mismatched peer,
            # hostile nbytes): drop the connection, keep the manager alive
            log.exception("trpc rank=%d dropping connection after bad frame", self.rank)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            try:
                self._accepted.remove(conn)
            except ValueError:
                pass

    # --- client side -----------------------------------------------------
    def _connect(self, receiver: int) -> socket.socket:
        """Connect with retry (peers come up in any order). The send lock is
        created under _connect_lock before the socket is published, so
        concurrent first senders never see a socket without its lock."""
        with self._connect_lock:
            sock = self._out_socks.get(receiver)
            if sock is not None:
                # liveness probe: this side never receives on outgoing
                # sockets, so readability can only mean EOF/RST (the peer
                # restarted). A silent first write after FIN would otherwise
                # lose the frame without raising.
                readable, _, _ = select.select([sock], [], [], 0)
                if not readable:
                    return sock
                del self._out_socks[receiver]
                try:
                    sock.close()
                except OSError:
                    pass
            self._out_locks.setdefault(receiver, threading.Lock())
        addr = (self.ip_table.get(receiver, "127.0.0.1"), self.base_port + receiver)

        def _dial() -> socket.socket:
            sock = socket.create_connection(addr, timeout=10)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
            with self._connect_lock:
                if receiver in self._out_socks:  # lost a connect race
                    sock.close()
                else:
                    self._out_socks[receiver] = sock
                return self._out_socks[receiver]

        return retry_call(
            _dial,
            policy=self._CONNECT_RETRY,
            label="trpc",
            is_retryable=lambda e: isinstance(e, OSError),
        )

    def _drop(self, receiver: int, sock: socket.socket) -> None:
        with self._connect_lock:
            if self._out_socks.get(receiver) is sock:
                del self._out_socks[receiver]
        try:
            sock.close()
        except OSError:
            pass

    def send_message(self, msg: Message) -> None:
        """A dead cached socket (the peer restarted) is dropped and the send
        retried on a fresh connection; a mid-frame failure always abandons
        the socket, so the peer never sees a misaligned stream."""
        trace_context.inject(msg)
        receiver = msg.get_receiver_id()
        header, tensors = encode_frame(msg)
        for attempt in range(2):
            sock = self._connect(receiver)
            try:
                with self._out_locks[receiver]:
                    sock.sendall(header)
                    for t in tensors:
                        sock.sendall(memoryview(t).cast("B"))
                return
            except OSError:
                self._drop(receiver, sock)
                if attempt == 1:
                    raise

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
        try:
            self._listener.shutdown(socket.SHUT_RDWR)  # wakes the accept loop
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        for sock in list(self._out_socks.values()) + list(self._accepted):
            _hard_close(sock)
        self._accept_thread.join(timeout=5)
