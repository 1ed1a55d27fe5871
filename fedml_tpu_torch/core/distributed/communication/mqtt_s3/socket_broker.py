"""Cross-process MQTT-semantics broker over plain TCP: a copy of
``fedml_tpu/core/distributed/communication/mqtt_s3/socket_broker.py``, the
same line protocol, so JAX and port transports share one broker.

Reference: ``communication/mqtt/mqtt_manager.py`` assumes an external MQTT
broker daemon and paho. For multi-process deployments (WAN parties as real
processes) without them, this module is the transport tier beside
``LocalMqttBroker`` (in-process): a ~zero-dependency TCP pub/sub broker with the same semantics the local broker implements — topic strings,
per-subscriber callbacks, pre-subscribe backlog retention, and last-will
publication when a client connection drops.

Framing: one JSON object per line; payloads base64. Control ops:
``sub``/``unsub``/``pub``/``will``. This is deliberately NOT the MQTT wire
protocol — it is the minimal broker our transports need.
"""

from __future__ import annotations

import base64
import json
import logging
import socket
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Set, Tuple

log = logging.getLogger(__name__)

_BACKLOG_CAP = 256


class SocketMqttBroker:
    """Run in any one process; clients connect from this or other processes."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._lock = threading.Lock()
        self._subs: Dict[str, Set[socket.socket]] = defaultdict(set)
        self._wills: Dict[socket.socket, Tuple[str, bytes]] = {}
        self._backlog: Dict[str, List[bytes]] = defaultdict(list)
        self._conns: Set[socket.socket] = set()
        # every connection ever accepted: one a party that opened the WAN
        self.accepted = 0
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()
        log.info("socket broker on %s:%d", self.host, self.port)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # --- server loops ----------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                self._conns.add(conn)
                self.accepted += 1
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        f = conn.makefile("rb")
        try:
            for line in f:
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                op, topic = msg.get("op"), msg.get("topic", "")
                if op == "pub":
                    self._publish(topic, base64.b64decode(msg.get("payload", "")))
                elif op == "sub":
                    self._subscribe(topic, conn)
                elif op == "unsub":
                    with self._lock:
                        self._subs[topic].discard(conn)
                elif op == "will":
                    with self._lock:
                        self._wills[conn] = (topic, base64.b64decode(msg.get("payload", "")))
                elif op == "unwill":
                    with self._lock:
                        self._wills.pop(conn, None)
        except (OSError, ValueError):
            pass
        finally:
            self._drop(conn)

    def _drop(self, conn: socket.socket) -> None:
        with self._lock:
            if conn not in self._conns:
                return
            self._conns.discard(conn)
            for subs in self._subs.values():
                subs.discard(conn)
            will = self._wills.pop(conn, None)
        try:
            conn.close()
        except OSError:
            pass
        if will is not None:
            # ungraceful disconnect -> last will fires (liveness signal)
            self._publish(*will)

    def _send(self, conn: socket.socket, doc: dict) -> None:
        try:
            conn.sendall((json.dumps(doc) + "\n").encode())
        except OSError:
            self._drop(conn)

    def _publish(self, topic: str, payload: bytes) -> None:
        doc = {"op": "msg", "topic": topic, "payload": base64.b64encode(payload).decode()}
        with self._lock:
            subs = list(self._subs.get(topic, ()))
            if not subs:
                bl = self._backlog[topic]
                bl.append(payload)
                if len(bl) > _BACKLOG_CAP:
                    del bl[0]
                return
        for c in subs:
            self._send(c, doc)

    def _subscribe(self, topic: str, conn: socket.socket) -> None:
        with self._lock:
            self._subs[topic].add(conn)
            pending = self._backlog.pop(topic, [])
        for payload in pending:
            self._send(conn, {"op": "msg", "topic": topic,
                              "payload": base64.b64encode(payload).decode()})

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            self._wills.clear()  # broker shutdown is not client death
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class SocketMqttTransport:
    """Client for SocketMqttBroker with the transport surface the comm
    managers / agents use (publish/subscribe/last-will/disconnect)."""

    def __init__(self, address: str, client_id: str = ""):
        host, _, port = address.rpartition(":")
        self.client_id = client_id
        self._sock = socket.create_connection((host or "127.0.0.1", int(port)), timeout=10)
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._callbacks: Dict[str, List[Callable[[str, bytes], None]]] = defaultdict(list)
        self._will: Optional[Tuple[str, bytes]] = None
        self._closed = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _send(self, doc: dict) -> None:
        with self._wlock:
            self._sock.sendall((json.dumps(doc) + "\n").encode())

    def _read_loop(self) -> None:
        f = self._sock.makefile("rb")
        try:
            for line in f:
                msg = json.loads(line)
                if msg.get("op") != "msg":
                    continue
                topic = msg["topic"]
                payload = base64.b64decode(msg.get("payload", ""))
                for cb in list(self._callbacks.get(topic, ())):
                    try:
                        cb(topic, payload)
                    except Exception:  # noqa: BLE001 - subscriber fault barrier
                        log.exception("subscriber callback failed for %s", topic)
        except (OSError, ValueError, json.JSONDecodeError):
            pass

    def set_last_will(self, topic: str, payload: bytes) -> None:
        self._will = (topic, payload)
        self._send({"op": "will", "topic": topic, "payload": base64.b64encode(payload).decode()})

    def publish(self, topic: str, payload: bytes) -> None:
        self._send({"op": "pub", "topic": topic, "payload": base64.b64encode(payload).decode()})

    def subscribe(self, topic: str, callback: Callable[[str, bytes], None]) -> None:
        first = not self._callbacks[topic]
        self._callbacks[topic].append(callback)
        if first:
            self._send({"op": "sub", "topic": topic})

    def disconnect(self, graceful: bool = True) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            if graceful and self._will is not None:
                self._send({"op": "unwill"})
            # shutdown, not just close: the reader thread's makefile() holds
            # an fd reference, so close() alone would never send FIN and the
            # broker would keep the connection (and any last will) pending
            self._sock.shutdown(socket.SHUT_RDWR)
            self._sock.close()
        except OSError:
            pass
