"""MQTT transport abstraction: a copy of
``fedml_tpu/core/distributed/communication/mqtt_s3/mqtt_transport.py``.

Reference: ``communication/mqtt/mqtt_manager.py:14`` (paho wrapper with
last-will liveness). Two impls behind one interface:

  - ``LocalMqttBroker`` — in-process topic pub/sub with the same semantics
    (topic strings, per-subscriber callbacks, retained last-will on
    disconnect). Default; lets the full MQTT_S3 protocol run on one host
    with zero dependencies.
  - ``SocketMqttTransport`` (socket_broker.py) — the cross-process broker.

A real broker (``mqtt_host``, through paho-mqtt) is not ported. The JAX
package falls back to the local broker with a warning where paho is
missing; the port raises instead (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple


class LocalMqttBroker:
    _instances: Dict[str, "LocalMqttBroker"] = {}
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._subs: Dict[str, List[Callable[[str, bytes], None]]] = defaultdict(list)
        # messages published before anyone subscribed: real MQTT drops these,
        # which races party startup (a client's ONLINE can beat the server's
        # subscribe and deadlock the round). The in-process broker retains
        # them and flushes on first subscribe.
        self._backlog: Dict[str, List[bytes]] = defaultdict(list)
        self._slock = threading.Lock()

    @classmethod
    def get(cls, broker_id: str = "default") -> "LocalMqttBroker":
        with cls._lock:
            if broker_id not in cls._instances:
                cls._instances[broker_id] = cls()
            return cls._instances[broker_id]

    @classmethod
    def reset(cls, broker_id: Optional[str] = None) -> None:
        """Drop one broker (end of a run_id's lifecycle — prevents stale
        message replay when a run_id is reused) or all of them."""
        with cls._lock:
            if broker_id is None:
                cls._instances.clear()
            else:
                cls._instances.pop(broker_id, None)

    _BACKLOG_CAP = 256  # per topic; topics that never gain a subscriber
    # (e.g. the last-will topic) must not grow unboundedly

    def publish(self, topic: str, payload: bytes) -> None:
        with self._slock:
            subs = list(self._subs.get(topic, []))
            if not subs:
                bl = self._backlog[topic]
                bl.append(payload)
                if len(bl) > self._BACKLOG_CAP:
                    del bl[0]
                return
        for cb in subs:
            cb(topic, payload)

    def subscribe(self, topic: str, callback: Callable[[str, bytes], None]) -> None:
        # flush the backlog while holding the lock: releasing first would let
        # a concurrent publish overtake older backlogged messages
        with self._slock:
            self._subs[topic].append(callback)
            pending = self._backlog.pop(topic, [])
            for payload in pending:
                callback(topic, payload)

    def unsubscribe(self, topic: str, callback: Callable[[str, bytes], None]) -> None:
        with self._slock:
            if callback in self._subs.get(topic, []):
                self._subs[topic].remove(callback)


class LocalMqttTransport:
    """LocalMqttBroker client with the paho-ish surface the comm manager
    uses (connect/publish/subscribe/last-will)."""

    def __init__(self, broker_id: str = "default", client_id: str = ""):
        self.broker = LocalMqttBroker.get(broker_id)
        self.client_id = client_id
        self._will: Optional[Tuple[str, bytes]] = None
        self._subscriptions: List[Tuple[str, Callable]] = []

    def set_last_will(self, topic: str, payload: bytes) -> None:
        self._will = (topic, payload)

    def publish(self, topic: str, payload: bytes) -> None:
        self.broker.publish(topic, payload)

    def subscribe(self, topic: str, callback: Callable[[str, bytes], None]) -> None:
        self.broker.subscribe(topic, callback)
        self._subscriptions.append((topic, callback))

    def disconnect(self, graceful: bool = True) -> None:
        if not graceful and self._will is not None:
            self.broker.publish(*self._will)
        for topic, cb in self._subscriptions:
            self.broker.unsubscribe(topic, cb)
        self._subscriptions.clear()


def create_mqtt_transport(args, client_id: str):
    """Transport selection: cross-process socket broker (mqtt_socket arg or
    FEDML_MQTT_SOCKET env — parties as real processes) > in-process local
    broker. ``mqtt_host`` (a real broker) raises."""
    import os

    host = getattr(args, "mqtt_host", None) if args is not None else None
    if host:
        raise NotImplementedError(
            f"mqtt_host {host!r}: a real MQTT broker (paho-mqtt) is not ported to "
            "fedml_tpu_torch yet; use the socket broker (mqtt_socket) or the local "
            "broker (see ROADMAP.md, Queue 1)")
    sock_addr = (getattr(args, "mqtt_socket", None) if args is not None else None) \
        or os.environ.get("FEDML_MQTT_SOCKET")
    if sock_addr:
        from .socket_broker import SocketMqttTransport

        return SocketMqttTransport(sock_addr, client_id=client_id)
    run_id = str(getattr(args, "run_id", "default")) if args is not None else "default"
    return LocalMqttTransport(broker_id=run_id, client_id=client_id)
