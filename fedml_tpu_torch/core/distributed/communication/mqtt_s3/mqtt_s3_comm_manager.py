"""MQTT + object-store communication backend: a copy of
``fedml_tpu/core/distributed/communication/mqtt_s3/mqtt_s3_comm_manager.py``
(its native wire; the reference pickle wire, ``mqtt_s3_wire='fedml'``, is
not ported and raises: ROADMAP.md, Queue 1).

Reference: ``mqtt_s3/mqtt_s3_multi_clients_comm_manager.py:21`` — control
plane JSON on topics ``fedml_<run_id>_<server_id>_<client_id>`` (server->
client) and ``fedml_<run_id>_<client_id>`` (client->server); model payload
offloaded to the object store with the URL embedded in the JSON
(``send_message:248``). Liveness via last-will OFFLINE messages
(reference :97-109). Identical topic scheme here.
"""

from __future__ import annotations

import json
import queue
from typing import List

from .....core.telemetry import trace_context
from ..base_com_manager import BaseCommunicationManager, Observer
from ..message import Message
from .mqtt_transport import create_mqtt_transport
from .object_store import create_object_store

_STOP = object()


class MqttS3MultiClientsCommManager(BaseCommunicationManager):
    def __init__(
        self,
        args=None,
        client_rank: int = 0,
        client_num: int = 0,
        server_id: int = 0,
    ):
        self.args = args
        self.run_id = str(getattr(args, "run_id", "0")) if args is not None else "0"
        self.topic_prefix = f"fedml_{self.run_id}"
        self.rank = client_rank
        self.client_num = client_num
        self.server_id = server_id
        self.is_server = client_rank == server_id
        wire = str(getattr(args, "mqtt_s3_wire", "native") if args is not None else "native")
        if wire == "fedml":
            raise NotImplementedError(
                "mqtt_s3_wire='fedml': the reference pickle wire (ref_bucket.py, "
                "grpc/ref_wire.py) is not ported to fedml_tpu_torch yet (see ROADMAP.md, "
                "Queue 1)")
        self.mqtt = create_mqtt_transport(args, client_id=f"{self.topic_prefix}_{self.rank}")
        # store must exist before _subscribe: the local broker flushes
        # backlogged messages synchronously on subscribe, and on_message
        # resolves payload urls through self.store
        self.store = create_object_store(args)
        self._observers: List[Observer] = []
        self._incoming: "queue.Queue" = queue.Queue()
        self._running = False
        self._subscribe()

    # --- topics (reference scheme) ---------------------------------------
    def _topic_server_to_client(self, client_id: int) -> str:
        return f"{self.topic_prefix}_{self.server_id}_{client_id}"

    def _topic_client_to_server(self, client_id: int) -> str:
        return f"{self.topic_prefix}_{client_id}"

    def _last_will_topic(self) -> str:
        return f"flclient_agent/last_will_msg"

    def _subscribe(self) -> None:
        def on_message(topic: str, payload: bytes) -> None:
            obj = json.loads(payload.decode())
            msg = Message()
            msg.init_from_json_object(obj)
            url = msg.get(Message.MSG_ARG_KEY_MODEL_PARAMS_URL)
            if url:
                msg.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, self.store.read_model(url))
            self._incoming.put(msg)

        if self.is_server:
            for cid in range(1, self.client_num + 1):
                self.mqtt.subscribe(self._topic_client_to_server(cid), on_message)
        else:
            self.mqtt.subscribe(self._topic_server_to_client(self.rank), on_message)
        self.mqtt.set_last_will(
            self._last_will_topic(), json.dumps({"ID": self.rank, "status": "OFFLINE"}).encode()
        )

    # --- send ------------------------------------------------------------
    def send_message(self, msg: Message) -> None:
        trace_context.inject(msg)
        receiver = msg.get_receiver_id()
        params = msg.get_params().get(Message.MSG_ARG_KEY_MODEL_PARAMS)
        topic = (
            self._topic_server_to_client(receiver) if self.is_server else self._topic_client_to_server(self.rank)
        )
        if params is not None:
            key = f"{self.topic_prefix}_{msg.get_sender_id()}_{receiver}_{msg.get_type()}"
            url = self.store.write_model(key, params)
            msg.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS_URL, url)
        self.mqtt.publish(topic, msg.to_json().encode())

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
        self.mqtt.disconnect(graceful=True)
