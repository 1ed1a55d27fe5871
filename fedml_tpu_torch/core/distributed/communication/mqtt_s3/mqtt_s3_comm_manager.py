"""MQTT + object-store communication backend: a copy of
``fedml_tpu/core/distributed/communication/mqtt_s3/mqtt_s3_comm_manager.py``,
its native wire (npz payloads in the object store, addressed by URL) and the
reference pickle wire (``mqtt_s3_wire='fedml'``: pickled payloads in a
shared bucket addressed by key, ``ref_bucket.py``). The payload store is a
hook, ``_create_store``, which the web3 managers override with a
content-addressed store (``web3/``).

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
import uuid
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
        # reference-wire mode (interop with the reference's own
        # MqttS3MultiClientsCommManager): the payload is a pickled torch tree
        # in a shared bucket addressed by key, and the control JSON carries
        # the key in model_params, the reference's contract
        # (mqtt_s3_multi_clients_comm_manager.py:248,283)
        self.ref_wire = str(getattr(args, "mqtt_s3_wire", "native")) == "fedml"
        self.mqtt = create_mqtt_transport(args, client_id=f"{self.topic_prefix}_{self.rank}")
        # store must exist before _subscribe: the local broker flushes
        # backlogged messages synchronously on subscribe, and on_message
        # resolves payload urls through self.store
        self.store = self._create_store(args)
        self._observers: List[Observer] = []
        self._incoming: "queue.Queue" = queue.Queue()
        self._running = False
        self._subscribe()

    def _create_store(self, args):
        """Payload-store hook; the web3/theta subclasses return a CAS store."""
        if self.ref_wire:
            from .ref_bucket import RefBucketStore

            root = getattr(args, "mqtt_s3_bucket_dir", None)
            if not root:
                raise ValueError("mqtt_s3_wire='fedml' requires mqtt_s3_bucket_dir")
            return RefBucketStore(root)
        return create_object_store(args)

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
            if self.ref_wire:
                # reference peers put the bucket key in model_params
                # (mqtt_s3_multi_clients_comm_manager.py:_on_message_impl)
                key = obj.get(Message.MSG_ARG_KEY_MODEL_PARAMS, "")
                if isinstance(key, str) and key.strip():
                    msg.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS,
                                   self.store.read_model(key.strip()))
            else:
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
        if self.ref_wire:
            self._send_ref_wire(msg, topic, params)
            return
        if params is not None:
            key = f"{self.topic_prefix}_{msg.get_sender_id()}_{receiver}_{msg.get_type()}"
            url = self.store.write_model(key, params)
            msg.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS_URL, url)
        self.mqtt.publish(topic, msg.to_json().encode())

    def _send_ref_wire(self, msg: Message, topic: str, params) -> None:
        """Reference contract: upload the pickled payload under
        ``<topic>_<uuid>`` and publish JSON whose model_params is that key
        (mqtt_s3_multi_clients_comm_manager.py:248 server / :283 client)."""
        payload = {k: v for k, v in msg.get_params().items()
                   if k != Message.MSG_ARG_KEY_MODEL_PARAMS}
        if params is not None:
            key = f"{topic}_{uuid.uuid4()}"
            url = self.store.write_model(key, params)
            payload[Message.MSG_ARG_KEY_MODEL_PARAMS] = key
            payload[Message.MSG_ARG_KEY_MODEL_PARAMS_URL] = url
        self.mqtt.publish(topic, json.dumps(payload).encode())

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
