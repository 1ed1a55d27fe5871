"""In-memory communication backend: a copy of
``fedml_tpu/core/distributed/communication/inmemory/inmemory_comm_manager.py``.

Same observer contract as every other backend (base_com_manager.py), so the
full cross-silo client/server manager protocol runs unmodified inside one
process — either multi-threaded (one thread per party) or sequentially in
tests. Payloads are passed by reference (zero-copy), which also makes this
the fastest simulation transport; a state dict stays on the device it is on.

Where the JAX package may share its payloads because JAX arrays are
immutable, torch tensors are not: sharing stays safe only while no party
writes a payload in place. The cross-silo path keeps that so: the server's
global is the fold's fresh output, the client trainer copies a received
state dict into its module (``set_model_params``) and uploads a copy of its
parameters (``get_model_params``).
"""

from __future__ import annotations

import logging
import queue
from typing import List

from .....core.telemetry import trace_context
from ..base_com_manager import BaseCommunicationManager, Observer
from ..message import Message
from .broker import InMemoryBroker

log = logging.getLogger(__name__)

_STOP = object()


class InMemoryCommManager(BaseCommunicationManager):
    def __init__(self, run_id: str, rank: int, size: int):
        self.run_id = str(run_id)
        self.rank = rank
        self.size = size
        self.broker = InMemoryBroker.get(self.run_id)
        self._observers: List[Observer] = []
        self._running = False

    def send_message(self, msg: Message) -> None:
        trace_context.inject(msg)
        receiver = msg.get_receiver_id()
        log.debug("inmemory send %s", msg)
        self.broker.publish(receiver, msg)

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        if observer in self._observers:
            self._observers.remove(observer)

    def handle_receive_message(self) -> None:
        self._running = True
        q = self.broker.queue_for(self.rank)
        while self._running:
            try:
                item = q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is _STOP:
                break
            # activated(None) on a context-free message deliberately clears
            # any stale context from the previous dispatch (old-sender compat)
            with trace_context.activated(trace_context.extract(item)):
                for obs in list(self._observers):
                    obs.receive_message(item.get_type(), item)

    def stop_receive_message(self) -> None:
        self._running = False
        self.broker.publish(self.rank, _STOP)
