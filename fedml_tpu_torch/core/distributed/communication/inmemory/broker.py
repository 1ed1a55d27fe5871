"""Deterministic in-process message broker: a copy of
``fedml_tpu/core/distributed/communication/inmemory/broker.py``, the test
seam the reference lacks (SURVEY §4: "no fake/mock comm backend ... the
natural place the new framework should put a real in-memory fake").

Topics are rank ids; each rank gets a FIFO queue. Thread-safe; one broker
per ``run_id`` so concurrent tests don't cross-talk.

The JAX broker's link throttle (the ``chaos_link_throttle`` knob) sizes each
delay with ``telemetry.netlink``, which is not ported: the knob raises in
``FedMLCommManager`` (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional


class InMemoryBroker:
    _instances: Dict[str, "InMemoryBroker"] = {}
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._queues: Dict[int, "queue.Queue"] = {}
        self._qlock = threading.Lock()

    @classmethod
    def get(cls, run_id: str) -> "InMemoryBroker":
        with cls._lock:
            if run_id not in cls._instances:
                cls._instances[run_id] = cls()
            return cls._instances[run_id]

    @classmethod
    def reset(cls, run_id: Optional[str] = None) -> None:
        with cls._lock:
            if run_id is None:
                cls._instances.clear()
            else:
                cls._instances.pop(run_id, None)

    def queue_for(self, rank: int) -> "queue.Queue":
        with self._qlock:
            if rank not in self._queues:
                self._queues[rank] = queue.Queue()
            return self._queues[rank]

    def publish(self, rank: int, item) -> None:
        self.queue_for(rank).put(item)
