"""Deterministic in-process message broker: a copy of
``fedml_tpu/core/distributed/communication/inmemory/broker.py``, the test
seam the reference lacks (SURVEY §4: "no fake/mock comm backend ... the
natural place the new framework should put a real in-memory fake").

Topics are rank ids; each rank gets a FIFO queue. Thread-safe; one broker
per ``run_id`` so concurrent tests don't cross-talk.

Fault injection: :meth:`set_throttle` (the ``chaos_link_throttle`` knob)
models a degraded WAN link for one rank — every message to or from that
rank is delivered after ``nbytes / bytes_per_sec (+ base delay)``, with
netlink's ``payload_nbytes`` for the bytes, as in the JAX broker. Delivery
is delayed per message (a timer, not a serial pipe), which is what the
netlink estimators' per-message latency samples assume. A timer whose
delivery fails keeps its error, and the broker's next :meth:`publish`
raises it.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional, Tuple


class InMemoryBroker:
    _instances: Dict[str, "InMemoryBroker"] = {}
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._queues: Dict[int, "queue.Queue"] = {}
        self._qlock = threading.Lock()
        # rank -> (bytes_per_sec, base_delay_s); applies to both directions
        self._throttles: Dict[int, Tuple[float, float]] = {}
        # the first error of a delayed delivery, raised by the next publish
        self.timer_error: Optional[BaseException] = None

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

    # --- chaos_link_throttle ---------------------------------------------
    def set_throttle(self, rank: int, bytes_per_sec: float,
                     base_delay_s: float = 0.0) -> None:
        """Degrade ``rank``'s link: messages it sends or receives take
        ``base_delay_s + nbytes / bytes_per_sec`` to deliver."""
        with self._qlock:
            self._throttles[int(rank)] = (float(bytes_per_sec), float(base_delay_s))

    def clear_throttle(self, rank: int) -> None:
        with self._qlock:
            self._throttles.pop(int(rank), None)

    def _chaos_delay_s(self, receiver_rank: int, item) -> float:
        with self._qlock:
            if not self._throttles:
                return 0.0
            throttles = dict(self._throttles)
        ranks = {int(receiver_rank)}
        try:
            ranks.add(int(item.get_sender_id()))
        except AttributeError:  # the receive loop's stop sentinel has no sender
            pass
        hit = [throttles[r] for r in ranks if r in throttles]
        if not hit:
            return 0.0
        from ....telemetry.netlink import payload_nbytes

        nbytes = payload_nbytes(item)
        # a message crossing two throttled endpoints pays the slower link
        return max(base + (nbytes / bps if bps > 0 else 0.0)
                   for bps, base in hit)

    def _deliver(self, rank: int, item) -> None:
        try:
            self.queue_for(rank).put(item)
        except BaseException as e:
            with self._qlock:
                if self.timer_error is None:
                    self.timer_error = e
            raise

    def publish(self, rank: int, item) -> None:
        if self.timer_error is not None:
            raise RuntimeError(
                f"a throttled delivery failed: {self.timer_error!r}") from self.timer_error
        delay_s = self._chaos_delay_s(rank, item)
        if delay_s <= 0.0:
            self.queue_for(rank).put(item)
            return
        t = threading.Timer(delay_s, self._deliver, args=(rank, item))
        t.daemon = True
        t.start()
