"""Active link probing: timestamped echo messages at a configurable cadence.

A copy of ``fedml_tpu/core/distributed/link_probe.py`` (framework-free)
over the port's ``netlink``, but that a failed tick ends the prober: the
error is kept, the thread exits with it, and :meth:`LinkProber.stop` raises
it (the JAX prober logs it and probes on).

The passive accounting in ``core/telemetry/netlink.py`` only sees the
messages the protocol happens to send — one model broadcast per round tells
you nothing about a link that just degraded mid-round. This prober closes
the gap with a packet-pair-style active measurement:

- every ``interval_s`` it sends each peer TWO probes: a zero-payload one
  (RTT floor) and a padded one of ``payload_bytes`` (bandwidth — the pad is
  echoed back, so ``bw = 2·payload / (rtt − rtt_floor)``);
- the echo carries the originator's opaque send timestamp and sequence
  number back, so RTT uses only the originator's monotonic clock — no
  cross-host skew term, unlike the passive one-way latency;
- probes unanswered after ``timeout_intervals`` cadences count as losses.

Wire format is owned by the caller: this module is below the cross-silo
layer, so the manager supplies ``send_probe(peer, seq, t_send_ns, nbytes)``
(building its ``MyMessage`` vocabulary) and routes echo arrivals back via
:meth:`LinkProber.observe_echo`. The cross-silo server starts one prober
once the cohort is online (``args.link_probe_interval_s > 0``); clients
answer probes statelessly (their echo handler needs no prober).

Each probing tick runs inside a ``link.probe`` telemetry span, so the
probes' overhead shows in the span stats.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from ..telemetry import core as tel_core
from ..telemetry import netlink

log = logging.getLogger(__name__)

DEFAULT_PAYLOAD_BYTES = 65536
DEFAULT_TIMEOUT_INTERVALS = 3.0

# one prober tick sends each peer a (floor, sized) probe pair
PROBE_SIZES = (0,)  # zero-size first; the sized probe is appended per config


class LinkProber:
    """Background probe driver for one party. ``peers`` is a callable so the
    cohort can change between ticks (over-provisioned rounds)."""

    def __init__(self,
                 local_rank: int,
                 send_probe: Callable[[int, int, int, int], None],
                 peers: Callable[[], Iterable[int]],
                 interval_s: float,
                 payload_bytes: int = DEFAULT_PAYLOAD_BYTES,
                 timeout_intervals: float = DEFAULT_TIMEOUT_INTERVALS,
                 registry: Optional[netlink.NetLinkRegistry] = None,
                 backend: str = ""):
        if interval_s <= 0:
            raise ValueError(f"probe interval must be > 0, got {interval_s}")
        self.local_rank = int(local_rank)
        self._send_probe = send_probe
        self._peers = peers
        self.interval_s = float(interval_s)
        self.payload_bytes = int(payload_bytes)
        self.timeout_s = float(timeout_intervals) * self.interval_s
        self.backend = backend
        self._registry = registry
        self._lock = threading.Lock()
        # (peer, seq) -> (t_send_mono_ns, nbytes); authoritative for RTT —
        # the echoed timestamp is convenience for off-path observers only
        self._outstanding: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._seq = 0
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        self.echoes = 0
        # the exception that ended the probing thread, raised by stop()
        self.error: Optional[BaseException] = None

    @property
    def registry(self) -> netlink.NetLinkRegistry:
        return self._registry if self._registry is not None else netlink.get_registry()

    # --- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name="link-prober", daemon=True)
        self._thread.start()
        log.info("link prober started: interval %.3gs, payload %d bytes",
                 self.interval_s, self.payload_bytes)

    def stop(self) -> None:
        """Stop the thread; raise the error that ended it, if one did."""
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(5.0, 2 * self.interval_s))
            self._thread = None
        if self.error is not None:
            raise RuntimeError(f"link prober failed: {self.error!r}") from self.error

    def _loop(self) -> None:
        # Event.wait doubles as the cadence timer and the stop signal, so
        # shutdown never waits out a full interval
        try:
            while not self._stop_evt.wait(self.interval_s):
                self.tick()
        except BaseException as e:
            self.error = e
            raise

    # --- probing ----------------------------------------------------------
    def tick(self) -> None:
        """One probing round: expire stale probes, then send each peer the
        (floor, sized) probe pair. Public so tests can drive the cadence
        deterministically without the thread."""
        with tel_core.get_telemetry().span("link.probe"):
            self._expire()
            now_ns = time.perf_counter_ns()
            for peer in list(self._peers()):
                peer = int(peer)
                for nbytes in (*PROBE_SIZES, self.payload_bytes):
                    with self._lock:
                        self._seq += 1
                        seq = self._seq
                        self._outstanding[(peer, seq)] = (now_ns, nbytes)
                    self.registry.probe_sent(self.local_rank, peer)
                    self._send_probe(peer, seq, now_ns, nbytes)
            self.ticks += 1

    def _expire(self) -> None:
        cutoff_ns = time.perf_counter_ns() - int(self.timeout_s * 1e9)
        with self._lock:
            lost = [k for k, (t_ns, _) in self._outstanding.items()
                    if t_ns < cutoff_ns]
            for k in lost:
                del self._outstanding[k]
        for peer, _seq in lost:
            self.registry.probe_lost(self.local_rank, peer)

    def observe_echo(self, peer: int, seq: Any, t_send_ns: Any) -> None:
        """One echo arrived. RTT comes from the locally stored send time for
        that (peer, seq); unknown sequences (already expired, or a replay)
        are dropped — the echoed timestamp is never trusted for timing."""
        try:
            key = (int(peer), int(seq))
        except (TypeError, ValueError):
            return
        with self._lock:
            entry = self._outstanding.pop(key, None)
        if entry is None:
            return
        sent_ns, nbytes = entry
        rtt_s = max(0.0, (time.perf_counter_ns() - sent_ns) / 1e9)
        self.echoes += 1
        self.registry.observe_probe(self.local_rank, key[0], rtt_s, nbytes,
                                    backend=self.backend)

    def outstanding(self) -> int:
        with self._lock:
            return len(self._outstanding)

    def statusz(self) -> Dict[str, Any]:
        return {
            "interval_s": self.interval_s,
            "payload_bytes": self.payload_bytes,
            "ticks": self.ticks,
            "echoes": self.echoes,
            "outstanding": self.outstanding(),
        }


def probe_config(args: Any) -> Optional[Dict[str, float]]:
    """The probe cadence knobs from args, or None when probing is off
    (``link_probe_interval_s`` unset/0 — the default: passive accounting is
    free, active traffic is opt-in)."""
    interval = float(getattr(args, "link_probe_interval_s", 0) or 0)
    if interval <= 0:
        return None
    return {
        "interval_s": interval,
        "payload_bytes": int(getattr(args, "link_probe_payload_bytes",
                                     DEFAULT_PAYLOAD_BYTES)),
        "timeout_intervals": float(getattr(args, "link_probe_timeout_intervals",
                                           DEFAULT_TIMEOUT_INTERVALS)),
    }
