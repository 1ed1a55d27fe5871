"""Per-link network telemetry: measured bandwidth/latency/loss per (src, dst)
comm pair, and a cost model other subsystems can query.

A copy of ``fedml_tpu/core/telemetry/netlink.py`` (framework-free) over the
port's ``health`` and ``trace_context``: the same estimators, cost model,
snapshots, gauges, statusz section and flow events, so a JAX party and a
port party book a link alike. A torch tensor counts ``Tensor.nbytes`` (a
card tensor its device bytes), as a numpy array counts its buffer.

The fleet runs over WANs it knows nothing about; routing and scheduling
decisions are only as good as the per-pair estimates feeding them:

- **passive accounting**: ``FedMLCommManager`` books every send/recv here
  (payload bytes, per-backend label, one-way message latency from the
  send-timestamp the sender stamps into the reserved telemetry header);
- **active probes**: ``core/distributed/link_probe.py`` drives small
  timestamped echo messages and feeds RTT/bandwidth samples into
  :meth:`NetLinkRegistry.observe_probe`;
- **estimators**: per-pair EWMAs with MAD-based outlier rejection reusing the
  health machinery (:func:`health.robust_zscores`), so one queue-stalled
  probe does not poison a link's bandwidth estimate;
- **cost model**: :class:`LinkCostModel` predicts transfer seconds for N
  bytes on a pair, with staleness-aware confidence; the async buffer's
  staleness admission (``async_link_admission``), the quorum's adaptive
  deadline (``quorum_link_cost``) and the pipelined round's micro-batch
  planner consume it;
- **export**: ``fedml_link_*`` per-pair gauges ride every ``prom.render``,
  the ``links`` statusz section rides every ``/statusz`` page, client-side
  observations ride the reserved-header delta into ``FleetTelemetry``, and
  :meth:`NetLinkRegistry.flow_events` emits Perfetto flow arrows so the
  fleet trace's comm edges carry measured link metadata.

Pair keys are *directed* ``(src, dst)`` ranks: the sender books
``bytes_sent`` on the pair, the receiver books ``bytes_recvd`` + latency. In
single-process INMEMORY runs all parties share this registry, so both sides
of each pair land in one place; multi-process deployments see their own
subset and the server unions client snapshots via :meth:`merge_remote`.

One-way latency compares the sender's wall clock to the receiver's
(NTP-level skew, ~ms); RTT from active probes uses only the originator's
monotonic clock and has no skew term. Passive latency samples are clamped at
zero and MAD-gated, so a skewed peer degrades to "no passive signal" rather
than a negative estimate.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .health import MAD_TO_SIGMA, robust_zscores
from .trace_context import RESERVED_TELEMETRY_KEY, SENT_AT_FIELD

__all__ = [
    "LinkCostModel",
    "LinkPrediction",
    "NetLinkRegistry",
    "PairStats",
    "RobustEwma",
    "get_registry",
    "reset",
    "payload_nbytes",
    "record_send",
    "record_recv",
    "prom_gauges",
    "statusz_snapshot",
    "make_upload_predictor",
]

DEFAULT_EWMA_ALPHA = 0.3       # same smoothing the health tracker uses
DEFAULT_MAD_Z = 3.5            # Iglewicz–Hoaglin cut, as in health.py
DEFAULT_SAMPLE_WINDOW = 16     # MAD reference window per estimator
MIN_MAD_SAMPLES = 5            # below this the gate admits everything
# this many consecutive rejections is not noise but a regime change (the
# link really did degrade): flush the stale window and adopt the new level,
# or the gate would reject the truth forever
REGIME_SHIFT_REJECTS = 5
LOSS_EWMA_ALPHA = 0.2          # probe loss is 0/1 — plain EWMA, no MAD gate

# passive bandwidth needs a message big enough that transfer time dominates
# the latency floor; control-plane messages only feed the byte counters
PASSIVE_BW_MIN_BYTES = 16_384

# staleness-aware confidence: freshness halves every this many seconds
# without a new bandwidth observation on the pair
DEFAULT_CONFIDENCE_HALF_LIFE_S = 60.0

FLOW_RING_CAPACITY = 4096      # bounded: flow events are a debugging aid

_NUM_NBYTES = 8                # scalars serialize as 8-byte floats/ints
_MAX_WALK_DEPTH = 6


def payload_nbytes(message: Any) -> int:
    """Approximate wire size of a message's payload: array leaves by their
    buffer size, strings/bytes by length, scalars by 8. Cheap (no
    serialization) and never raises — a diagnostics path must not kill the
    send path."""
    try:
        params = message.get_params()
    except Exception:  # noqa: BLE001 - duck-typed message
        return 0
    return _tree_nbytes(params, _MAX_WALK_DEPTH)


def _tree_nbytes(obj: Any, depth: int) -> int:
    if obj is None or depth < 0:
        return 0
    nb = getattr(obj, "nbytes", None)
    if isinstance(nb, int):       # numpy arrays and torch tensors
        return nb
    if isinstance(obj, (bytes, bytearray, str)):
        return len(obj)
    if isinstance(obj, bool):
        return 1
    if isinstance(obj, (int, float)):
        return _NUM_NBYTES
    if isinstance(obj, dict):
        return sum(_tree_nbytes(v, depth - 1) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tree_nbytes(v, depth - 1) for v in obj)
    return 0


class RobustEwma:
    """EWMA whose update is gated by a MAD-based outlier test against a
    window of recently *retained* samples (:func:`health.robust_zscores`).
    A sample whose modified z exceeds ``mad_z`` is counted, not folded — the
    median/MAD reference is insensitive to the very outliers it rejects."""

    __slots__ = ("alpha", "mad_z", "value", "samples", "count", "rejected",
                 "_consec_rejects")

    def __init__(self, alpha: float = DEFAULT_EWMA_ALPHA,
                 mad_z: float = DEFAULT_MAD_Z,
                 window: int = DEFAULT_SAMPLE_WINDOW):
        self.alpha = float(alpha)
        self.mad_z = float(mad_z)
        self.value: Optional[float] = None
        self.samples: deque = deque(maxlen=int(window))
        self.count = 0
        self.rejected = 0
        self._consec_rejects = 0

    def update(self, x: float) -> bool:
        """Fold one sample; returns False when the MAD gate rejected it."""
        x = float(x)
        if not math.isfinite(x):
            self.rejected += 1
            return False
        if len(self.samples) >= MIN_MAD_SAMPLES:
            med, mad, _ = robust_zscores(list(self.samples))
            if mad > 0.0 and abs(MAD_TO_SIGMA * (x - med) / mad) >= self.mad_z:
                self.rejected += 1
                self._consec_rejects += 1
                if self._consec_rejects < REGIME_SHIFT_REJECTS:
                    return False
                # sustained disagreement with the window = the link itself
                # changed; restart the reference at the new level
                self.samples.clear()
                self.value = None
            self._consec_rejects = 0
        self.samples.append(x)
        self.value = (x if self.value is None
                      else self.alpha * x + (1.0 - self.alpha) * self.value)
        self.count += 1
        return True

    def as_dict(self) -> Dict[str, Any]:
        return {
            "value": None if self.value is None else round(self.value, 6),
            "samples": self.count,
            "rejected": self.rejected,
        }

    def restore(self, d: Any) -> None:
        """Adopt a remote estimator summary (fleet merge): value + support,
        without the raw window (clients ship summaries, not samples)."""
        if not isinstance(d, dict):
            return
        v = d.get("value")
        if isinstance(v, (int, float)) and math.isfinite(float(v)):
            self.value = float(v)
            self.count = max(self.count, int(d.get("samples", 1) or 1))


class PairStats:
    """Mutable per-directed-pair state. ``bytes_sent`` is booked by the
    sending side's hook, ``bytes_recvd`` by the receiving side's — in a
    single shared registry both get booked without double counting either."""

    __slots__ = ("src", "dst", "backend", "bytes_sent", "bytes_recvd",
                 "msgs_sent", "msgs_recvd", "last_nbytes", "bw", "rtt",
                 "oneway", "loss_ewma", "probes_sent", "probes_answered",
                 "probes_lost", "last_probe_mono", "last_update_mono")

    def __init__(self, src: int, dst: int, backend: str = ""):
        self.src = int(src)
        self.dst = int(dst)
        self.backend = str(backend)
        self.bytes_sent = 0
        self.bytes_recvd = 0
        self.msgs_sent = 0
        self.msgs_recvd = 0
        self.last_nbytes = 0
        self.bw = RobustEwma()        # bytes/s
        self.rtt = RobustEwma()       # seconds, probe round trip
        self.oneway = RobustEwma()    # seconds, passive one-way latency
        self.loss_ewma: Optional[float] = None
        self.probes_sent = 0
        self.probes_answered = 0
        self.probes_lost = 0
        self.last_probe_mono: Optional[float] = None
        self.last_update_mono = time.monotonic()

    # --- observations -----------------------------------------------------
    def on_send(self, nbytes: int, backend: str) -> None:
        self.bytes_sent += int(nbytes)
        self.msgs_sent += 1
        self.last_nbytes = int(nbytes)
        if backend:
            self.backend = backend
        self.last_update_mono = time.monotonic()

    def on_recv(self, nbytes: int, backend: str,
                latency_s: Optional[float]) -> None:
        self.bytes_recvd += int(nbytes)
        self.msgs_recvd += 1
        self.last_nbytes = int(nbytes)
        if backend:
            self.backend = backend
        if latency_s is not None and latency_s >= 0.0:
            self.oneway.update(latency_s)
            if nbytes >= PASSIVE_BW_MIN_BYTES and latency_s > 0.0:
                # transfer-dominated message: its latency is a bandwidth
                # sample too (minus the pair's latency floor when known)
                floor = self.oneway.value or 0.0
                eff = max(latency_s - min(floor, latency_s * 0.5), 1e-9)
                self.bw.update(nbytes / eff)
        self.last_update_mono = time.monotonic()

    def on_probe(self, rtt_s: float, nbytes: int) -> None:
        """One answered probe. Zero-payload probes calibrate the RTT floor;
        sized probes yield bandwidth: the pad travels both ways, so
        ``bw = 2·nbytes / (rtt − rtt_floor)``."""
        self.probes_answered += 1
        self.last_probe_mono = time.monotonic()
        self.last_update_mono = self.last_probe_mono
        self._loss_sample(0.0)
        if nbytes <= 0:
            self.rtt.update(max(rtt_s, 0.0))
            return
        floor = self.rtt.value or 0.0
        eff = max(rtt_s - min(floor, rtt_s * 0.9), 1e-9)
        self.bw.update(2.0 * nbytes / eff)

    def on_probe_sent(self) -> None:
        self.probes_sent += 1

    def on_probe_lost(self) -> None:
        self.probes_lost += 1
        self.last_update_mono = time.monotonic()
        self._loss_sample(1.0)

    def _loss_sample(self, outcome: float) -> None:
        self.loss_ewma = (outcome if self.loss_ewma is None
                          else LOSS_EWMA_ALPHA * outcome
                          + (1.0 - LOSS_EWMA_ALPHA) * self.loss_ewma)

    # --- read side --------------------------------------------------------
    def probe_age_s(self) -> Optional[float]:
        if self.last_probe_mono is None:
            return None
        return max(0.0, time.monotonic() - self.last_probe_mono)

    def loss_ratio(self) -> float:
        return 0.0 if self.loss_ewma is None else self.loss_ewma

    def as_dict(self) -> Dict[str, Any]:
        age = self.probe_age_s()
        return {
            "src": self.src,
            "dst": self.dst,
            "backend": self.backend,
            "bytes_sent": self.bytes_sent,
            "bytes_recvd": self.bytes_recvd,
            "msgs_sent": self.msgs_sent,
            "msgs_recvd": self.msgs_recvd,
            "bw_bytes_per_s": self.bw.as_dict(),
            "rtt_s": self.rtt.as_dict(),
            "oneway_s": self.oneway.as_dict(),
            "loss_ratio": round(self.loss_ratio(), 4),
            "probes": {"sent": self.probes_sent,
                       "answered": self.probes_answered,
                       "lost": self.probes_lost},
            "last_probe_age_s": None if age is None else round(age, 3),
        }


class LinkPrediction:
    """One cost-model answer: predicted transfer seconds + confidence 0..1."""

    __slots__ = ("seconds", "confidence")

    def __init__(self, seconds: Optional[float], confidence: float):
        self.seconds = seconds
        self.confidence = float(confidence)

    def __repr__(self) -> str:  # pragma: no cover
        return f"LinkPrediction(seconds={self.seconds}, confidence={self.confidence})"


class LinkCostModel:
    """Predicted transfer time for N bytes on pair (src, dst):
    ``rtt/2 + nbytes/bandwidth``, from the pair's live estimators.

    Confidence is staleness-aware: ``freshness · support`` where freshness
    decays with a half-life since the pair's last estimator update and
    support saturates with retained sample count — a consumer can require
    e.g. ``confidence >= 0.5`` before trusting a prediction over its own
    fallback. Unknown pairs predict ``None`` at confidence 0."""

    def __init__(self, registry: "NetLinkRegistry",
                 half_life_s: float = DEFAULT_CONFIDENCE_HALF_LIFE_S):
        self._registry = registry
        self.half_life_s = float(half_life_s)

    def predict_transfer_s(self, src: int, dst: int, nbytes: int) -> LinkPrediction:
        stats = self._registry.pair((int(src), int(dst)), create=False)
        if stats is None:
            return LinkPrediction(None, 0.0)
        bw = stats.bw.value
        rtt = stats.rtt.value
        if bw is None and rtt is None:
            oneway = stats.oneway.value
            if oneway is None:
                return LinkPrediction(None, 0.0)
            rtt = 2.0 * oneway
        base = 0.0 if rtt is None else rtt / 2.0
        if bw is None or bw <= 0.0:
            # latency-only estimate: right for control messages, a floor
            # for bulk ones — confidence reflects the missing term
            return LinkPrediction(base, 0.25 * self._freshness(stats))
        seconds = base + float(nbytes) / bw
        support = stats.bw.count / (stats.bw.count + 3.0)
        return LinkPrediction(seconds, self._freshness(stats) * support)

    def _freshness(self, stats: PairStats) -> float:
        age = time.monotonic() - stats.last_update_mono
        if age <= 0.0 or self.half_life_s <= 0.0:
            return 1.0
        return 0.5 ** (age / self.half_life_s)


class NetLinkRegistry:
    """Process-wide per-pair link state. Thread-safe: send hooks, receive
    loops, the prober thread, and statusz/metrics readers all touch it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pairs: Dict[Tuple[int, int], PairStats] = {}
        # client-observed snapshots merged by the server, keyed by observer
        # rank; pairs the server also sees locally stay authoritative local
        self._remote: Dict[int, Dict[str, Any]] = {}
        self._flows: deque = deque(maxlen=FLOW_RING_CAPACITY)
        self._flow_seq = 0

    # --- pair access ------------------------------------------------------
    def pair(self, key: Tuple[int, int], create: bool = True) -> Optional[PairStats]:
        key = (int(key[0]), int(key[1]))
        with self._lock:
            stats = self._pairs.get(key)
            if stats is None and create:
                stats = self._pairs[key] = PairStats(*key)
            return stats

    def pairs(self) -> Dict[Tuple[int, int], PairStats]:
        with self._lock:
            return dict(self._pairs)

    # --- passive accounting (comm-manager hooks) --------------------------
    def record_send(self, message: Any, backend: str = "") -> None:
        """Book one outgoing message and stamp its send time into the
        reserved telemetry header so the receiver can measure latency."""
        try:
            src = int(message.get_sender_id())
            dst = int(message.get_receiver_id())
        except Exception:  # noqa: BLE001 - diagnostics must not break sends
            return
        if src == dst:
            return  # synthesized local messages (CONNECTION_IS_READY) are not links
        nbytes = payload_nbytes(message)
        try:
            header = message.get(RESERVED_TELEMETRY_KEY)
            if not isinstance(header, dict):
                header = {}
                message.add_params(RESERVED_TELEMETRY_KEY, header)
            header.setdefault(SENT_AT_FIELD, time.time_ns())
        except Exception:  # noqa: BLE001 - header is best-effort
            pass
        stats = self.pair((src, dst))
        with self._lock:
            stats.on_send(nbytes, backend)

    def record_recv(self, message: Any, backend: str = "") -> None:
        """Book one arrival; when the sender stamped a send time, the
        wall-clock difference is this message's latency sample (clamped at
        zero — cross-host NTP skew must not produce negative samples)."""
        try:
            src = int(message.get_sender_id())
            dst = int(message.get_receiver_id())
        except Exception:  # noqa: BLE001 - diagnostics must not break recvs
            return
        if src == dst:
            return  # synthesized local messages are not links
        nbytes = payload_nbytes(message)
        latency_s: Optional[float] = None
        sent_ns: Optional[int] = None
        try:
            header = message.get(RESERVED_TELEMETRY_KEY)
            if isinstance(header, dict):
                sent = header.get(SENT_AT_FIELD)
                if isinstance(sent, int):
                    sent_ns = sent
                    latency_s = max(0.0, (time.time_ns() - sent) / 1e9)
        except Exception:  # noqa: BLE001 - tolerate duck-typed messages
            pass
        stats = self.pair((src, dst))
        with self._lock:
            stats.on_recv(nbytes, backend, latency_s)
            if sent_ns is not None:
                self._flow_seq += 1
                self._flows.append({
                    "id": self._flow_seq, "src": src, "dst": dst,
                    "nbytes": nbytes, "t_send_unix_ns": sent_ns,
                    "t_recv_unix_ns": time.time_ns(),
                    "msg_type": _safe_type(message),
                })

    # --- active probes (link_probe.py) ------------------------------------
    def observe_probe(self, src: int, dst: int, rtt_s: float, nbytes: int,
                      backend: str = "") -> None:
        stats = self.pair((src, dst))
        with self._lock:
            if backend:
                stats.backend = backend
            stats.on_probe(float(rtt_s), int(nbytes))

    def probe_sent(self, src: int, dst: int) -> None:
        stats = self.pair((src, dst))
        with self._lock:
            stats.on_probe_sent()

    def probe_lost(self, src: int, dst: int) -> None:
        stats = self.pair((src, dst))
        with self._lock:
            stats.on_probe_lost()

    # --- cost model -------------------------------------------------------
    def cost_model(self, half_life_s: float = DEFAULT_CONFIDENCE_HALF_LIFE_S) -> LinkCostModel:
        return LinkCostModel(self, half_life_s)

    # --- fleet merge ------------------------------------------------------
    def delta_snapshot(self) -> Dict[str, Any]:
        """Client-side: JSON-safe pair summaries to ride the reserved-header
        delta (``delta["link"]``) on the next model upload."""
        with self._lock:
            return {f"{k[0]}->{k[1]}": s.as_dict() for k, s in self._pairs.items()}

    def merge_remote(self, observer_rank: int, snap: Any) -> bool:
        """Server-side: fold one client's pair summaries in. Pairs the
        server has no local estimator for adopt the remote EWMA values (a
        client measures its own uplink better than the server can); pairs
        with local signal keep it and the snapshot stays readable under the
        statusz ``remote`` key. Defensive: junk is dropped, never raised."""
        if not isinstance(snap, dict):
            return False
        try:
            observer_rank = int(observer_rank)
        except (TypeError, ValueError):
            return False
        with self._lock:
            self._remote[observer_rank] = snap
        for key_s, d in snap.items():
            if not isinstance(d, dict):
                continue
            try:
                src, dst = (int(x) for x in str(key_s).split("->"))
            except ValueError:
                continue
            stats = self.pair((src, dst))
            with self._lock:
                if stats.bw.value is None:
                    stats.bw.restore(d.get("bw_bytes_per_s"))
                if stats.rtt.value is None:
                    stats.rtt.restore(d.get("rtt_s"))
                if stats.oneway.value is None:
                    stats.oneway.restore(d.get("oneway_s"))
        return True

    # --- export: prometheus ----------------------------------------------
    def prom_gauges(self) -> List[tuple]:
        """``(name, labels, value)`` triples for ``prom.render(gauges=...)``.
        Every series is per-pair, labeled ``{src, dst, backend}``; the cost
        model's view is exported as the predicted seconds to move 1 MiB plus
        its confidence, so dashboards see what the consumers would."""
        cost = self.cost_model()
        out: List[tuple] = []
        with self._lock:
            items = sorted(self._pairs.items())
        for (src, dst), s in items:
            labels = {"src": str(src), "dst": str(dst), "backend": s.backend}
            if s.bw.value is not None:
                out.append(("link_bandwidth_bytes_per_sec", labels, float(s.bw.value)))
            if s.rtt.value is not None:
                out.append(("link_rtt_seconds", labels, float(s.rtt.value)))
            out.append(("link_loss_ratio", labels, float(s.loss_ratio())))
            age = s.probe_age_s()
            if age is not None:
                out.append(("link_last_probe_age_seconds", labels, float(age)))
            out.append(("link_bytes_sent", labels, float(s.bytes_sent)))
            out.append(("link_bytes_received", labels, float(s.bytes_recvd)))
            pred = cost.predict_transfer_s(src, dst, 1 << 20)
            if pred.seconds is not None:
                out.append(("link_predicted_mib_seconds", labels, float(pred.seconds)))
            out.append(("link_confidence", labels, float(pred.confidence)))
        return out

    # --- export: statusz --------------------------------------------------
    def statusz(self) -> Dict[str, Any]:
        """The `/statusz` ``links`` section: one row per pair (est.
        bandwidth, RTT, last-probe age, bytes in/out) + merged remote
        observations keyed by observer rank."""
        cost = self.cost_model()
        with self._lock:
            items = sorted(self._pairs.items())
            remote = {str(r): snap for r, snap in sorted(self._remote.items())}
        pairs = {}
        for (src, dst), s in items:
            row = s.as_dict()
            pred = cost.predict_transfer_s(src, dst, 1 << 20)
            row["predicted_mib_s"] = (None if pred.seconds is None
                                      else round(pred.seconds, 6))
            row["confidence"] = round(pred.confidence, 4)
            pairs[f"{src}->{dst}"] = row
        doc: Dict[str, Any] = {"pairs": pairs}
        if remote:
            doc["remote"] = remote
        return doc

    # --- export: perfetto flow events -------------------------------------
    def flow_events(self, server_epoch_unix_ns: int) -> List[Dict[str, Any]]:
        """Chrome-trace flow pairs (``ph:"s"`` at send on the sender's lane,
        ``ph:"f"`` at receive on the receiver's) for every timestamped
        transfer in the ring, carrying measured link metadata so the fleet
        trace's comm arrows answer "how big/how fast was that edge"."""
        with self._lock:
            flows = list(self._flows)
            stats = {k: (s.bw.value, s.rtt.value) for k, s in self._pairs.items()}
        events: List[Dict[str, Any]] = []
        for f in flows:
            bw, rtt = stats.get((f["src"], f["dst"]), (None, None))
            args = {"bytes": f["nbytes"], "msg_type": f["msg_type"]}
            if bw is not None:
                args["bw_est_bytes_per_s"] = round(bw, 1)
            if rtt is not None:
                args["rtt_est_ms"] = round(rtt * 1e3, 3)
            ts_send = (f["t_send_unix_ns"] - server_epoch_unix_ns) / 1e3
            ts_recv = (f["t_recv_unix_ns"] - server_epoch_unix_ns) / 1e3
            common = {"cat": "link", "name": "link.transfer", "id": f["id"]}
            events.append({"ph": "s", "pid": f["src"], "tid": 0,
                           "ts": ts_send, "args": args, **common})
            events.append({"ph": "f", "bp": "e", "pid": f["dst"], "tid": 0,
                           "ts": max(ts_recv, ts_send), "args": args, **common})
        return events


def _safe_type(message: Any) -> str:
    try:
        return str(message.get_type())
    except Exception:  # noqa: BLE001 - duck-typed message
        return "unknown"


# --- module-level singleton + fast paths -------------------------------------
_registry = NetLinkRegistry()
_registry_lock = threading.Lock()


def get_registry() -> NetLinkRegistry:
    return _registry


def reset() -> None:
    """Fresh registry (tests; mirrors ``InMemoryBroker.reset``)."""
    global _registry
    with _registry_lock:
        _registry = NetLinkRegistry()


def record_send(message: Any, backend: str = "") -> None:
    _registry.record_send(message, backend)


def record_recv(message: Any, backend: str = "") -> None:
    _registry.record_recv(message, backend)


def prom_gauges() -> List[tuple]:
    """Module-level gauge ride-along for ``prom.render`` (mesh-gauge idiom:
    every /metrics surface shows link pairs without per-process wiring)."""
    return _registry.prom_gauges()


def statusz_snapshot() -> Dict[str, Any]:
    """Empty dict when no pair has been observed — statusz renders the
    ``links`` section only on processes that actually talk."""
    if not _registry.pairs():
        return {}
    return _registry.statusz()


def make_upload_predictor(nbytes_fn: Callable[[int], int],
                          server_rank: int = 0,
                          min_confidence: float = 0.25) -> Callable[[int], Optional[float]]:
    """Build a ``rank -> predicted upload seconds`` callable for the
    flag-gated consumers (quorum deadline, async staleness admission): the
    (client, server) pair's cost-model prediction for ``nbytes_fn(rank)``
    bytes. Predictions below ``min_confidence`` return None so consumers
    keep their health-EWMA fallback instead of trusting a stale link."""
    def predict(rank: int) -> Optional[float]:
        cost = _registry.cost_model()
        p = cost.predict_transfer_s(int(rank), int(server_rank), int(nbytes_fn(rank)))
        if p.seconds is None or p.confidence < min_confidence:
            return None
        return float(p.seconds)
    return predict
