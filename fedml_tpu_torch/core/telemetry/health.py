"""Per-client health scoring and straggler detection for synchronous FL.

A copy of ``fedml_tpu/core/telemetry/health.py`` (framework-free).

A synchronous round is gated by its slowest member (Holmes, arxiv 2312.03549;
PiPar, arxiv 2302.12803 quantifies the idle-time cost), so the server needs a
cheap, robust answer to "which silo is dragging the cohort". This module
keeps one :class:`ClientHealth` record per rank, fed from the same
``FleetTelemetry.merge_client_delta`` path the fleet trace already rides:

- **round time**: the client's ``client.train`` span duration, smoothed with
  an EWMA (``FEDML_HEALTH_EWMA_ALPHA``, default 0.3) so the per-rank baseline
  tracks drift without whipsawing on one noisy round;
- **straggler flag**: per-round robust z-score against the cohort —
  ``z = 0.6745 * (x - median) / MAD``. MAD-based z is insensitive to the very
  outliers it hunts (a mean/stddev z would be dragged toward the straggler).
  A rank is flagged when ``z >= FEDML_HEALTH_MAD_Z`` (default 3.5, the
  classic Iglewicz–Hoaglin cut) AND it is at least
  ``FEDML_HEALTH_MIN_GAP_S`` (default 0.1s) over the median — the absolute
  floor keeps microsecond-scale jitter in tiny test cohorts from flagging —
  AND the cohort has >= 3 reporting members (a median of two is meaningless);
- **failures**: consecutive and total failed uploads per rank;
- **silence**: seconds since the rank last reported; past
  ``FEDML_HEALTH_SILENCE_S`` (default 300) the rank is presumed gone.

``end_round`` folds the round's observations into a :class:`HealthReport`
(the dict the server ships through the mlops uplink and `/statusz` renders),
bumps the ``straggler`` counter (rendered as ``fedml_straggler_total`` on
`/metrics`), and ``prom_gauges`` exposes the 0..1 health score per rank as
``fedml_client_health{rank=...}``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .core import get_telemetry

__all__ = [
    "ClientHealth",
    "HealthReport",
    "HealthTracker",
    "robust_zscores",
]

_ENV_ALPHA = "FEDML_HEALTH_EWMA_ALPHA"
_ENV_MAD_Z = "FEDML_HEALTH_MAD_Z"
_ENV_MIN_GAP_S = "FEDML_HEALTH_MIN_GAP_S"
_ENV_SILENCE_S = "FEDML_HEALTH_SILENCE_S"

DEFAULT_EWMA_ALPHA = 0.3
DEFAULT_MAD_Z = 3.5          # Iglewicz–Hoaglin modified-z cutoff
DEFAULT_MIN_GAP_S = 0.1      # absolute floor over the median, vs scale noise
DEFAULT_SILENCE_S = 300.0

# 0.6745 = Φ⁻¹(0.75): scales MAD to estimate σ under normality, making the
# modified z comparable to an ordinary z-score.
MAD_TO_SIGMA = 0.6745

# cohort sizes below this cannot support a meaningful median/MAD verdict
MIN_COHORT = 3


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def robust_zscores(values: List[float]) -> Tuple[float, float, List[float]]:
    """(median, MAD, modified z per value). MAD==0 → zeros (degenerate
    cohort where everyone is identical: nobody is an outlier by scale)."""
    med = _median(values)
    mad = _median([abs(v - med) for v in values])
    if mad <= 0.0:
        return med, mad, [0.0] * len(values)
    return med, mad, [MAD_TO_SIGMA * (v - med) / mad for v in values]


class ClientHealth:
    """Mutable per-rank state; ``as_dict`` is the uplink/statusz shape."""

    __slots__ = ("rank", "ewma_s", "last_s", "rounds", "consecutive_failures",
                 "total_failures", "last_seen_mono", "straggler_rounds",
                 "last_z", "flagged")

    def __init__(self, rank: int):
        self.rank = int(rank)
        self.ewma_s: Optional[float] = None
        self.last_s: Optional[float] = None
        self.rounds = 0
        self.consecutive_failures = 0
        self.total_failures = 0
        self.last_seen_mono: Optional[float] = None
        self.straggler_rounds = 0
        self.last_z: Optional[float] = None
        self.flagged = False  # straggler verdict from the most recent round

    def silence_s(self) -> Optional[float]:
        if self.last_seen_mono is None:
            return None
        return max(0.0, time.monotonic() - self.last_seen_mono)

    def score(self, silence_threshold_s: float) -> float:
        """0..1 health: 1 is nominal; flagged straggler halves it, each
        consecutive failure takes 20% of what remains, prolonged silence
        zeroes it."""
        sil = self.silence_s()
        if sil is not None and sil >= silence_threshold_s:
            return 0.0
        s = 1.0
        if self.flagged:
            s *= 0.5
        s *= 0.8 ** min(self.consecutive_failures, 10)
        return round(s, 4)

    def as_dict(self, silence_threshold_s: float) -> Dict[str, Any]:
        sil = self.silence_s()
        return {
            "rank": self.rank,
            "score": self.score(silence_threshold_s),
            "ewma_s": None if self.ewma_s is None else round(self.ewma_s, 6),
            "last_s": None if self.last_s is None else round(self.last_s, 6),
            "rounds": self.rounds,
            "consecutive_failures": self.consecutive_failures,
            "total_failures": self.total_failures,
            "silence_s": None if sil is None else round(sil, 3),
            "straggler": self.flagged,
            "straggler_rounds": self.straggler_rounds,
            "last_z": None if self.last_z is None else round(self.last_z, 3),
        }


class HealthReport(dict):
    """Plain dict subclass so it JSON-serializes untouched; keys:
    ``round``, ``cohort`` ({median_s, mad_s, n}), ``clients`` (rank-keyed
    :meth:`ClientHealth.as_dict`), ``stragglers`` (list of ranks)."""

    @property
    def stragglers(self) -> List[int]:
        return list(self.get("stragglers", []))


class HealthTracker:
    """Cohort health state machine. Thread-safe: observations arrive on the
    server's receive loop, while `/statusz` and `/metrics` read concurrently."""

    def __init__(self,
                 ewma_alpha: Optional[float] = None,
                 mad_z_threshold: Optional[float] = None,
                 min_gap_s: Optional[float] = None,
                 silence_threshold_s: Optional[float] = None):
        self.ewma_alpha = (_env_float(_ENV_ALPHA, DEFAULT_EWMA_ALPHA)
                           if ewma_alpha is None else float(ewma_alpha))
        self.mad_z_threshold = (_env_float(_ENV_MAD_Z, DEFAULT_MAD_Z)
                                if mad_z_threshold is None else float(mad_z_threshold))
        self.min_gap_s = (_env_float(_ENV_MIN_GAP_S, DEFAULT_MIN_GAP_S)
                          if min_gap_s is None else float(min_gap_s))
        self.silence_threshold_s = (_env_float(_ENV_SILENCE_S, DEFAULT_SILENCE_S)
                                    if silence_threshold_s is None
                                    else float(silence_threshold_s))
        self._lock = threading.Lock()
        self._clients: Dict[int, ClientHealth] = {}
        # durations observed since the last end_round(), keyed by rank —
        # a rank reporting twice in one round keeps its latest value
        self._pending: Dict[int, float] = {}
        self._last_report: Optional[HealthReport] = None

    def _client(self, rank: int) -> ClientHealth:
        c = self._clients.get(rank)
        if c is None:
            c = self._clients[rank] = ClientHealth(rank)
        return c

    # --- observations (receive-loop side) ---------------------------------
    def observe_round(self, rank: int, duration_s: float,
                      round_idx: Optional[int] = None) -> None:
        """One completed local-training duration for ``rank``."""
        duration_s = float(duration_s)
        if duration_s < 0:
            return
        with self._lock:
            c = self._client(int(rank))
            c.last_s = duration_s
            c.ewma_s = (duration_s if c.ewma_s is None
                        else self.ewma_alpha * duration_s + (1 - self.ewma_alpha) * c.ewma_s)
            c.rounds += 1
            c.consecutive_failures = 0
            c.last_seen_mono = time.monotonic()
            self._pending[int(rank)] = duration_s

    def observe_failure(self, rank: int) -> None:
        with self._lock:
            c = self._client(int(rank))
            c.consecutive_failures += 1
            c.total_failures += 1
            c.last_seen_mono = time.monotonic()

    def heartbeat(self, rank: int) -> None:
        """Any sign of life that is not a round result (status message,
        stale-but-arriving delta)."""
        with self._lock:
            self._client(int(rank)).last_seen_mono = time.monotonic()

    # --- round boundary (server side) --------------------------------------
    def end_round(self, round_idx: int) -> HealthReport:
        """Close the round: run the cohort MAD test over this round's
        durations, update flags/EWMAs, and return the report. Also bumps the
        ``straggler`` telemetry counter once per flagged rank."""
        with self._lock:
            pending = dict(self._pending)
            self._pending.clear()
            ranks = sorted(pending)
            durations = [pending[r] for r in ranks]
            flagged: List[int] = []
            med = mad = None
            if len(durations) >= MIN_COHORT:
                med, mad, zs = robust_zscores(durations)
                for r, x, z in zip(ranks, durations, zs):
                    c = self._client(r)
                    gap = x - med
                    if mad > 0.0:
                        c.last_z = z
                        is_straggler = (z >= self.mad_z_threshold
                                        and gap >= self.min_gap_s)
                    else:
                        # MAD==0: the cohort majority is identical (zero
                        # scale), so the z-score is undefined — fall back to
                        # the absolute floor alone. Common in small test
                        # cohorts where two fast clients tie exactly.
                        c.last_z = None
                        is_straggler = gap >= self.min_gap_s
                    c.flagged = is_straggler
                    if is_straggler:
                        c.straggler_rounds += 1
                        flagged.append(r)
            else:
                for r in ranks:
                    c = self._client(r)
                    c.last_z = None
                    c.flagged = False
            report = HealthReport(
                round=int(round_idx),
                cohort={
                    "n": len(durations),
                    "median_s": None if med is None else round(med, 6),
                    "mad_s": None if mad is None else round(mad, 6),
                },
                clients={
                    str(r): c.as_dict(self.silence_threshold_s)
                    for r, c in sorted(self._clients.items())
                },
                stragglers=flagged,
            )
            self._last_report = report
        if flagged:
            get_telemetry().counter("straggler").add(len(flagged))
        return report

    # --- persistence (core.resilience round-state snapshots) ----------------
    def export_state(self) -> Dict[str, Any]:
        """JSON-safe per-rank state for a round-state snapshot, so a resumed
        server keeps its EWMA baselines (the adaptive quorum deadline derives
        from them) instead of relearning the cohort from scratch. Monotonic
        ``last_seen`` timestamps are deliberately not exported — they are
        meaningless across a process restart."""
        with self._lock:
            return {
                str(r): {
                    "ewma_s": c.ewma_s,
                    "last_s": c.last_s,
                    "rounds": c.rounds,
                    "consecutive_failures": c.consecutive_failures,
                    "total_failures": c.total_failures,
                    "straggler_rounds": c.straggler_rounds,
                    "flagged": c.flagged,
                }
                for r, c in sorted(self._clients.items())
            }

    def restore_state(self, state: Optional[Dict[str, Any]]) -> None:
        if not state:
            return
        with self._lock:
            for rank_str, d in state.items():
                try:
                    c = self._client(int(rank_str))
                except (TypeError, ValueError):
                    continue
                c.ewma_s = d.get("ewma_s")
                c.last_s = d.get("last_s")
                c.rounds = int(d.get("rounds", 0))
                c.consecutive_failures = int(d.get("consecutive_failures", 0))
                c.total_failures = int(d.get("total_failures", 0))
                c.straggler_rounds = int(d.get("straggler_rounds", 0))
                c.flagged = bool(d.get("flagged", False))

    # --- read side (statusz / metrics / uplink) ----------------------------
    def report(self) -> Optional[HealthReport]:
        """The most recent :meth:`end_round` report (None before round 0)."""
        with self._lock:
            return self._last_report

    def statusz(self) -> Dict[str, Any]:
        with self._lock:
            rep = self._last_report
            return {
                "clients": {
                    str(r): c.as_dict(self.silence_threshold_s)
                    for r, c in sorted(self._clients.items())
                },
                "last_report": dict(rep) if rep is not None else None,
                "thresholds": {
                    "ewma_alpha": self.ewma_alpha,
                    "mad_z": self.mad_z_threshold,
                    "min_gap_s": self.min_gap_s,
                    "silence_s": self.silence_threshold_s,
                },
            }

    def prom_gauges(self) -> List[tuple]:
        """``(name, labels, value)`` triples for ``prom.render(gauges=...)``:
        per-rank ``client_health`` score and ``client_straggler`` 0/1.

        Cardinality-bounded: the family consults the telemetry series budget
        and degrades to NOTHING per-rank when a fleet-scale cohort would blow
        the exposition (the ``fedml_fleet_*`` sketch gauges carry the signal
        instead). Below the budget the output is bit-identical to the
        un-budgeted code."""
        from . import sketches as _sketches

        with self._lock:
            clients = sorted(self._clients.items())
        if not _sketches.get_budget().admit("client_health", 2 * len(clients)):
            return []
        with self._lock:
            out: List[tuple] = []
            for r, c in clients:
                labels = {"rank": str(r)}
                out.append(("client_health", labels, c.score(self.silence_threshold_s)))
                out.append(("client_straggler", labels, 1.0 if c.flagged else 0.0))
            return out
