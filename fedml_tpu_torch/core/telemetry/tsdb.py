"""Bounded in-process time-series store: metric *history* for SLO queries.

The part of ``fedml_tpu/core/telemetry/tsdb.py`` (framework-free) that the
serving path reads, copied: the admission controller reads windowed
quantiles from the active store, and the paged engine records per-tenant
TTFT into it. The registry (``core.py``) keeps instantaneous aggregates;
this store keeps per-series bounded rings of ``(t, value)`` samples, fed
from every counter/histogram emission through ``core._metric_sample_hook``
once a store is installed. Counter samples closer together than
``resolution_s`` coalesce in place; histogram observations never do, and
``quantile(series, q, window)`` runs over the raw values. The JAX module's
other queries (rate, avg, max, delta), glob and Prometheus-name series
resolution, gauge collectors and statusz wait for the port's telemetry
slice (ROADMAP.md, item 16).

Lock discipline: the store's lock is a leaf — nothing is called while it is
held, and the ingest hook runs *outside* the telemetry registry's lock, so
no ordering edge ``telemetry -> tsdb`` ever forms.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from . import core as _core

__all__ = [
    "SeriesRing",
    "TimeSeriesStore",
    "install",
    "uninstall",
    "active",
    "reset",
]

DEFAULT_CAPACITY = 1024
DEFAULT_RESOLUTION_S = 0.5

KIND_COUNTER = "counter"
KIND_OBS = "obs"


class SeriesRing:
    """One bounded series: a manual ring of (t, value) pairs, oldest
    overwritten first."""

    __slots__ = ("name", "kind", "capacity", "resolution_s",
                 "_t", "_v", "_next", "_count")

    def __init__(self, name: str, kind: str, capacity: int, resolution_s: float):
        self.name = name
        self.kind = kind
        self.capacity = max(int(capacity), 2)
        self.resolution_s = float(resolution_s)
        self._t: List[float] = [0.0] * self.capacity
        self._v: List[float] = [0.0] * self.capacity
        self._next = 0
        self._count = 0

    def append(self, t: float, v: float) -> None:
        # counters coalesce: a sample inside the last bucket replaces
        # its VALUE in place (last-write-wins) while the bucket keeps its
        # anchor time — a sliding anchor would merge a hot counter's entire
        # history into one sample instead of one sample per resolution_s
        if (self.kind != KIND_OBS and self._count
                and t - self._t[(self._next - 1) % self.capacity] < self.resolution_s):
            self._v[(self._next - 1) % self.capacity] = v
            return
        self._count = min(self._count + 1, self.capacity)
        self._t[self._next] = t
        self._v[self._next] = v
        self._next = (self._next + 1) % self.capacity

    def window(self, window_s: float, now: float) -> List[Tuple[float, float]]:
        """Samples with ``lo <= t <= now``, oldest first. Appends are
        time-ordered, so walk backward from the newest sample and stop at
        the first one older than the window — the evaluator pays for the
        samples it reads, not the ring capacity."""
        lo = now - float(window_s)
        out: List[Tuple[float, float]] = []
        for i in range(self._count):
            j = (self._next - 1 - i) % self.capacity
            t = self._t[j]
            if t < lo:
                break
            if t <= now:
                out.append((t, self._v[j]))
        out.reverse()
        return out


class TimeSeriesStore:
    """The store: named series + windowed quantiles."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 resolution_s: float = DEFAULT_RESOLUTION_S):
        self.capacity = int(capacity)
        self.resolution_s = float(resolution_s)
        self._lock = threading.Lock()  # leaf lock: nothing called while held
        self._series: Dict[str, SeriesRing] = {}

    # --- ingestion --------------------------------------------------------
    def _record(self, kind: str, name: str, value: float,
                t: Optional[float] = None) -> None:
        if t is None:
            t = time.monotonic()
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                ring = self._series[name] = SeriesRing(
                    name, kind, self.capacity, self.resolution_s)
            ring.append(float(t), float(value))

    def record_observation(self, name: str, value: float,
                           t: Optional[float] = None) -> None:
        self._record(KIND_OBS, name, value, t)

    def on_metric(self, kind: str, name: str, value: float) -> None:
        """The ``core._metric_sample_hook`` target: counter emissions carry
        the cumulative value after the add, histogram emissions the raw
        observation. Runs outside the registry lock; never raises."""
        try:
            if kind == "counter":
                self._record(KIND_COUNTER, name, value)
            else:
                self._record(KIND_OBS, name, value)
        except Exception:  # noqa: BLE001 - history must not break the emitter
            pass

    # --- windowed queries -------------------------------------------------
    def quantile(self, series: str, q: float, window_s: float,
                 now: Optional[float] = None) -> Optional[float]:
        """Linear-interpolation quantile over the window's raw observations
        (numpy's default method — the reference tests diff against it)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            ring = self._series.get(series)
            values = ([v for _t, v in ring.window(window_s, now)]
                      if ring is not None and ring.kind == KIND_OBS else [])
        if not values:
            return None
        values.sort()
        q = min(max(float(q), 0.0), 1.0)
        pos = q * (len(values) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(values) - 1)
        return values[lo] + (values[hi] - values[lo]) * (pos - lo)


# --- process-wide active store (refcounted, flight-recorder idiom) -----------
_ACTIVE: Optional[TimeSeriesStore] = None
_install_lock = threading.Lock()
_install_depth = 0


def active() -> Optional[TimeSeriesStore]:
    return _ACTIVE


def install(store: Optional[TimeSeriesStore] = None) -> TimeSeriesStore:
    """Activate a process-wide store and hook it into every counter add /
    histogram observe via ``core._metric_sample_hook``. Idempotent and
    refcounted; :func:`uninstall` unhooks when the last install exits."""
    global _ACTIVE, _install_depth
    with _install_lock:
        _install_depth += 1
        if _ACTIVE is None:
            _ACTIVE = store or TimeSeriesStore()
            _core._metric_sample_hook = _ACTIVE.on_metric
        return _ACTIVE


def uninstall() -> None:
    global _ACTIVE, _install_depth
    with _install_lock:
        if _install_depth == 0:
            return
        _install_depth -= 1
        if _install_depth > 0:
            return
        _core._metric_sample_hook = None
        _ACTIVE = None


def reset() -> None:
    """Force-drop the active store regardless of refcount (tests)."""
    global _ACTIVE, _install_depth
    with _install_lock:
        _core._metric_sample_hook = None
        _ACTIVE = None
        _install_depth = 0
