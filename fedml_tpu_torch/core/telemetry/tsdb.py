"""Bounded in-process time-series store: metric *history* for SLO queries.

A copy of ``fedml_tpu/core/telemetry/tsdb.py`` (framework-free): the SLO
engine (``slo.py``) evaluates its windows here, the admission controller
reads windowed quantiles from it, and the paged engine records per-tenant
TTFT into it.

The telemetry registry (``core.py``) keeps instantaneous aggregates — a
counter is one number, a histogram one set of buckets. Nothing retains
*when* the values moved, so there is no ``rate()``, no windowed quantile,
and no "is this degrading?" signal. This module adds exactly that, the way
an embedded TSDB ring does: per-series bounded rings of ``(t, value)``
samples, fed automatically from every counter/histogram emission via a
module-global hook in ``core.py`` (the ``_span_event_hook`` circularity
dodge), plus pull-side *collectors* for gauge-shaped registries (netlink
link stats, cohort health) that have no emission to hook.

Three sample kinds, matching how each query is defined:

- ``counter``  — cumulative values; ``rate(series, window)`` differences the
  window's first/last samples. Samples closer together than ``resolution_s``
  coalesce in place (last-write-wins per bucket), so a counter bumped a
  million times an hour still spans the slow window inside one ring.
- ``obs``      — raw histogram observations, never coalesced;
  ``quantile(series, q, window)`` runs over the raw values.
- ``gauge``    — sampled levels (collector-fed); ``avg/max/delta`` windows.

Lock discipline: the store's lock is a leaf — nothing is called while it is
held, and the ingest hook runs *outside* the telemetry registry's lock, so
no ordering edge ``telemetry -> tsdb`` ever forms.

The store accumulates its own ``ingest_ns`` (reported on `/statusz`), so
the price of ingest is measured, not estimated.
"""

from __future__ import annotations

import fnmatch
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import core as _core

__all__ = [
    "SeriesRing",
    "TimeSeriesStore",
    "install",
    "uninstall",
    "active",
    "reset",
]

_ENV_CAPACITY = "FEDML_TSDB_CAPACITY"        # samples per series
_ENV_RESOLUTION = "FEDML_TSDB_RESOLUTION_S"  # coalescing bucket width

DEFAULT_CAPACITY = 1024
DEFAULT_RESOLUTION_S = 0.5

KIND_COUNTER = "counter"
KIND_OBS = "obs"
KIND_GAUGE = "gauge"


def _canon_prom(name: str) -> str:
    """The prom.py name transform, so SLO specs may name a series by its
    exported ``fedml_*`` family (e.g. ``fedml_link_loss_ratio``)."""
    return "fedml_" + re.sub(r"[^A-Za-z0-9_]", "_", name)


class SeriesRing:
    """One bounded series: a manual ring of (t, value) pairs, oldest
    overwritten first (and counted as a drop, never silently)."""

    __slots__ = ("name", "kind", "capacity", "resolution_s",
                 "_t", "_v", "_next", "_count", "dropped")

    def __init__(self, name: str, kind: str, capacity: int, resolution_s: float):
        self.name = name
        self.kind = kind
        self.capacity = max(int(capacity), 2)
        self.resolution_s = float(resolution_s)
        self._t: List[float] = [0.0] * self.capacity
        self._v: List[float] = [0.0] * self.capacity
        self._next = 0
        self._count = 0
        self.dropped = 0

    def append(self, t: float, v: float) -> None:
        # counters/gauges coalesce: a sample inside the last bucket replaces
        # its VALUE in place (last-write-wins) while the bucket keeps its
        # anchor time — a sliding anchor would merge a hot counter's entire
        # history into one sample instead of one sample per resolution_s
        if (self.kind != KIND_OBS and self._count
                and t - self._t[(self._next - 1) % self.capacity] < self.resolution_s):
            self._v[(self._next - 1) % self.capacity] = v
            return
        if self._count >= self.capacity:
            self.dropped += 1  # overwrote the oldest sample
        else:
            self._count += 1
        self._t[self._next] = t
        self._v[self._next] = v
        self._next = (self._next + 1) % self.capacity

    def samples(self) -> List[Tuple[float, float]]:
        """Ring contents, oldest first."""
        if self._count < self.capacity:
            idx = range(self._count)
        else:
            idx = [(self._next + i) % self.capacity for i in range(self.capacity)]
        return [(self._t[i], self._v[i]) for i in idx]

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

    def __len__(self) -> int:
        return self._count


class TimeSeriesStore:
    """The store: named series + windowed queries + pull-side collectors."""

    def __init__(self, capacity: Optional[int] = None,
                 resolution_s: Optional[float] = None):
        if capacity is None:
            capacity = int(os.environ.get(_ENV_CAPACITY, DEFAULT_CAPACITY))
        if resolution_s is None:
            resolution_s = float(os.environ.get(_ENV_RESOLUTION, DEFAULT_RESOLUTION_S))
        self.capacity = int(capacity)
        self.resolution_s = float(resolution_s)
        self._lock = threading.Lock()  # leaf lock: nothing called while held
        self._series: Dict[str, SeriesRing] = {}
        self._collectors: List[Callable[["TimeSeriesStore"], None]] = []
        self.ingest_ns = 0          # cumulative time inside _record (hook path)
        self.samples_total = 0

    # --- ingestion --------------------------------------------------------
    def _record(self, kind: str, name: str, value: float,
                t: Optional[float] = None) -> None:
        t0 = time.perf_counter_ns()
        if t is None:
            t = time.monotonic()
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                ring = self._series[name] = SeriesRing(
                    name, kind, self.capacity, self.resolution_s)
            ring.append(float(t), float(value))
            self.samples_total += 1
            self.ingest_ns += time.perf_counter_ns() - t0

    def record_counter(self, name: str, cumulative: float,
                       t: Optional[float] = None) -> None:
        self._record(KIND_COUNTER, name, cumulative, t)

    def record_observation(self, name: str, value: float,
                           t: Optional[float] = None) -> None:
        self._record(KIND_OBS, name, value, t)

    def record_gauge(self, name: str, value: float,
                     t: Optional[float] = None) -> None:
        self._record(KIND_GAUGE, name, value, t)

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

    # --- collectors (pull-side feeds: netlink, health, engine stats) ------
    def add_collector(self, fn: Callable[["TimeSeriesStore"], None]) -> None:
        """Register a gauge feed: ``fn(store)`` calls ``record_gauge`` for
        whatever levels it samples, at each :meth:`collect` (the SLO
        evaluator tick calls it). Taking the store keeps the series-name
        literals at the call sites."""
        with self._lock:
            self._collectors.append(fn)

    def collect(self, now: Optional[float] = None) -> None:  # noqa: ARG002 - now reserved for replay feeds
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 - a broken feed must not stop the tick
                pass

    # --- series resolution ------------------------------------------------
    def resolve(self, series: str) -> List[SeriesRing]:
        """Rings matching ``series``: exact name, glob (``comm.retry.*``),
        or the exported ``fedml_*`` family name of any stored series."""
        with self._lock:
            ring = self._series.get(series)
            if ring is not None:
                return [ring]
            if any(ch in series for ch in "*?["):
                return [r for n, r in sorted(self._series.items())
                        if fnmatch.fnmatch(n, series)]
            if series.startswith("fedml_"):
                out = []
                for n, r in sorted(self._series.items()):
                    canon = _canon_prom(n)
                    if series in (canon, canon + "_total"):
                        out.append(r)
                return out
            return []

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    # --- windowed queries -------------------------------------------------
    def rate(self, series: str, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second increase of a cumulative series over the window:
        ``(v_last - v_first) / (t_last - t_first)`` across in-window samples
        (summed over glob matches). None with <2 samples or on a reset."""
        if now is None:
            now = time.monotonic()
        total: Optional[float] = None
        with self._lock:
            rings = self._resolve_locked(series)
            windows = [r.window(window_s, now) for r in rings
                       if r.kind == KIND_COUNTER]
        for pts in windows:
            if len(pts) < 2:
                continue
            dt = pts[-1][0] - pts[0][0]
            dv = pts[-1][1] - pts[0][1]
            if dt <= 0 or dv < 0:  # dv<0: registry reset mid-window
                continue
            total = (total or 0.0) + dv / dt
        return total

    def quantile(self, series: str, q: float, window_s: float,
                 now: Optional[float] = None) -> Optional[float]:
        """Linear-interpolation quantile over the window's raw observations
        (numpy's default method — the reference tests diff against it)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            rings = self._resolve_locked(series)
            values = [v for r in rings if r.kind == KIND_OBS
                      for _t, v in r.window(window_s, now)]
        if not values:
            return None
        values.sort()
        q = min(max(float(q), 0.0), 1.0)
        pos = q * (len(values) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(values) - 1)
        return values[lo] + (values[hi] - values[lo]) * (pos - lo)

    def avg(self, series: str, window_s: float,
            now: Optional[float] = None) -> Optional[float]:
        vals = self._window_values(series, window_s, now)
        return sum(vals) / len(vals) if vals else None

    def max(self, series: str, window_s: float,
            now: Optional[float] = None) -> Optional[float]:
        vals = self._window_values(series, window_s, now)
        return max(vals) if vals else None

    def delta(self, series: str, window_s: float,
              now: Optional[float] = None) -> Optional[float]:
        """``v_last - v_first`` over the window (summed over matches)."""
        if now is None:
            now = time.monotonic()
        total: Optional[float] = None
        with self._lock:
            rings = self._resolve_locked(series)
            windows = [r.window(window_s, now) for r in rings]
        for pts in windows:
            if len(pts) < 2:
                continue
            total = (total or 0.0) + (pts[-1][1] - pts[0][1])
        return total

    def last(self, series: str) -> Optional[float]:
        with self._lock:
            rings = self._resolve_locked(series)
            vals = [r.samples()[-1][1] for r in rings if len(r)]
        return vals[-1] if vals else None

    def _window_values(self, series: str, window_s: float,
                       now: Optional[float]) -> List[float]:
        if now is None:
            now = time.monotonic()
        with self._lock:
            rings = self._resolve_locked(series)
            return [v for r in rings for _t, v in r.window(window_s, now)]

    def _resolve_locked(self, series: str) -> List[SeriesRing]:
        # resolve() body inlined under the already-held lock
        ring = self._series.get(series)
        if ring is not None:
            return [ring]
        if any(ch in series for ch in "*?["):
            return [r for n, r in sorted(self._series.items())
                    if fnmatch.fnmatch(n, series)]
        if series.startswith("fedml_"):
            out = []
            for n, r in sorted(self._series.items()):
                canon = _canon_prom(n)
                if series in (canon, canon + "_total"):
                    out.append(r)
            return out
        return []

    # --- introspection ----------------------------------------------------
    def statusz(self) -> Dict[str, Any]:
        with self._lock:
            dropped = sum(r.dropped for r in self._series.values())
            return {
                "series": len(self._series),
                "samples_total": self.samples_total,
                "dropped": dropped,
                "capacity_per_series": self.capacity,
                "resolution_s": self.resolution_s,
                "ingest_ms": round(self.ingest_ns / 1e6, 3),
                "collectors": len(self._collectors),
            }


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
