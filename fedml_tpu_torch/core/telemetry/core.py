"""Dependency-free tracing + metrics registry.

A copy of ``fedml_tpu/core/telemetry/core.py`` (framework-free): the port's
serving engines count and time through it, under the JAX package's metric
names, so the tests read the same counters on both sides.

One timing idiom for the whole tree: ``span`` for phases (nestable, monotonic
clock, thread-aware), ``counter`` for monotonic totals (bytes moved, compiles),
``histogram`` for value distributions (aggregate seconds, tokens/sec). Spans
export to Chrome-trace / Perfetto JSON (``export_chrome_trace``) and everything
exports to a plain dict (``snapshot``) for programmatic assertion.

Design constraints, in priority order:

- **Disabled path is near-free.** ``span()`` on a disabled registry returns a
  shared no-op handle — no allocation, no clock read (< 1µs).
  Counter/histogram aggregates always update (they are O(1) and feed
  count-based tests that must work regardless of span state);
  only their *timeline events* are gated on ``enabled``.
- **Thread-safe.** One lock guards the record lists; span nesting state is
  thread-local, so concurrent workers (serving gateway, MQTT loops) interleave
  without corrupting each other's parentage.
- **Bounded memory.** Span records and per-counter event series are capped;
  overflow bumps ``dropped`` instead of growing without limit in long runs.

Code that *consumes* the measured duration (tokens/sec, EWMA latency,
runtime-history simulation) uses ``timed()``, which always reads the clock and
exposes ``duration_s`` even when recording is disabled.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "Telemetry",
    "Counter",
    "Histogram",
    "get_telemetry",
    "span",
    "timed",
    "counter",
    "histogram",
    "snapshot",
    "summary",
    "export_chrome_trace",
    "set_enabled",
    "reset",
    "disabled_span_overhead_ns",
]

_ENV_DISABLE = "FEDML_TELEMETRY"  # set to "0" to disable the default registry

MAX_SPAN_RECORDS = 200_000
MAX_COUNTER_EVENTS = 10_000

# Installed by trace_context on import (avoids a circular import; that module
# imports this one). When set, enabled-path span records carry the active
# distributed trace context. The disabled path never touches it.
_trace_ctx_getter: Optional[Callable[[], Any]] = None

# Installed by flight_recorder.install() (same circularity dodge). Signature:
# hook(opened: bool, span: _Span, exc_type) — called on the enabled span path
# only, outside the timed region (before the t0 read / after the t1 read), so
# the recorder never inflates measured durations. The disabled path and the
# no-hook path stay untouched.
_span_event_hook: Optional[Callable[[bool, Any, Any], None]] = None

# Installed by tsdb.install() (same circularity dodge). Signature:
# hook(kind: str, name: str, value: float) — "counter" emissions carry the
# cumulative value after the add, "observe" emissions the raw observation.
# Called OUTSIDE the registry lock so the store's lock stays a leaf (no
# telemetry->tsdb ordering edge); the no-hook path is a None-check.
_metric_sample_hook: Optional[Callable[[str, str, float], None]] = None


class _NullSpan:
    """Shared no-op handle for the disabled path — enter/exit do nothing."""

    __slots__ = ()
    duration_s: Optional[float] = None
    duration_ns: Optional[int] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _json_safe(v: Any) -> Any:
    """Span attrs are arbitrary; the wire is JSON. Pass scalars, repr the rest."""
    return v if isinstance(v, (str, int, float, bool)) or v is None else repr(v)


class _Span:
    """Open-span handle. Created per ``with`` block on the enabled path (and
    always by ``timed()``); records itself into the registry on exit."""

    __slots__ = ("_t", "name", "attrs", "seq", "depth", "parent_seq", "t0_ns", "dur_ns", "_record")

    def __init__(self, t: "Telemetry", name: str, attrs: Dict[str, Any], record: bool):
        self._t = t
        self.name = name
        self.attrs = attrs
        self._record = record
        self.dur_ns: Optional[int] = None

    @property
    def duration_ns(self) -> Optional[int]:
        return self.dur_ns

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.dur_ns is None else self.dur_ns / 1e9

    def __enter__(self):
        t = self._t
        stack = t._stack()
        self.depth = len(stack)
        self.parent_seq = stack[-1].seq if stack else None
        with t._lock:
            t._seq += 1
            self.seq = t._seq
        stack.append(self)
        hook = _span_event_hook
        if hook is not None and t._enabled:
            hook(True, self, None)
        self.t0_ns = time.perf_counter_ns()  # last: exclude bookkeeping
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()  # first: exclude bookkeeping
        self.dur_ns = t1 - self.t0_ns
        t = self._t
        stack = t._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self._record and t._enabled:
            t._record_span(self, exc_type is not None)
        hook = _span_event_hook
        if hook is not None and t._enabled:
            hook(False, self, exc_type)
        return False


class Counter:
    """Monotonic total. ``add`` always updates the value (O(1)); a timeline
    event is kept only while the registry is enabled, for "C" trace rows."""

    __slots__ = ("name", "value", "_t", "events")

    def __init__(self, name: str, t: "Telemetry"):
        self.name = name
        self.value = 0
        self._t = t
        self.events: List[tuple] = []  # (t_ns, value_after)

    def add(self, n: int = 1) -> None:
        t = self._t
        with t._lock:
            self.value += n
            value_after = self.value
            if t._enabled:
                if len(self.events) < MAX_COUNTER_EVENTS:
                    self.events.append((time.perf_counter_ns(), self.value))
                else:
                    t.dropped += 1
                    t.dropped_events += 1
        hook = _metric_sample_hook
        if hook is not None:
            hook("counter", self.name, value_after)


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Streaming aggregate of observed values (count/sum/min/max/last) plus
    fixed-boundary bucket counts (Prometheus-style; seconds-scaled defaults)."""

    __slots__ = ("name", "count", "total", "min", "max", "last", "_t", "buckets", "bucket_counts")

    def __init__(self, name: str, t: "Telemetry", buckets=DEFAULT_BUCKETS):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.last: Optional[float] = None
        self._t = t
        self.buckets = tuple(buckets)
        # per-bucket (non-cumulative) counts; index len(buckets) is +Inf
        self.bucket_counts = [0] * (len(self.buckets) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._t._lock:
            self.count += 1
            self.total += v
            self.last = v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            # Prometheus semantics: bucket le=B counts observations <= B
            self.bucket_counts[bisect.bisect_left(self.buckets, v)] += 1
        hook = _metric_sample_hook
        if hook is not None:
            hook("observe", self.name, v)

    def cumulative_buckets(self) -> List[tuple]:
        """[(le, cumulative_count), ..., (inf, count)] — Prometheus shape."""
        out: List[tuple] = []
        running = 0
        for le, n in zip(self.buckets, self.bucket_counts):
            running += n
            out.append((le, running))
        out.append((float("inf"), running + self.bucket_counts[-1]))
        return out

    def as_dict(self) -> Dict[str, Any]:
        mean = self.total / self.count if self.count else None
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "mean": mean,
            "last": self.last,
        }


class Telemetry:
    """Thread-safe registry of spans, counters, and histograms."""

    def __init__(self, enabled: bool = True, max_span_records: int = MAX_SPAN_RECORDS):
        self._enabled = bool(enabled)
        self._lock = threading.RLock()
        self._tls = threading.local()
        self._seq = 0
        self._epoch_ns = time.perf_counter_ns()
        self._spans: List[Dict[str, Any]] = []
        self._span_stats: Dict[str, List[float]] = {}  # name -> [count, total_ns, max_ns]
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._thread_names: Dict[int, str] = {}
        self.max_span_records = int(max_span_records)
        # `dropped` is the historical total; the per-kind splits feed the
        # labeled fedml_telemetry_dropped_total{kind=...} Prometheus family
        self.dropped = 0
        self.dropped_spans = 0
        self.dropped_events = 0

    # --- state ------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    def reset(self) -> None:
        """Drop all recorded data (enabled state is kept). Open spans keep
        working — only their already-recorded siblings are discarded."""
        with self._lock:
            self._spans.clear()
            self._span_stats.clear()
            self._counters.clear()
            self._histograms.clear()
            self._thread_names.clear()
            self.dropped = 0
            self.dropped_spans = 0
            self.dropped_events = 0
            self._epoch_ns = time.perf_counter_ns()

    def _stack(self) -> List[_Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # --- instruments ------------------------------------------------------
    def span(self, name: str, **attrs):
        """Nestable monotonic-clock span; no-op handle when disabled."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs, record=True)

    def timed(self, name: str, **attrs) -> _Span:
        """Span that ALWAYS measures (``duration_s`` is valid after exit) but
        only records when enabled — for call sites that consume the value."""
        return _Span(self, name, attrs, record=True)

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self)
            return c

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, self)
            return h

    def _record_span(self, sp: _Span, errored: bool) -> None:
        tid = threading.get_ident()
        rec = {
            "name": sp.name,
            "seq": sp.seq,
            "parent_seq": sp.parent_seq,
            "depth": sp.depth,
            "t0_ns": sp.t0_ns - self._epoch_ns,
            "dur_ns": sp.dur_ns,
            "tid": tid,
        }
        if sp.attrs:
            rec["attrs"] = sp.attrs
        if errored:
            rec["error"] = True
        getter = _trace_ctx_getter
        if getter is not None:
            ctx = getter()
            if ctx is not None:
                rec["trace_id"] = ctx.trace_id
                if ctx.parent_span_id is not None:
                    rec["trace_parent"] = ctx.parent_span_id
                if ctx.round_idx is not None:
                    rec["trace_round"] = ctx.round_idx
        with self._lock:
            self._thread_names.setdefault(tid, threading.current_thread().name)
            st = self._span_stats.get(sp.name)
            if st is None:
                st = self._span_stats[sp.name] = [0, 0.0, 0.0]
            st[0] += 1
            st[1] += sp.dur_ns
            if sp.dur_ns > st[2]:
                st[2] = sp.dur_ns
            if len(self._spans) < self.max_span_records:
                self._spans.append(rec)
            else:
                self.dropped += 1
                self.dropped_spans += 1

    def dropped_kinds(self) -> Dict[str, int]:
        """Per-kind drop counts for the labeled Prometheus export. The
        recorder ring's own count is appended by the caller (prom.render)
        because the flight recorder lives above this registry."""
        with self._lock:
            return {
                "span_records": self.dropped_spans,
                "counter_events": self.dropped_events,
            }

    # --- export -----------------------------------------------------------
    def epoch_unix_ns(self) -> int:
        """Wall-clock estimate of this registry's epoch (the perf-counter
        origin all span timestamps are relative to). Lets a fleet exporter
        align lanes from registries with different epochs."""
        return time.time_ns() - (time.perf_counter_ns() - self._epoch_ns)

    def delta_snapshot(self, cursor: int = 0, tid: Optional[int] = None) -> Dict[str, Any]:
        """Compact, JSON-safe snapshot of activity since ``cursor`` (a span
        ``seq``); ship it over the wire each round and advance the cursor to
        the returned ``"cursor"``. ``tid`` filters spans to one thread so an
        in-process simulation ships only its own lane."""
        with self._lock:
            spans = [
                r for r in self._spans
                if r["seq"] > cursor and (tid is None or r["tid"] == tid)
            ]
            spans.sort(key=lambda r: r["seq"])
            out_spans = []
            for r in spans:
                rec = dict(r)
                if "attrs" in rec:
                    rec["attrs"] = {k: _json_safe(v) for k, v in rec["attrs"].items()}
                out_spans.append(rec)
            return {
                "cursor": self._seq,
                "epoch_unix_ns": self.epoch_unix_ns(),
                "spans": out_spans,
                "counters": {k: c.value for k, c in self._counters.items()},
                "histograms": {k: h.as_dict() for k, h in self._histograms.items()},
                "span_stats": {
                    k: {"count": int(v[0]), "total_ms": v[1] / 1e6, "max_ms": v[2] / 1e6}
                    for k, v in self._span_stats.items()
                },
                "thread_names": {str(k): v for k, v in self._thread_names.items()},
                "dropped": self.dropped,
            }

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view for programmatic assertion. Spans are in START
        order (``seq`` is assigned at entry), with parentage + depth."""
        with self._lock:
            spans = sorted(self._spans, key=lambda r: r["seq"])
            return {
                "spans": [dict(r) for r in spans],
                "counters": {k: c.value for k, c in self._counters.items()},
                "histograms": {k: h.as_dict() for k, h in self._histograms.items()},
                "span_stats": {
                    k: {"count": int(v[0]), "total_ms": v[1] / 1e6, "max_ms": v[2] / 1e6}
                    for k, v in self._span_stats.items()
                },
                "dropped": self.dropped,
            }

    def summary(self) -> Dict[str, Any]:
        """Compact cumulative roll-up (no per-span records) — small enough to
        publish through the mlops uplink every round."""
        snap = self.snapshot()
        return {
            "span_stats": snap["span_stats"],
            "counters": snap["counters"],
            "histograms": snap["histograms"],
            "dropped": snap["dropped"],
        }

    def export_chrome_trace(self, path: str, merge: bool = False) -> str:
        """Write Chrome-trace/Perfetto JSON (object form with ``traceEvents``;
        "X" complete events for spans, "C" series for counters, "M" metadata
        rows naming process and threads). Returns ``path``.

        ``merge=True`` prepends the ``traceEvents`` already in ``path`` (if it
        holds valid trace JSON) so repeated exports — e.g. multi-stage bench
        runs — accumulate instead of overwrite. A corrupt existing file is
        overwritten."""
        prior_events: List[Dict[str, Any]] = []
        if merge and os.path.exists(path):
            try:
                with open(path) as f:
                    prior = json.load(f)
                prior_events = list(prior.get("traceEvents", [])) if isinstance(prior, dict) else []
            except (OSError, ValueError):
                prior_events = []
        pid = os.getpid()
        with self._lock:
            spans = sorted(self._spans, key=lambda r: r["seq"])
            counter_series = {k: list(c.events) for k, c in self._counters.items() if c.events}
            thread_names = dict(self._thread_names)
        events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": "fedml_tpu_torch"}},
        ]
        for tid, tname in thread_names.items():
            events.append(
                {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": tname}}
            )
        for r in spans:
            ev = {
                "ph": "X",
                "name": r["name"],
                "ts": r["t0_ns"] / 1e3,  # Chrome trace wants microseconds
                "dur": r["dur_ns"] / 1e3,
                "pid": pid,
                "tid": r["tid"],
            }
            args = dict(r.get("attrs") or {})
            args["seq"] = r["seq"]
            if r.get("error"):
                args["error"] = True
            for k in ("trace_id", "trace_parent", "trace_round"):
                if k in r:
                    args[k] = r[k]
            ev["args"] = args
            events.append(ev)
        for name, series in counter_series.items():
            for t_ns, value in series:
                events.append(
                    {
                        "ph": "C",
                        "name": name,
                        "ts": (t_ns - self._epoch_ns) / 1e3,
                        "pid": pid,
                        "tid": 0,
                        "args": {"value": value},
                    }
                )
        doc = {"traceEvents": prior_events + events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


# --- process-wide default registry ------------------------------------------
_DEFAULT = Telemetry(enabled=os.environ.get(_ENV_DISABLE, "1") != "0")


def get_telemetry() -> Telemetry:
    return _DEFAULT


def span(name: str, **attrs):
    """Module-level fast path: one flag check + shared handle when disabled."""
    t = _DEFAULT
    if not t._enabled:
        return _NULL_SPAN
    return _Span(t, name, attrs, record=True)


def timed(name: str, **attrs) -> _Span:
    return _DEFAULT.timed(name, **attrs)


def counter(name: str) -> Counter:
    return _DEFAULT.counter(name)


def histogram(name: str) -> Histogram:
    return _DEFAULT.histogram(name)


def snapshot() -> Dict[str, Any]:
    return _DEFAULT.snapshot()


def summary() -> Dict[str, Any]:
    return _DEFAULT.summary()


def export_chrome_trace(path: str, merge: bool = False) -> str:
    return _DEFAULT.export_chrome_trace(path, merge=merge)


def set_enabled(on: bool) -> None:
    _DEFAULT.set_enabled(on)


def reset() -> None:
    _DEFAULT.reset()


def disabled_span_overhead_ns(iters: int = 2000, batches: int = 5) -> float:
    """Per-call cost of ``span()`` on the disabled path, in ns.

    Minimum over several batches so scheduler noise cannot inflate the
    number."""
    t = _DEFAULT
    was = t._enabled
    t.set_enabled(False)
    try:
        best = float("inf")
        for _ in range(batches):
            t0 = time.perf_counter_ns()
            for _ in range(iters):
                with span("overhead.probe"):
                    pass
            per_call = (time.perf_counter_ns() - t0) / iters
            if per_call < best:
                best = per_call
        return best
    finally:
        t.set_enabled(was)
