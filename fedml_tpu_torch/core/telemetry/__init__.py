"""Telemetry: spans, counters, histograms and the time-series store.

Counterpart of ``fedml_tpu/core/telemetry``: ``core`` and ``trace_context``
are copies of the JAX package's framework-free modules, ``health`` a copy
but for its ``/metrics`` gauges, ``fleet`` (the server's fleet view: client
telemetry deltas, the health tracker, the fleet trace) the part of JAX's
that health and the fleet trace need, ``tsdb`` the part of its store that
serving reads. Typical use::

    from fedml_tpu_torch.core import telemetry as tel

    tel.counter("serving.cb.requests").add(1)
    with tel.timed("serving.cb.chunk") as sp:
        ...
    tel.histogram("serving.cb.ttft_seconds").observe(sp.duration_s)

The rest of the JAX package's telemetry (``devperf``'s compiled-program
costs, the flight recorder, the fleet sketches, netlink, modelwatch, SLOs,
Prometheus and statusz) waits for the port's telemetry slice (ROADMAP.md, Queue 1).
"""

from . import tsdb
from .core import (
    Counter,
    Histogram,
    Telemetry,
    counter,
    disabled_span_overhead_ns,
    export_chrome_trace,
    get_telemetry,
    histogram,
    reset,
    set_enabled,
    snapshot,
    span,
    summary,
    timed,
)
from .tsdb import TimeSeriesStore

__all__ = [
    "Telemetry",
    "Counter",
    "Histogram",
    "TimeSeriesStore",
    "counter",
    "disabled_span_overhead_ns",
    "export_chrome_trace",
    "get_telemetry",
    "histogram",
    "reset",
    "set_enabled",
    "snapshot",
    "span",
    "summary",
    "timed",
    "tsdb",
]
