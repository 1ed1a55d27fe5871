"""Telemetry: spans, counters, histograms and the time-series store.

Counterpart of ``fedml_tpu/core/telemetry``: ``core``, ``trace_context``
and ``sketches`` (the mergeable fleet sketches) are copies of the JAX
package's framework-free modules, ``health`` a copy but for its
``/metrics`` gauges, ``fleet`` (the server's fleet view: client telemetry
deltas, the health tracker, the fleet sketches and their child-tier slots,
the fleet trace) JAX's but for modelwatch's ledger and netlink, ``tsdb``
the part of its store that serving reads. Typical use::

    from fedml_tpu_torch.core import telemetry as tel

    tel.counter("serving.cb.requests").add(1)
    with tel.timed("serving.cb.chunk") as sp:
        ...
    tel.histogram("serving.cb.ttft_seconds").observe(sp.duration_s)

The rest of the JAX package's telemetry (``devperf``'s compiled-program
costs, the flight recorder, netlink, modelwatch, SLOs, Prometheus and
statusz) waits for the port's telemetry slice (ROADMAP.md, Queue 1).
"""

from . import sketches, tsdb
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
from .fleet import FleetTelemetry
from .sketches import (
    CardinalitySketch,
    FleetSketches,
    QuantileSketch,
    TelemetryCardinalityBudget,
    TopK,
)
from .trace_context import TraceContext, activated, new_trace_id
from .tsdb import TimeSeriesStore

__all__ = [
    "Telemetry",
    "Counter",
    "Histogram",
    "TimeSeriesStore",
    "CardinalitySketch",
    "FleetSketches",
    "FleetTelemetry",
    "QuantileSketch",
    "TelemetryCardinalityBudget",
    "TopK",
    "TraceContext",
    "activated",
    "new_trace_id",
    "sketches",
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
