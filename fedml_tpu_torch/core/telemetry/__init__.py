"""Telemetry: spans, counters, histograms, the time-series store, and the
surfaces a process exposes (Prometheus text, `/statusz`, SLO alerts, the
flight recorder).

Counterpart of ``fedml_tpu/core/telemetry``: ``core``, ``trace_context``,
``sketches`` (the mergeable fleet sketches), ``health``, ``tsdb`` and
``netlink`` (per-pair link accounting, estimators and the link cost model)
are copies of the JAX package's framework-free modules; ``prom``,
``statusz``, ``flight_recorder`` and ``slo`` are copies but for their
server-mesh and mlops parts; ``modelwatch`` (fold-boundary delta
statistics, the contribution ledger, quarantine and the LLM train guard)
computes JAX's statistics in PyTorch on the fold's device; ``devperf`` (the program cost
registry: MFU against the card's peak, the HBM sampler) is JAX's with the
caller's analytic FLOPs in place of XLA's cost analysis; ``fleet`` (the
server's fleet view: client telemetry deltas and their link blocks, the
health tracker, the fleet sketches and their child-tier slots, the fleet
trace with its link flows, modelwatch's ledger) is JAX's. Typical
use::

    from fedml_tpu_torch.core import telemetry as tel

    tel.counter("serving.cb.requests").add(1)
    with tel.timed("serving.cb.chunk") as sp:
        ...
    tel.histogram("serving.cb.ttft_seconds").observe(sp.duration_s)

The link prober is ``core/distributed/link_probe.py``.
"""

from . import devperf, flight_recorder, modelwatch, netlink, prom, sketches, slo, statusz, tsdb
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
from .devperf import CompiledProgramRegistry, HbmSampler
from .fleet import FleetTelemetry
from .flight_recorder import FlightRecorder
from .sketches import (
    CardinalitySketch,
    FleetSketches,
    QuantileSketch,
    TelemetryCardinalityBudget,
    TopK,
)
from .slo import SLOEngine, SLOSpec
from .statusz import StatuszServer
from .trace_context import TraceContext, activated, new_trace_id
from .tsdb import TimeSeriesStore

__all__ = [
    "Telemetry",
    "Counter",
    "Histogram",
    "TimeSeriesStore",
    "CardinalitySketch",
    "CompiledProgramRegistry",
    "FleetSketches",
    "FleetTelemetry",
    "FlightRecorder",
    "HbmSampler",
    "SLOEngine",
    "SLOSpec",
    "StatuszServer",
    "QuantileSketch",
    "TelemetryCardinalityBudget",
    "TopK",
    "TraceContext",
    "activated",
    "new_trace_id",
    "devperf",
    "flight_recorder",
    "modelwatch",
    "prom",
    "sketches",
    "slo",
    "statusz",
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
