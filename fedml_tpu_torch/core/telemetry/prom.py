"""Prometheus text-exposition encoder for the telemetry registry.

A copy of ``fedml_tpu/core/telemetry/prom.py`` (framework-free), rendering
byte for byte what the JAX module renders for the same registry. The
``jax.compiles.`` family keeps its rendering rule under this module's own
``COMPILE_COUNTER_PREFIX`` (the port traces nothing, so nothing counts
there unless a caller does). The JAX module's optional ride-along gauges
of the server mesh are left out until the mesh is ported (ROADMAP.md,
Queue 1); netlink's per-pair link gauges, the SLO engine's, devperf's and
the fleet sketches' ride along as in JAX.

Dependency-free (no ``prometheus_client``): renders the 0.0.4 text format
from a ``Telemetry`` registry so the serving layer can expose ``GET /metrics``
from either the FastAPI app or the stdlib HTTP runner.

Mapping:

- ``counter("a.b")``            → ``fedml_a_b_total`` (TYPE counter)
- ``counter("jax.compiles.f")`` → ``fedml_jax_compiles_total{fn="f"}`` — the
  per-function compile counters collapse into one labeled family
- ``counter("comm.retry.grpc")`` → ``fedml_comm_retry_total{backend="grpc"}``
  — the resilience retry counters collapse the same way
- ``histogram("x_seconds")``    → ``fedml_x_seconds_bucket{le=...}`` cumulative
  buckets + ``_sum`` + ``_count`` (TYPE histogram)
- span stats                    → ``fedml_span_seconds_total{span=...}`` and
  ``fedml_span_count_total{span=...}``
- caller gauges                 → TYPE gauge (replica state, readiness, ...)

QPS is not exported directly — scrape ``fedml_serving_request_seconds_count``
and let PromQL ``rate()`` do it, as is idiomatic.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .core import Telemetry, get_telemetry

# the JAX package's per-function trace counters (its jax_hooks module)
COMPILE_COUNTER_PREFIX = "jax.compiles."

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

NAMESPACE = "fedml"

# (name, labels, value) triple; labels may be None
Gauge = Tuple[str, Optional[Dict[str, str]], float]

# Registered counter prefix families: counters named "<prefix><v1>.<v2>..."
# collapse into ONE labeled family fedml_<prefix>_total{l1="v1",l2="v2"}.
# This generalizes the hard-wired jax.compiles./comm.retry. collapses so any
# subsystem can mint a bounded-cardinality labeled counter without growing
# this module (admission rejects were the forcing case: {tenant=,reason=}).
# prefix -> (label names, help text); the LAST dot-separated fields map to
# the labels right-to-left, so only the FIRST label's values may contain
# dots (tenant ids do; reason vocabularies must not).
_PREFIX_FAMILIES: Dict[str, Tuple[Tuple[str, ...], str]] = {}


def register_prefix_family(prefix: str, labels: Tuple[str, ...],
                           help_text: str) -> None:
    """Idempotent: re-registering the same prefix overwrites in place."""
    if not prefix.endswith("."):
        raise ValueError(f"prefix family must end with '.', got {prefix!r}")
    if not labels:
        raise ValueError("prefix family needs at least one label")
    _PREFIX_FAMILIES[prefix] = (tuple(labels), str(help_text))


def _split_family_rest(rest: str, labels: Tuple[str, ...]) -> Dict[str, str]:
    parts = rest.rsplit(".", len(labels) - 1)
    while len(parts) < len(labels):
        parts.append("unknown")  # malformed emission: surface, don't drop
    return dict(zip(labels, parts))


def escape_label_value(v: str) -> str:
    """Label values escape backslash, double-quote, and newline (spec order:
    backslash first so later escapes are not double-escaped)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def escape_help(s: str) -> str:
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


def sanitize_metric_name(name: str) -> str:
    """Metric names are ``[a-zA-Z_:][a-zA-Z0-9_:]*``; everything else → ``_``."""
    out = []
    for i, ch in enumerate(name):
        if ch.isascii() and (ch.isalpha() or ch == "_" or ch == ":" or (ch.isdigit() and i > 0)):
            out.append(ch)
        else:
            out.append("_")
    return "".join(out) or "_"


def format_value(v: float) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if math.isnan(v):
            return "NaN"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
    return str(v)


def _labels_str(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{sanitize_metric_name(k)}="{escape_label_value(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


def _fam(name: str, suffix: str = "") -> str:
    return sanitize_metric_name(f"{NAMESPACE}_{name}{suffix}")


def render(telemetry: Optional[Telemetry] = None,
           gauges: Optional[Iterable[Gauge]] = None) -> str:
    """Render the registry (and optional caller-supplied gauges) as
    Prometheus 0.0.4 text. Always ends with a trailing newline."""
    t = telemetry or get_telemetry()
    snap = t.summary()
    lines: List[str] = []

    # --- counters --------------------------------------------------------
    from ..resilience.retry import RETRY_COUNTER_PREFIX

    compiles: Dict[str, int] = {}
    retries: Dict[str, int] = {}
    plain: Dict[str, int] = {}
    families: Dict[str, List[Tuple[Dict[str, str], int]]] = {}
    for name, value in sorted(snap["counters"].items()):
        if name.startswith(COMPILE_COUNTER_PREFIX):
            compiles[name[len(COMPILE_COUNTER_PREFIX):]] = value
        elif name.startswith(RETRY_COUNTER_PREFIX):
            retries[name[len(RETRY_COUNTER_PREFIX):]] = value
        else:
            for prefix, (labels, _help) in _PREFIX_FAMILIES.items():
                if name.startswith(prefix) and len(name) > len(prefix):
                    families.setdefault(prefix, []).append(
                        (_split_family_rest(name[len(prefix):], labels), value))
                    break
            else:
                plain[name] = value
    if compiles:
        fam = _fam("jax_compiles", "_total")
        lines.append(f"# HELP {fam} jit trace count per tracked function")
        lines.append(f"# TYPE {fam} counter")
        for fn, value in sorted(compiles.items()):
            lines.append(f'{fam}{{fn="{escape_label_value(fn)}"}} {format_value(value)}')
    if retries:
        fam = _fam("comm_retry", "_total")
        lines.append(f"# HELP {fam} comm send retries per backend")
        lines.append(f"# TYPE {fam} counter")
        for backend, value in sorted(retries.items()):
            lines.append(f'{fam}{{backend="{escape_label_value(backend)}"}} {format_value(value)}')
    for prefix in sorted(families):
        labels, help_text = _PREFIX_FAMILIES[prefix]
        fam = _fam(prefix[:-1], "_total")
        lines.append(f"# HELP {fam} {escape_help(help_text)}")
        lines.append(f"# TYPE {fam} counter")
        for label_map, value in families[prefix]:
            lines.append(f"{fam}{_labels_str(label_map)} {format_value(value)}")
    for name, value in plain.items():
        fam = _fam(name, "_total")
        lines.append(f"# HELP {fam} telemetry counter {escape_help(name)}")
        lines.append(f"# TYPE {fam} counter")
        lines.append(f"{fam} {format_value(value)}")

    # --- histograms ------------------------------------------------------
    for name in sorted(snap["histograms"]):
        h = t.histogram(name)
        fam = _fam(name)
        lines.append(f"# HELP {fam} telemetry histogram {escape_help(name)}")
        lines.append(f"# TYPE {fam} histogram")
        for le, cum in h.cumulative_buckets():
            lines.append(f'{fam}_bucket{{le="{format_value(float(le))}"}} {format_value(cum)}')
        lines.append(f"{fam}_sum {format_value(h.total)}")
        lines.append(f"{fam}_count {format_value(h.count)}")

    # --- span stats ------------------------------------------------------
    stats = snap["span_stats"]
    if stats:
        sec_fam = _fam("span_seconds", "_total")
        cnt_fam = _fam("span_count", "_total")
        lines.append(f"# HELP {sec_fam} cumulative seconds spent inside each span")
        lines.append(f"# TYPE {sec_fam} counter")
        for span_name in sorted(stats):
            lines.append(
                f'{sec_fam}{{span="{escape_label_value(span_name)}"}} '
                f'{format_value(stats[span_name]["total_ms"] / 1e3)}'
            )
        lines.append(f"# HELP {cnt_fam} completed span count")
        lines.append(f"# TYPE {cnt_fam} counter")
        for span_name in sorted(stats):
            lines.append(
                f'{cnt_fam}{{span="{escape_label_value(span_name)}"}} '
                f'{format_value(stats[span_name]["count"])}'
            )

    # --- bounded-buffer drops, labeled by which buffer overflowed ---------
    # Silent truncation is an observability bug; each cap gets its own
    # sample: span records, counter events, and the flight-recorder ring.
    drop_kinds = dict(t.dropped_kinds())
    try:
        from . import flight_recorder
        rec = flight_recorder.active()
        drop_kinds["recorder_ring"] = rec.dropped if rec is not None else 0
    except Exception:  # noqa: BLE001 - metrics must render without the recorder
        drop_kinds["recorder_ring"] = 0
    drop_fam = _fam("telemetry_dropped", "_total")
    lines.append(f"# HELP {drop_fam} telemetry records dropped by caps, by buffer kind")
    lines.append(f"# TYPE {drop_fam} counter")
    for kind in sorted(drop_kinds):
        lines.append(
            f'{drop_fam}{{kind="{escape_label_value(kind)}"}} '
            f"{format_value(drop_kinds[kind])}"
        )

    # --- caller gauges ---------------------------------------------------
    # per-pair link gauges (fedml_link_*{src,dst,backend}) ride along on
    # every /metrics surface once any message has moved
    try:
        from . import netlink as _netlink

        link_gauges = _netlink.prom_gauges()
    except Exception:  # noqa: BLE001 - metrics must render without netlink
        link_gauges = []
    if link_gauges:
        gauges = list(gauges) + link_gauges if gauges else link_gauges
    # SLO alert gauges (fedml_alert_active{slo=}, fedml_slo_burn_rate) ride
    # along whenever an SLO engine is active in the process
    try:
        from . import slo as _slo

        slo_gauges = _slo.prom_gauges()
    except Exception:  # noqa: BLE001 - metrics must render without the slo engine
        slo_gauges = []
    if slo_gauges:
        gauges = list(gauges) + slo_gauges if gauges else slo_gauges
    # device-performance gauges (fedml_device_mfu{program=}, per-device HBM
    # live/high-water bytes) ride along once any instrumented program ran
    try:
        from . import devperf as _devperf

        devperf_gauges = _devperf.prom_gauges()
    except Exception:  # noqa: BLE001 - metrics must render without devperf
        devperf_gauges = []
    if devperf_gauges:
        gauges = list(gauges) + devperf_gauges if gauges else devperf_gauges
    # fleet sketch gauges (fedml_fleet_*{q=} quantiles, top-k offenders,
    # distinct-clients estimate) + the cardinality budget's live-series
    # accounting (fedml_telemetry_series_live{family=,state=}) ride along
    # whenever a fleet view is active — O(1) rows regardless of fleet size
    try:
        from . import sketches as _fleet_sketches

        fleet_gauges = _fleet_sketches.prom_gauges()
    except Exception:  # noqa: BLE001 - metrics must render without the sketches
        fleet_gauges = []
    if fleet_gauges:
        gauges = list(gauges) + fleet_gauges if gauges else fleet_gauges
    if gauges:
        seen_fams = set()
        for name, labels, value in gauges:
            fam = _fam(name)
            if fam not in seen_fams:
                seen_fams.add(fam)
                lines.append(f"# HELP {fam} gauge {escape_help(name)}")
                lines.append(f"# TYPE {fam} gauge")
            lines.append(f"{fam}{_labels_str(labels)} {format_value(float(value))}")

    return "\n".join(lines) + "\n"
