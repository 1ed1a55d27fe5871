"""`/statusz`: one JSON page answering "what is this process doing right now".

A copy of ``fedml_tpu/core/telemetry/statusz.py`` (framework-free). Of the
JAX page's always-on sections it keeps ``resilience``, ``links`` (netlink's
per-pair estimates), ``alerts`` (the SLO engine), ``devperf``,
``modelwatch`` (the active contribution ledger, once it has seen a round)
and ``fleet_sketches``; ``sharding`` is left out until the server mesh is
ported (ROADMAP.md, Queue 1).

Borrowed from the Google-style z-pages idiom: every long-running fedml
process (cross-silo server, serving replica, gateway) exposes a single
introspection document — uptime, telemetry state, flight-recorder status,
plus whatever *sections* the process registers (round progress, per-client
health, replica states). Sections are lazy callables evaluated at render
time; a section that throws renders as ``{"error": ...}`` instead of taking
the whole page down, because a status endpoint that 500s during an incident
is worse than none.

Two ways to serve it:

- processes that already own an HTTP surface (stdlib inference runner,
  FastAPI app) call :func:`render` from their own route handler;
- the cross-silo server manager, which has no HTTP server of its own, starts
  the tiny stdlib :class:`StatuszServer` (also re-serving ``/metrics`` so a
  training server is scrapable without a serving stack).
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from .core import get_telemetry

__all__ = [
    "register_section",
    "unregister_section",
    "render",
    "StatuszServer",
]

_SERVICE_START_MONO = time.monotonic()

_sections_lock = threading.Lock()
_sections: Dict[str, Callable[[], Any]] = {}


def register_section(name: str, provider: Callable[[], Any]) -> None:
    """Add/replace a named section; ``provider()`` runs at render time."""
    with _sections_lock:
        _sections[str(name)] = provider


def unregister_section(name: str) -> None:
    with _sections_lock:
        _sections.pop(str(name), None)


def registered_sections() -> List[str]:
    with _sections_lock:
        return sorted(_sections)


def render(service: Optional[str] = None,
           extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The `/statusz` document as a plain JSON-safe dict."""
    tel = get_telemetry()
    try:
        from . import flight_recorder
        rec = flight_recorder.active()
        fr = rec.statusz() if rec is not None else {"installed": False}
    except Exception as e:  # noqa: BLE001 - status page must not throw
        fr = {"error": repr(e)}
    doc: Dict[str, Any] = {
        "service": service,
        "pid": os.getpid(),
        "uptime_s": round(time.monotonic() - _SERVICE_START_MONO, 3),
        "time_unix": time.time(),  # a page timestamp, not a duration
        "telemetry": {
            "enabled": tel.enabled,
            "dropped": dict(tel.dropped_kinds()),
        },
        "flight_recorder": fr,
        "sections": {},
    }
    # the resilience section (last checkpointed round, quorum stats, retry
    # counters) is always registered: any process that checkpointed, retried,
    # or aggregated partially shows it without per-process wiring
    try:
        from ..resilience import statusz_snapshot

        res = statusz_snapshot()
        if res:
            doc["sections"]["resilience"] = res
    except Exception as e:  # noqa: BLE001 - status page must not throw
        doc["sections"]["resilience"] = {"error": repr(e)}
    # the links section (per-pair bandwidth/RTT estimates, bytes in/out,
    # probe ages) is always-on: any process whose comm manager moved a
    # message has pairs to show
    try:
        from . import netlink as _netlink

        links = _netlink.statusz_snapshot()
        if links:
            doc["sections"]["links"] = links
    except Exception as e:  # noqa: BLE001 - status page must not throw
        doc["sections"]["links"] = {"error": repr(e)}
    # the alerts section (per-SLO state, burn rates, recent transitions,
    # tsdb ingest stats) is always-on: any process with an active SLO
    # engine shows its alerts without per-process wiring
    try:
        from . import slo as _slo

        alerts = _slo.statusz_snapshot()
        if alerts:
            doc["sections"]["alerts"] = alerts
    except Exception as e:  # noqa: BLE001 - status page must not throw
        doc["sections"]["alerts"] = {"error": repr(e)}
    # the devperf section (per-program achieved FLOPs/s, MFU, HBM gauges) is
    # always-on: any process that ran an instrumented step has programs to
    # show
    try:
        from . import devperf as _devperf

        dev = _devperf.statusz_snapshot()
        if dev:
            doc["sections"]["devperf"] = dev
    except Exception as e:  # noqa: BLE001 - status page must not throw
        doc["sections"]["devperf"] = {"error": repr(e)}
    # modelwatch (per-client contribution ledger + divergence stats): shows
    # whenever a server or simulator front registered an active ledger
    try:
        from . import modelwatch as _modelwatch

        mw = _modelwatch.statusz_snapshot()
        if mw:
            doc["sections"]["modelwatch"] = mw
    except Exception as e:  # noqa: BLE001 - status page must not throw
        doc["sections"]["modelwatch"] = {"error": repr(e)}
    # fleet sketches (bounded quantile/offender/cardinality summary + the
    # series budget's live/degraded accounting): shows whenever a fleet view
    # is active — the million-client replacement for per-rank sections
    try:
        from . import sketches as _fleet_sketches

        fleet = _fleet_sketches.statusz_snapshot()
        if fleet:
            doc["sections"]["fleet_sketches"] = fleet
    except Exception as e:  # noqa: BLE001 - status page must not throw
        doc["sections"]["fleet_sketches"] = {"error": repr(e)}
    with _sections_lock:
        providers = dict(_sections)
    for name, provider in sorted(providers.items()):
        try:
            doc["sections"][name] = provider()
        except Exception as e:  # noqa: BLE001 - a broken section must not 500 the page
            doc["sections"][name] = {"error": repr(e)}
    if extra:
        doc.update(extra)
    return doc


class _Handler(BaseHTTPRequestHandler):
    server_version = "fedml-statusz/1"

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0]
        if path == "/statusz":
            body = json.dumps(
                render(service=self.server.service_name),  # type: ignore[attr-defined]
                default=repr).encode("utf-8")
            self._reply(200, body, "application/json")
        elif path == "/metrics":
            from . import prom
            gauges_fn = self.server.gauges_fn  # type: ignore[attr-defined]
            try:
                gauges = gauges_fn() if gauges_fn else None
            except Exception:  # noqa: BLE001 - scrape must not 500 on a bad gauge
                gauges = None
            body = prom.render(telemetry=get_telemetry(), gauges=gauges).encode("utf-8")
            self._reply(200, body, prom.CONTENT_TYPE)
        else:
            self._reply(404, b'{"error": "not found"}', "application/json")

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # noqa: D102 - silence per-request stderr spam
        pass


class StatuszServer:
    """Tiny threaded HTTP server for processes without one: GET `/statusz`
    (JSON) and `/metrics` (Prometheus text). ``port=0`` binds an ephemeral
    port, readable from :attr:`port` after :meth:`start`."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 service: Optional[str] = None,
                 gauges_fn: Optional[Callable[[], List[tuple]]] = None,
                 port_file: Optional[str] = None):
        self._host = host
        self._want_port = int(port)
        self.service = service
        self._gauges_fn = gauges_fn
        self._port_file = port_file
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def start(self) -> int:
        self._httpd = ThreadingHTTPServer((self._host, self._want_port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.service_name = self.service  # type: ignore[attr-defined]
        self._httpd.gauges_fn = self._gauges_fn  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="statusz", daemon=True)
        self._thread.start()
        if self._port_file:
            tmp = self._port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(self.port))
            os.replace(tmp, self._port_file)  # atomic: probes never see a torn port
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # a clean shutdown removes the discovery breadcrumb so probes never
        # dial a port that has been reused by another process
        if self._port_file:
            try:
                os.remove(self._port_file)
            except OSError:
                pass
