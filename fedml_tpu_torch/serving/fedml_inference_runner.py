"""HTTP inference runner: POST /predict, GET /ready, /metrics, /statusz.

Counterpart of ``fedml_tpu/serving/fedml_inference_runner.py`` (reference:
python/fedml/serving/fedml_inference_runner.py:8-50, FastAPI + uvicorn).
The routes are served by a stdlib ThreadingHTTPServer, the JAX package's
stdlib path; its FastAPI app is not ported (``fastapi`` is not installed
where the port runs). ``/metrics`` is Prometheus text (``prom.render``),
``/statusz`` the JSON status page (``statusz.render``), and the serving SLO
pack runs for the runner's lifetime. Concurrent requests coalesce into one
``predict_many`` call when ``max_batch > 1`` (``FEDML_SERVE_MAX_BATCH``,
window ``FEDML_SERVE_BATCH_WINDOW_MS``); a predictor with a
continuous-batching engine interleaves requests itself.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from ..core.telemetry import prom, slo, statusz
from .admission import AdmissionError
from .fedml_predictor import FedMLPredictor

log = logging.getLogger(__name__)


class _MicroBatcher:
    """Server-side dynamic batching: concurrent /predict requests within a
    short window coalesce into one ``predictor.predict_many`` call (the
    LLM predictor decodes them as a single left-padded batch). Beyond the
    reference, whose gateway forwards requests one at a time
    (``device_model_inference.py``)."""

    def __init__(self, predictor, max_batch: int, window_s: float):
        import collections

        self.predictor = predictor
        self.max_batch = max_batch
        self.window_s = window_s
        # observability (tests/metrics); bounded — replicas are long-lived
        self.batch_sizes = collections.deque(maxlen=1024)
        self._q: "queue.Queue" = queue.Queue()
        self._stop = object()  # sentinel: shutdown() unblocks + ends the loop
        self._stopped = False
        # serializes submit's check+enqueue against shutdown's set+sentinel:
        # without it a submit could pass the check, lose the race, and
        # enqueue onto a drained queue nobody will ever service
        self._submit_lock = threading.Lock()
        threading.Thread(target=self._loop, daemon=True).start()

    def shutdown(self) -> None:
        with self._submit_lock:
            self._stopped = True
            self._q.put(self._stop)

    def submit(self, request: dict, timeout_s: float = 600.0) -> dict:
        ev = threading.Event()
        slot: dict = {}
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError("inference runner is shutting down")
            self._q.put((request, ev, slot))
        if not ev.wait(timeout=timeout_s):
            raise TimeoutError("batched predict timed out")
        if "exc" in slot:
            raise slot["exc"]
        return slot["resp"]

    def _drain_on_stop(self) -> None:
        """Fail any request that raced the shutdown sentinel — hanging its
        client for the submit timeout would be the alternative."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is self._stop:
                continue
            _, ev, slot = item
            slot["exc"] = RuntimeError("inference runner is shutting down")
            ev.set()

    def _loop(self) -> None:
        while True:
            first = self._q.get()  # block for the first request
            if first is self._stop:
                self._drain_on_stop()
                return
            batch = [first]
            deadline = time.time() + self.window_s  # a window deadline
            while len(batch) < self.max_batch:
                remaining = deadline - time.time()  # a window deadline
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is self._stop:
                    self._q.put(item)  # serve this batch, then exit next loop
                    break
                batch.append(item)
            self.batch_sizes.append(len(batch))
            try:
                resps = self.predictor.predict_many([b[0] for b in batch])
                if len(resps) != len(batch):
                    raise RuntimeError(
                        f"predict_many returned {len(resps)} responses for {len(batch)} requests"
                    )
            except Exception:  # noqa: BLE001 - one bad request must not
                # 500 its co-batched neighbors: fall back to per-request
                for req, ev, slot in batch:
                    try:
                        slot["resp"] = self.predictor.predict(req)
                    except Exception as e:  # noqa: BLE001
                        slot["exc"] = e
                    ev.set()
                continue
            for (_, ev, slot), resp in zip(batch, resps):
                if isinstance(resp, dict) and "__error__" in resp:
                    slot["exc"] = RuntimeError(resp["__error__"])
                else:
                    slot["resp"] = resp
                ev.set()


class FedMLInferenceRunner:
    def __init__(self, client_predictor: FedMLPredictor, port: int = 2345, host: str = "127.0.0.1",
                 max_batch: Optional[int] = None, batch_window_ms: Optional[float] = None):
        self.client_predictor = client_predictor
        self.port = port
        self.host = host
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._slo: Optional[slo.SLOEngine] = None
        # dynamic batching: explicit args win; env seam lets subprocess
        # replicas opt in (FEDML_SERVE_MAX_BATCH / FEDML_SERVE_BATCH_WINDOW_MS)
        if max_batch is None:
            max_batch = int(os.environ.get("FEDML_SERVE_MAX_BATCH", "1"))
        if batch_window_ms is None:
            batch_window_ms = float(os.environ.get("FEDML_SERVE_BATCH_WINDOW_MS", "10"))
        self.batcher: Optional[_MicroBatcher] = None
        # continuous-batching predictors do their own cross-request
        # interleaving (serving/continuous_batching.py) — wrapping them in
        # the window micro-batcher would re-introduce the request-boundary
        # barrier the engine exists to remove
        self.engine = getattr(client_predictor, "engine", None)
        if self.engine is None and max_batch > 1 and hasattr(client_predictor, "predict_many"):
            self.batcher = _MicroBatcher(client_predictor, max_batch, batch_window_ms / 1000.0)

    # -- stdlib path -------------------------------------------------------
    def _make_handler(self):
        predictor = self.client_predictor
        batcher = self.batcher
        engine = self.engine

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to logging, not stderr
                log.debug("inference http: " + fmt, *args)

            def _send_json(self, obj: Any, code: int = 200) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/ready":
                    if predictor.ready():
                        self._send_json({"status": "Success"})
                    else:
                        self._send_json({"status": "Initializing"}, code=202)
                elif self.path == "/metrics":
                    gauges = [("predictor_ready", None, 1.0 if predictor.ready() else 0.0)]
                    if batcher is not None:
                        sizes = list(batcher.batch_sizes)
                        if sizes:
                            gauges.append(("serving_last_batch_size", None, float(sizes[-1])))
                    if engine is not None:
                        # autoscaler/load-test signals: slot occupancy +
                        # queue depth (TTFT/TPOT ride along automatically
                        # as serving_cb_* histograms in the registry)
                        st = engine.stats()
                        gauges += [
                            ("serving_cb_slots_total", None, float(st["slots_total"])),
                            ("serving_cb_slots_active", None, float(st["slots_active"])),
                            ("serving_cb_slot_occupancy", None, float(st["slot_occupancy"])),
                            ("serving_cb_queue_depth", None, float(st["queue_depth"])),
                        ]
                        # paged engines export more: KV page occupancy,
                        # prefix-cache size, per-tenant TTFT p99, admission
                        # burn/usage/budget (serving_kv_* / serving_tenant_*)
                        extra = getattr(engine, "prom_gauges", None)
                        if extra is not None:
                            gauges += extra()
                    body = prom.render(gauges=gauges).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", prom.CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/statusz":
                    doc = statusz.render(service="inference_runner", extra={
                        "predictor_ready": bool(predictor.ready()),
                        "batching": None if batcher is None else {
                            "max_batch": batcher.max_batch,
                            "window_s": batcher.window_s,
                            "recent_batch_sizes": list(batcher.batch_sizes)[-16:],
                        },
                        "continuous_batching": None if engine is None else engine.stats(),
                    })
                    self._send_json(doc)
                else:
                    self._send_json({"error": "not found"}, code=404)

            def do_POST(self):
                if self.path != "/predict":
                    self._send_json({"error": "not found"}, code=404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    input_json = json.loads(self.rfile.read(length) or b"{}")
                    if batcher is not None:
                        self._send_json(batcher.submit(input_json))
                        return
                    try:
                        resp = predictor.predict(input_json)
                    except NotImplementedError:
                        # predictor implements only async_predict (allowed by
                        # the FedMLPredictor contract)
                        resp = predictor.async_predict(input_json)
                    if asyncio.iscoroutine(resp):
                        resp = asyncio.run(resp)
                    self._send_json(resp)
                except AdmissionError as e:
                    # shed at the front door (budget / SLO pressure /
                    # queue full): 429 tells the client to back off —
                    # this is policy working, not a server fault, so no
                    # error log and no 500
                    self._send_json(
                        {"error": "admission_rejected", "tenant": e.tenant,
                         "reason": e.reason}, code=429)
                except Exception as e:  # noqa: BLE001 - request boundary
                    log.exception("predict failed")
                    self._send_json({"error": repr(e)}, code=500)

        return Handler

    def start(self) -> int:
        """Non-blocking start; returns the bound port (0 picks a free one)."""

        class _Server(ThreadingHTTPServer):
            # socketserver's default listen backlog is 5: a 1k-stream load
            # burst overflows the accept queue and clients see connection
            # resets before the first byte is served
            request_queue_size = 1024
            daemon_threads = True

        self._server = _Server((self.host, self.port), self._make_handler())
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        # serving SLO pack (TTFT/TPOT p99 ceilings, error rate) evaluated on
        # a background ticker (FEDML_SLO_TICK_S) for the replica's lifetime
        self._slo = slo.activate(None, front="serving")
        return self.port

    def stop(self) -> None:
        slo.deactivate(getattr(self, "_slo", None))
        self._slo = None
        if self.batcher is not None:
            # end the batcher thread: it holds the predictor (and its model
            # params) and would otherwise outlive this runner forever
            self.batcher.shutdown()
        if self.engine is not None:
            self.engine.shutdown()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def run(self) -> None:
        """Blocking serve (reference run() semantics)."""
        self.start()
        assert self._thread is not None
        self._thread.join()
