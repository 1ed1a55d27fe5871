"""Endpoint lifecycle: model cards, replica control, inference gateway.

Counterpart of ``fedml_tpu/serving/endpoint.py`` (its mlops endpoint
event is not ported: the port has no mlops). Reference: computing/scheduler/model_scheduler/ — device_model_deployment.py
start_deployment:68 (docker/Triton there; in-process replicas here),
device_replica_controller.py (replica scale-up/down), device_model_inference.py
(gateway forwarding), device_model_db.py (model card persistence — sqlite
there, JSON here). A deployed endpoint = N FedMLInferenceRunner replicas with
a round-robin gateway; scale_to() adds/removes replicas live.
"""

from __future__ import annotations

import http.client
import itertools
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .fedml_inference_runner import FedMLInferenceRunner
from .fedml_predictor import FedMLPredictor

log = logging.getLogger(__name__)


@dataclass
class ModelCard:
    name: str
    version: str
    model_path: str
    created_at: float = field(default_factory=time.time)
    metadata: Dict[str, Any] = field(default_factory=dict)


class ModelDB:
    """Local model-card store (reference device_model_db.py, sqlite->JSON)."""

    def __init__(self, db_path: str):
        self.db_path = db_path
        self.cards: Dict[str, ModelCard] = {}
        if os.path.exists(db_path):
            with open(db_path) as f:
                for rec in json.load(f):
                    self.cards[f"{rec['name']}:{rec['version']}"] = ModelCard(**rec)

    def save(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.db_path)), exist_ok=True)
        with open(self.db_path, "w") as f:
            json.dump([vars(c) for c in self.cards.values()], f)

    def add(self, card: ModelCard) -> None:
        self.cards[f"{card.name}:{card.version}"] = card
        self.save()

    def get(self, name: str, version: str = "latest") -> Optional[ModelCard]:
        if version == "latest":
            matches = [c for c in self.cards.values() if c.name == name]
            return max(matches, key=lambda c: c.created_at) if matches else None
        return self.cards.get(f"{name}:{version}")


class _ReplicaClient:
    """Keep-alive HTTP client for one replica: a pool of reusable
    ``http.client`` connections plus the in-flight count the router reads.
    The old gateway opened a fresh ``urllib`` connection per request — a
    full TCP handshake on every predict, and at continuous-batching
    concurrency (hundreds of parked streams) ephemeral-port churn."""

    def __init__(self, host: str, port: int, pool: str = "decode"):
        self.host = host
        self.port = port
        self.pool = pool  # "prefill" | "decode" routing class
        self.in_flight = 0  # mutated under the owning Endpoint's lock
        self._pool: List[http.client.HTTPConnection] = []
        self._lock = threading.Lock()

    def request(self, path: str, payload: Dict[str, Any], timeout_s: float) -> Dict[str, Any]:
        with self._lock:
            conn = self._pool.pop() if self._pool else None
        if conn is None:
            conn = http.client.HTTPConnection(self.host, self.port, timeout=timeout_s)
        elif conn.sock is not None:
            conn.sock.settimeout(timeout_s)  # pooled conns: per-call timeout
        try:
            conn.request("POST", path, json.dumps(payload).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    f"replica {self.host}:{self.port} returned {resp.status}: {data[:200]!r}")
        except Exception:
            # a half-read or errored connection must never go back in the
            # pool: the next borrower would read this request's leftovers
            conn.close()
            raise
        with self._lock:
            self._pool.append(conn)
        return json.loads(data)

    def close(self) -> None:
        with self._lock:
            for c in self._pool:
                c.close()
            self._pool.clear()


class Endpoint:
    """N replicas + least-in-flight keep-alive gateway.

    With ``prefill_replicas > 0`` the endpoint runs DISAGGREGATED: that
    many replicas form the *prefill* pool and the rest the *decode* pool.
    Long-prompt and cache-warming traffic routes to the prefill pool, so
    a burst of cold multi-kilobyte prompts never queues ahead of decode
    steps on the replicas serving interactive TPOT (the prefill pool's
    page output reaches decode through the engine's transfer stage — see
    ``PagedContinuousBatchingEngine``; a multi-card deployment splices
    the page copy between cards exactly there)."""

    def __init__(self, name: str, predictor_factory: Callable[[], FedMLPredictor],
                 num_replicas: int = 1, *, prefill_replicas: int = 0,
                 prefill_cutoff_chars: int = 2048):
        self.name = name
        self.predictor_factory = predictor_factory
        self.prefill_replicas = int(prefill_replicas)
        self.prefill_cutoff_chars = int(prefill_cutoff_chars)
        self.replicas: List[FedMLInferenceRunner] = []
        self._clients: List[_ReplicaClient] = []
        self._rr = itertools.count()
        self._lock = threading.Lock()
        self.scale_to(num_replicas)

    def scale_to(self, n: int) -> None:
        with self._lock:
            while len(self.replicas) < n:
                # the first prefill_replicas replicas form the prefill pool
                pool = ("prefill" if len(self.replicas) < self.prefill_replicas
                        else "decode")
                runner = FedMLInferenceRunner(self.predictor_factory(), port=0)
                runner.start()
                self.replicas.append(runner)
                self._clients.append(
                    _ReplicaClient(runner.host, runner.port, pool=pool))
                log.info("endpoint %s: %s replica up on port %d",
                         self.name, pool, runner.port)
            while len(self.replicas) > n:
                runner = self.replicas.pop()
                client = self._clients.pop()
                client.close()
                runner.stop()
                log.info("endpoint %s: replica down", self.name)

    @property
    def urls(self) -> List[str]:
        return [f"http://{r.host}:{r.port}" for r in self.replicas]

    def ready(self) -> bool:
        return all(r.client_predictor.ready() for r in self.replicas)

    def in_flight(self) -> List[int]:
        """Per-replica outstanding request counts (observability/tests)."""
        with self._lock:
            return [c.in_flight for c in self._clients]

    def pools(self) -> Dict[str, List[int]]:
        """Per-pool in-flight counts (observability/tests)."""
        with self._lock:
            out: Dict[str, List[int]] = {}
            for c in self._clients:
                out.setdefault(c.pool, []).append(c.in_flight)
            return out

    def _route_pool(self, payload: Dict[str, Any]) -> str:
        """Which pool should serve this request? Explicit ``pool`` wins;
        cache-warming (``prefill_only``) and prompts past the cutoff are
        prefill-heavy work; everything else is decode-bound."""
        pool = payload.get("pool")
        if pool in ("prefill", "decode"):
            return pool
        if payload.get("prefill_only"):
            return "prefill"
        if len(str(payload.get("prompt", ""))) >= self.prefill_cutoff_chars:
            return "prefill"
        return "decode"

    def predict(self, payload: Dict[str, Any], timeout_s: float = 30.0) -> Dict[str, Any]:
        """Gateway: forward to the LEAST-IN-FLIGHT replica over a keep-alive
        connection (reference device_model_inference.py forwards to the
        container, blindly round-robin). Least-in-flight matters once
        replicas run continuous batching: a round-robin gateway keeps
        feeding a replica whose slots are saturated while another sits
        idle — queue depth, not arrival order, is the real load signal.
        Ties rotate round-robin so idle replicas still share warm-up.
        Routing is POOL-AWARE: candidates come from the request's pool
        (``_route_pool``); a pool with no replicas falls back to all."""
        want = self._route_pool(payload)
        with self._lock:
            if not self.replicas:
                raise RuntimeError(f"endpoint {self.name} has no replicas")
            pool = [c for c in self._clients if c.pool == want] or self._clients
            low = min(c.in_flight for c in pool)
            candidates = [c for c in pool if c.in_flight == low]
            client = candidates[next(self._rr) % len(candidates)]
            client.in_flight += 1
        try:
            return client.request("/predict", payload, timeout_s)
        finally:
            with self._lock:
                client.in_flight -= 1

    def shutdown(self) -> None:
        self.scale_to(0)


class EndpointManager:
    """Deploy/undeploy endpoints by model card (reference
    model_scheduler master runner surface)."""

    def __init__(self, db: Optional[ModelDB] = None):
        self.db = db
        self.endpoints: Dict[str, Endpoint] = {}

    def deploy(self, name: str, predictor_factory: Callable[[], FedMLPredictor], num_replicas: int = 1) -> Endpoint:
        if name in self.endpoints:
            raise ValueError(f"endpoint {name!r} already deployed")
        ep = Endpoint(name, predictor_factory, num_replicas)
        self.endpoints[name] = ep
        log.info("endpoint %s: DEPLOYED at %s", name, ep.urls[0] if ep.urls else None)
        return ep

    def deploy_isolated(
        self,
        name: str,
        predictor_spec: str,
        num_replicas: int = 1,
        *,
        model_path: Optional[str] = None,
        autoscale: bool = False,
        env: Optional[Dict[str, str]] = None,
        **scaler_kw,
    ):
        """Deploy with subprocess-isolated replicas + health-evicting gateway
        (+ optional autoscaler) — the container-deployment analogue
        (reference device_model_deployment.py:68). predictor_spec is a
        'module:factory' string importable by the replica child; ``env`` is
        the replicas' environment (this process's when None)."""
        from .replica_controller import AutoScaler, InferenceGateway, ReplicaSet

        if name in self.endpoints:
            raise ValueError(f"endpoint {name!r} already deployed")
        rs = ReplicaSet(predictor_spec, num_replicas, model_path=model_path, env=env)
        try:
            gw = InferenceGateway(rs)
            scaler = None
            if autoscale:
                scaler = AutoScaler(gw, **scaler_kw)
                scaler.start()
        except Exception:
            rs.shutdown()  # don't orphan live replica subprocesses
            raise
        self.endpoints[name] = gw  # gateway exposes predict() like Endpoint
        gw.replica_set_scaler = scaler
        return gw

    def undeploy(self, name: str) -> None:
        ep = self.endpoints.pop(name, None)
        if ep is None:
            return
        scaler = getattr(ep, "replica_set_scaler", None)
        if scaler is not None:
            scaler.stop()
        if hasattr(ep, "replica_set"):
            ep.replica_set.shutdown()
        else:
            ep.shutdown()
