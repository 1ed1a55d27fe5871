"""Subprocess replica set, health-evicting gateway, and autoscaler.

Counterpart of ``fedml_tpu/serving/replica_controller.py``: the children
run ``python -m fedml_tpu_torch.serving.replica_main``. One departure: a
``ReplicaSet`` takes the environment its children start with once, when it
is built, so a replica started later (a scale-up or the replacement of a
dead one) is configured as the first ones were; JAX's reads the parent's
environment at each start (ROADMAP.md, Queue 3, P2). That environment may
also be given (``env=``). Before it starts children that go on the card, a
``ReplicaSet`` builds the port's CUDA kernels itself (``prebuild_kernels``),
so no child runs nvcc. Reference: ``model_scheduler/device_replica_controller.py`` (replica
diff/rollback control), ``device_model_deployment.py:576`` (readiness
probing of freshly started containers), ``device_model_inference.py``
(gateway forwarding + endpoint liveness). Containers are unavailable in this
environment, so the isolation unit is an OS subprocess per replica; the
controller keeps the desired count, the gateway retries across replicas and
evicts ones that fail, and the autoscaler maps observed QPS/latency to a
desired replica count.
"""

from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..core import telemetry as tel

log = logging.getLogger(__name__)


class SubprocessReplica:
    """One replica = one child python process serving /predict + /ready."""

    def __init__(self, predictor_spec: str, *, model_path: Optional[str] = None,
                 startup_timeout_s: float = 60.0, role: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None, wait: bool = True):
        """``env``: the child's environment (this process's when None).
        ``wait=False`` returns once the child is started; ``await_ready``
        then waits for its port."""
        self.id = uuid.uuid4().hex[:8]
        self.predictor_spec = predictor_spec
        self.role = role or "mixed"
        self._port_file = os.path.join(tempfile.gettempdir(), f"fedml_replica_{self.id}.port")
        env = dict(os.environ if env is None else env)
        if role:
            # pool role reaches the child predictor (LLMPredictor sizes its
            # engine for prefill- vs decode-dominated traffic off this)
            env["FEDML_SERVE_ROLE"] = role
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        # FEDML_REPLICA_MEM_FRACTION (inherited) caps each child's share of
        # the card: replica_main hands it to
        # torch.cuda.set_per_process_memory_fraction
        cmd = [sys.executable, "-m", "fedml_tpu_torch.serving.replica_main",
               "--predictor", predictor_spec, "--port-file", self._port_file]
        if model_path:
            cmd += ["--model-path", model_path]
        # the child's stderr goes to a log beside its port file, so a child
        # that dies during startup reports why
        self._log_file = os.path.join(tempfile.gettempdir(), f"fedml_replica_{self.id}.log")
        with open(self._log_file, "wb") as err:
            self.proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL, stderr=err)
        self.port: Optional[int] = None
        self.url: Optional[str] = None
        self.consecutive_failures = 0
        if wait:
            self.await_ready(startup_timeout_s)

    def await_ready(self, timeout_s: float) -> None:
        """Wait for the child's port: it writes it once its predictor is
        built and served. Raises (and stops the child) if it dies first or
        the time runs out."""
        self.port = self._await_port(timeout_s)
        self.url = f"http://127.0.0.1:{self.port}"

    def _await_port(self, timeout_s: float) -> int:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if os.path.exists(self._port_file):
                try:
                    return int(open(self._port_file).read())
                except ValueError:
                    pass
            if self.proc.poll() is not None:
                tail = self.stderr_tail()
                self.stop()
                raise RuntimeError(f"replica {self.id} died during startup "
                                   f"(rc={self.proc.returncode}): {tail}")
            time.sleep(0.05)  # a startup poll, not a retry
        self.proc.kill()
        self.stop()
        raise TimeoutError(f"replica {self.id} did not report a port within {timeout_s}s")

    def stderr_tail(self, n_bytes: int = 2000) -> str:
        """The end of the child's stderr."""
        try:
            with open(self._log_file, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n_bytes))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def ready(self, timeout_s: float = 2.0) -> bool:
        """Readiness probe (reference device_model_deployment.py:576)."""
        try:
            with urllib.request.urlopen(self.url + "/ready", timeout=timeout_s) as resp:
                return resp.status == 200
        except (urllib.error.URLError, OSError):
            return False

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        for path in (self._port_file, self._log_file):
            try:
                os.unlink(path)
            except OSError:
                pass


def prebuild_kernels(env: Dict[str, str]) -> None:
    """Build the port's CUDA kernels in this process, once, before children
    that go on the card start in ``env``: each child then loads the
    libraries and runs no nvcc (``env`` gains ``ops/_build.NO_BUILD_ENV``,
    under which a child that found a library missing raises). Nothing is
    built for children on the CPU (``FEDML_REPLICA_PLATFORM=cpu``) or where
    this process sees no CUDA; a build error raises."""
    if env.get("FEDML_REPLICA_PLATFORM") == "cpu":
        return
    import torch

    if not torch.cuda.is_available():
        return
    from ..ops import _build

    _build.build()
    env[_build.NO_BUILD_ENV] = "1"


class ReplicaSet:
    """Keep `desired` healthy subprocess replicas (reference
    device_replica_controller.py diff logic: add missing, remove extra,
    replace dead)."""

    def __init__(self, predictor_spec: str, desired: int = 1, *, model_path: Optional[str] = None,
                 max_consecutive_failures: int = 3, startup_timeout_s: float = 60.0,
                 role: Optional[str] = None, env: Optional[Dict[str, str]] = None):
        """``env``: the environment every child starts in (this process's,
        read now, when None)."""
        self.predictor_spec = predictor_spec
        self.model_path = model_path
        self.role = role
        self.desired = 0
        self.replicas: List[SubprocessReplica] = []
        self.max_consecutive_failures = max_consecutive_failures
        # predictors that compile a model in warmup (LLM) need far more than
        # the echo-predictor default before the port file appears
        self.startup_timeout_s = float(startup_timeout_s)
        # every child, the first and any later one, starts in this environment
        self._env = dict(os.environ if env is None else env)
        prebuild_kernels(self._env)
        self._lock = threading.RLock()
        try:
            self.scale_to(desired)
        except Exception:
            # a replica failing mid-construction must not leak the ones
            # already serving — nobody holds a handle to shut them down
            self.shutdown()
            raise

    def scale_to(self, n: int) -> None:
        with self._lock:
            self.desired = int(n)
            self.reconcile()

    def retain(self, keep: List["SubprocessReplica"]) -> None:
        """Shrink to exactly `keep`, stopping every other replica.

        scale_to() trims BY LIST POSITION (newest first), which is wrong
        when the caller has readiness information — degrading a bench to
        "the replicas that are ready" must not stop a ready replica while
        keeping one that is still compiling."""
        with self._lock:
            keep_ids = {r.id for r in keep}
            for r in self.replicas:
                if r.id not in keep_ids:
                    r.stop()
                    log.info("replica set: retained-out %s", r.id)
            self.replicas = [r for r in self.replicas if r.id in keep_ids]
            self.desired = len(self.replicas)

    def reconcile(self) -> None:
        """Converge actual replicas to the desired count, replacing dead
        ones. Missing replicas start side by side (JAX's start one after
        another), so n replicas are ready in about one's startup."""
        with self._lock:
            self.replicas = [r for r in self.replicas if self._evict_if_dead(r)]
            new = [SubprocessReplica(self.predictor_spec, model_path=self.model_path,
                                     startup_timeout_s=self.startup_timeout_s, role=self.role,
                                     env=self._env, wait=False)
                   for _ in range(self.desired - len(self.replicas))]
            try:
                for r in new:
                    r.await_ready(self.startup_timeout_s)
            except BaseException:
                for r in new:
                    r.stop()
                raise
            for r in new:
                self.replicas.append(r)
                log.info("replica set: started %s on %s", r.id, r.url)
            while len(self.replicas) > self.desired:
                victim = self.replicas.pop()
                victim.stop()
                log.info("replica set: stopped %s", victim.id)

    def _evict_if_dead(self, r: SubprocessReplica) -> bool:
        if not r.alive() or r.consecutive_failures >= self.max_consecutive_failures:
            log.warning("replica set: evicting %s (alive=%s failures=%d)",
                        r.id, r.alive(), r.consecutive_failures)
            r.stop()
            return False
        return True

    def healthy(self) -> List[SubprocessReplica]:
        with self._lock:
            return [r for r in self.replicas if r.alive()]

    def prom_gauges(self, probe_ready: bool = True) -> List[tuple]:
        """Replica-state gauges for ``core.telemetry.prom.render`` —
        ``fedml_serving_replicas{state=desired|healthy|ready}``. The ready
        probe is an HTTP round-trip per replica; scrape handlers that cannot
        afford it pass ``probe_ready=False``."""
        healthy = self.healthy()
        gauges = [
            ("serving_replicas", {"state": "desired"}, float(self.desired)),
            ("serving_replicas", {"state": "healthy"}, float(len(healthy))),
        ]
        if probe_ready:
            ready = [r for r in healthy if r.ready(timeout_s=1.0)]
            gauges.append(("serving_replicas", {"state": "ready"}, float(len(ready))))
        return gauges

    def statusz_section(self, probe_ready: bool = False) -> Dict[str, Any]:
        """Per-replica states for `/statusz` (the ready probe is an HTTP
        round-trip per replica — off by default for the same reason as
        ``prom_gauges``)."""
        with self._lock:
            replicas = list(self.replicas)
            desired = self.desired
        out = []
        for r in replicas:
            ent: Dict[str, Any] = {
                "id": r.id,
                "url": r.url,
                "alive": r.alive(),
                "consecutive_failures": r.consecutive_failures,
            }
            if probe_ready:
                ent["ready"] = r.ready(timeout_s=1.0)
            out.append(ent)
        return {"desired": desired, "replicas": out}

    def register_statusz(self) -> None:
        """Expose this replica set as the `/statusz` ``replicas`` section."""
        from ..core.telemetry import statusz

        statusz.register_section("replicas", self.statusz_section)
        self._statusz_registered = True

    def shutdown(self) -> None:
        if getattr(self, "_statusz_registered", False):
            from ..core.telemetry import statusz

            statusz.unregister_section("replicas")
            self._statusz_registered = False
        with self._lock:
            self.desired = 0
            for r in self.replicas:
                r.stop()
            self.replicas = []


@dataclass
class GatewayStats:
    requests: int = 0
    errors: int = 0
    window_start: float = 0.0
    window_requests: int = 0
    latency_ewma_s: float = 0.0

    def qps(self) -> float:
        # window_start is on the perf_counter timeline: wall-clock steps
        # (NTP) must not spike the QPS the autoscaler acts on
        dt = time.perf_counter() - self.window_start
        return self.window_requests / dt if dt > 0 else 0.0


class InferenceGateway:
    """Round-robin over healthy replicas with retry + failure eviction
    (reference device_model_inference.py)."""

    def __init__(self, replica_set: ReplicaSet):
        self.replica_set = replica_set
        self.stats = GatewayStats(window_start=time.perf_counter())
        self._rr = 0
        self._lock = threading.Lock()

    def reset_window(self) -> None:
        with self._lock:
            self.stats.window_start = time.perf_counter()
            self.stats.window_requests = 0

    def signals(self) -> Dict[str, float]:
        """The gateway's load signals — ONE source read by both the
        Prometheus scrape (``prom_gauges``) and the autoscaler policy, so
        what the operator graphs is exactly what the scaler acts on."""
        with self._lock:
            return {
                "qps": self.stats.qps(),
                "latency_ewma_s": self.stats.latency_ewma_s,
                "errors": float(self.stats.errors),
            }

    def prom_gauges(self) -> List[tuple]:
        sig = self.signals()
        return [
            ("serving_gateway_qps", None, sig["qps"]),
            ("serving_gateway_latency_ewma_seconds", None, sig["latency_ewma_s"]),
            ("serving_gateway_errors", None, sig["errors"]),
        ]

    def predict(self, payload: Dict[str, Any], *, timeout_s: float = 30.0, retries: int = 3) -> Dict[str, Any]:
        data = json.dumps(payload).encode()
        last_err: Optional[Exception] = None
        for _ in range(max(1, retries)):
            healthy = self.replica_set.healthy()
            if not healthy:
                self.replica_set.reconcile()
                healthy = self.replica_set.healthy()
                if not healthy:
                    raise RuntimeError("no healthy replicas")
            with self._lock:
                r = healthy[self._rr % len(healthy)]
                self._rr += 1
            try:
                # tel.timed: the EWMA consumes the duration, and the span
                # lands per-request latency in traces when telemetry is on
                with tel.timed("serving.predict", replica=r.id) as sp:
                    req = urllib.request.Request(
                        r.url + "/predict", data=data, headers={"Content-Type": "application/json"}
                    )
                    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                        out = json.loads(resp.read())
                dt = sp.duration_s
                tel.histogram("serving.request_seconds").observe(dt)
                with self._lock:
                    r.consecutive_failures = 0
                    s = self.stats
                    s.requests += 1
                    s.window_requests += 1
                    s.latency_ewma_s = dt if s.latency_ewma_s == 0 else 0.9 * s.latency_ewma_s + 0.1 * dt
                return out
            except (urllib.error.URLError, OSError, ConnectionError) as e:
                last_err = e
                tel.counter("serving.request_errors").add(1)
                with self._lock:
                    r.consecutive_failures += 1
                    self.stats.errors += 1
                # replace the failed replica before retrying on another
                self.replica_set.reconcile()
        raise RuntimeError(f"predict failed after {retries} retries: {last_err!r}")


class AutoScaler:
    """QPS/latency -> replica count policy (reference
    device_replica_controller autoscale surface).

    Policy inputs are the gateway's exported Prometheus signals
    (``InferenceGateway.signals``: the same values scraped as
    ``fedml_serving_gateway_qps`` / ``_latency_ewma_seconds``):
    desired = ceil(observed_qps / target_qps_per_replica), and when the
    latency EWMA breaches ``max_latency_s`` under load the scaler adds a
    replica even if QPS alone looks satisfied (queueing shows up in
    latency before it shows up in completed-request QPS). Clamped to
    [min_replicas, max_replicas]; scale-down only after `cooldown_s` of
    sustained low load, scale-up immediate."""

    def __init__(
        self,
        gateway: InferenceGateway,
        *,
        target_qps_per_replica: float = 50.0,
        max_latency_s: Optional[float] = None,
        min_replicas: int = 1,
        max_replicas: int = 8,
        cooldown_s: float = 30.0,
    ):
        self.gateway = gateway
        self.target = float(target_qps_per_replica)
        self.max_latency_s = None if max_latency_s is None else float(max_latency_s)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.cooldown_s = float(cooldown_s)
        self._low_since: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def desired_replicas(self) -> int:
        sig = self.gateway.signals()
        qps = sig["qps"]
        want = max(1, math.ceil(qps / self.target)) if qps > 0 else self.min_replicas
        if (
            self.max_latency_s is not None
            and qps > 0
            and sig["latency_ewma_s"] > self.max_latency_s
        ):
            want = max(want, self.gateway.replica_set.desired + 1)
        return max(self.min_replicas, min(self.max_replicas, want))

    def tick(self, now: Optional[float] = None) -> int:
        # cooldown arithmetic on the monotonic timeline (an explicit `now`
        # must share the perf_counter basis)
        now = now if now is not None else time.perf_counter()
        rs = self.gateway.replica_set
        want = self.desired_replicas()
        have = rs.desired
        if want > have:
            self._low_since = None
            rs.scale_to(want)
        elif want < have:
            if self._low_since is None:
                self._low_since = now
            elif now - self._low_since >= self.cooldown_s:
                rs.scale_to(want)
                self._low_since = None
        else:
            self._low_since = None
        self.gateway.reset_window()
        return rs.desired

    def start(self, period_s: float = 5.0) -> None:
        def loop():
            while not self._stop.wait(period_s):
                try:
                    self.tick()
                except Exception:  # pragma: no cover - keep the loop alive
                    log.exception("autoscaler tick failed")

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5.0)


class DisaggregatedReplicaSet:
    """Prefill/decode pool pair (the ReplicaSet split the paged serving
    stack routes over).

    Prefill-dominated work (cold long prompts, cache warming) and
    decode-dominated work (interactive token streams) have opposite
    resource shapes — prefill is compute-bound and bursty, decode is
    latency-bound and steady — so they get SEPARATE replica pools that
    scale, health-check, and export gauges independently
    (``fedml_serving_pool_replicas{pool=,state=}``). Each child learns its
    role via ``FEDML_SERVE_ROLE``; within one paged replica, prefilled
    pages reach the decode pool through the engine's transfer stage."""

    POOLS = ("prefill", "decode")

    def __init__(self, predictor_spec: str, *, prefill: int = 1, decode: int = 1,
                 model_path: Optional[str] = None,
                 startup_timeout_s: float = 60.0,
                 max_consecutive_failures: int = 3):
        self.pools: Dict[str, ReplicaSet] = {}
        try:
            for role, n in (("prefill", prefill), ("decode", decode)):
                self.pools[role] = ReplicaSet(
                    predictor_spec, n, model_path=model_path, role=role,
                    startup_timeout_s=startup_timeout_s,
                    max_consecutive_failures=max_consecutive_failures)
        except Exception:
            self.shutdown()  # don't orphan the pool that did come up
            raise

    def pool(self, role: str) -> ReplicaSet:
        return self.pools[role]

    def scale_to(self, role: str, n: int) -> None:
        self.pools[role].scale_to(n)

    def healthy(self, role: str) -> List[SubprocessReplica]:
        return self.pools[role].healthy()

    def reconcile(self) -> None:
        for rs in self.pools.values():
            rs.reconcile()

    def prom_gauges(self, probe_ready: bool = True) -> List[tuple]:
        out: List[tuple] = []
        for role, rs in self.pools.items():
            for name, labels, value in rs.prom_gauges(probe_ready=probe_ready):
                out.append(("serving_pool_replicas",
                            {"pool": role, **(labels or {})}, value))
        return out

    def statusz_section(self, probe_ready: bool = False) -> Dict[str, Any]:
        return {role: rs.statusz_section(probe_ready=probe_ready)
                for role, rs in self.pools.items()}

    def shutdown(self) -> None:
        for rs in self.pools.values():
            rs.shutdown()


class DisaggregatedGateway:
    """Pool-aware front for a :class:`DisaggregatedReplicaSet`: one
    :class:`InferenceGateway` per pool, requests routed by phase dominance
    (explicit ``pool`` key > ``prefill_only`` > prompt length), with
    fallback to the other pool when the preferred one has no healthy
    replicas — disaggregation degrades to co-location, never to an
    outage."""

    def __init__(self, replica_set: DisaggregatedReplicaSet, *,
                 prefill_cutoff_chars: int = 2048):
        from ..core.telemetry import prom

        # labeled family: "serving.pool.fallback.<pool>" collapses to
        # fedml_serving_pool_fallback_total{pool=} (bounded cardinality:
        # the pool vocabulary is POOLS)
        prom.register_prefix_family(
            "serving.pool.fallback.", ("pool",),
            "requests rerouted because the preferred pool had no healthy replicas")
        self.replica_set = replica_set
        self.prefill_cutoff_chars = int(prefill_cutoff_chars)
        self.gateways = {role: InferenceGateway(rs)
                         for role, rs in replica_set.pools.items()}

    def route(self, payload: Dict[str, Any]) -> str:
        pool = payload.get("pool")
        if pool in DisaggregatedReplicaSet.POOLS:
            return pool
        if payload.get("prefill_only"):
            return "prefill"
        if len(str(payload.get("prompt", ""))) >= self.prefill_cutoff_chars:
            return "prefill"
        return "decode"

    def predict(self, payload: Dict[str, Any], *, timeout_s: float = 30.0,
                retries: int = 3) -> Dict[str, Any]:
        role = self.route(payload)
        other = "decode" if role == "prefill" else "prefill"
        if not self.replica_set.healthy(role) and self.replica_set.healthy(other):
            tel.counter(f"serving.pool.fallback.{role}").add(1)
            role = other
        return self.gateways[role].predict(
            payload, timeout_s=timeout_s, retries=retries)

    def signals(self) -> Dict[str, Dict[str, float]]:
        return {role: gw.signals() for role, gw in self.gateways.items()}

    def prom_gauges(self) -> List[tuple]:
        out: List[tuple] = []
        for role, gw in self.gateways.items():
            for name, labels, value in gw.prom_gauges():
                out.append((name, {"pool": role, **(labels or {})}, value))
        out.extend(self.replica_set.prom_gauges(probe_ready=False))
        return out

    def shutdown(self) -> None:
        self.replica_set.shutdown()


def create_echo_predictor(model_path: Optional[str] = None):
    """Builtin demo predictor factory (tests + quick starts)."""
    from .fedml_predictor import FedMLPredictor

    class EchoPredictor(FedMLPredictor):
        def __init__(self):
            pass

        def predict(self, request: Dict[str, Any]) -> Dict[str, Any]:
            return {"echo": request, "pid": os.getpid()}

        def ready(self) -> bool:
            return True

    return EchoPredictor()
