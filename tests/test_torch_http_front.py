"""The port's serving front door on the CPU: the HTTP runner, endpoints,
subprocess replicas with their gateway and autoscaler, and the slice
against the JAX package.

Everything binds port 0 on the loopback. Replica children run
``fedml_tpu_torch.serving.replica_main`` on the CPU
(``FEDML_REPLICA_PLATFORM=cpu``, one torch thread) at the endpoint bench's
tiny geometry (f32). Each test that starts children runs under its own
time limit (``time_limit``, SIGALRM) and reaps them in ``finally``.

The slice against JAX: JAX's params (a tiny f32 llama) served by JAX's
``FedMLInferenceRunner`` around JAX's ``LLMPredictor``, and by the port's
runner around the port's ``LLMPredictor`` loaded from the same params
through ``models/convert.py``; the same prompts over HTTP give the same
texts (greedy, f32 on both sides).
"""

import contextlib
import json
import os
import signal
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import transformer as jt
from fedml_tpu.serving.fedml_inference_runner import FedMLInferenceRunner as JRunner
from fedml_tpu.serving.fedml_predictor import LLMPredictor as JPredictor
from fedml_tpu.train.llm import tokenizer as jtok
from fedml_tpu_torch.core.telemetry import statusz
from fedml_tpu_torch.models import transformer as tt
from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.serving import (Endpoint, EndpointManager, FedMLInferenceRunner,
                                     FedMLPredictor, LLMPredictor, ModelCard, ModelDB)
from fedml_tpu_torch.serving.replica_controller import (AutoScaler, DisaggregatedGateway,
                                                        DisaggregatedReplicaSet,
                                                        InferenceGateway, ReplicaSet,
                                                        SubprocessReplica)
from fedml_tpu_torch.train.llm import tokenizer as ttok

ECHO = "fedml_tpu_torch.serving.replica_controller:create_echo_predictor"
BENCH = "fedml_tpu_torch.serving.bench_predictors:llm_bench_predictor"
CHILD_LIMIT_S = 120  # each test that starts replica children


@contextlib.contextmanager
def time_limit(seconds: int):
    """Raise TimeoutError in the test if it runs past ``seconds``."""
    def on_alarm(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds}s limit")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def cpu_children(monkeypatch):
    """Replica children on the CPU, one torch thread, the tiny geometry."""
    monkeypatch.setenv("FEDML_REPLICA_PLATFORM", "cpu")
    monkeypatch.setenv("FEDML_BENCH_TINY", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("FEDML_SLO_TICK_S", "0.5")


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(url, payload, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _parse_prom(text):
    """Prometheus 0.0.4 text -> {(family, labels): value}; every sample's
    family declared by a TYPE line before it."""
    typed, out = set(), {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
            continue
        if not line or line.startswith("#"):
            continue
        name_labels, value = line.rsplit(" ", 1)
        name = name_labels.split("{", 1)[0]
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in typed:
                base = name[:-len(suffix)]
        assert base in typed, line
        out[name_labels] = float(value)
    return out


class _Echo(FedMLPredictor):
    def __init__(self):
        super().__init__()
        self.calls = []

    def predict(self, request, *args, **kwargs):
        return {"echo": request.get("inputs"), "who": id(self)}

    def predict_many(self, requests):
        self.calls.append(len(requests))
        return [{"echo": r.get("inputs"), "who": id(self)} for r in requests]


class _NotReady(_Echo):
    def ready(self):
        return False


def test_runner_routes_over_loopback():
    runner = FedMLInferenceRunner(_Echo(), port=0)
    port = runner.start()
    base = f"http://127.0.0.1:{port}"
    try:
        assert port > 0
        assert _post(base + "/predict", {"inputs": [1, 2]})["echo"] == [1, 2]
        assert json.loads(_get(base + "/ready")[2]) == {"status": "Success"}
        status, ctype, body = _get(base + "/metrics")
        assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
        samples = _parse_prom(body.decode())
        assert samples["fedml_predictor_ready"] == 1.0
        assert samples['fedml_alert_active{slo="ttft_p99_seconds"}'] == 0.0  # the serving pack
        doc = json.loads(_get(base + "/statusz")[2])
        assert doc["service"] == "inference_runner" and doc["predictor_ready"] is True
        assert doc["sections"]["alerts"]["front"] == "serving"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/nope")
        assert e.value.code == 404
    finally:
        runner.stop()
    not_ready = FedMLInferenceRunner(_NotReady(), port=0)
    port = not_ready.start()
    try:
        status, _, body = _get(f"http://127.0.0.1:{port}/ready")
        assert status == 202 and json.loads(body) == {"status": "Initializing"}
    finally:
        not_ready.stop()


def test_micro_batcher_coalesces_concurrent_requests():
    pred = _Echo()
    runner = FedMLInferenceRunner(pred, port=0, max_batch=4, batch_window_ms=300)
    port = runner.start()
    try:
        results = {}
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, _post(f"http://127.0.0.1:{port}/predict", {"inputs": i}))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert {k: v["echo"] for k, v in results.items()} == {i: i for i in range(4)}
        assert max(pred.calls) > 1 and sum(pred.calls) == 4
        body = _get(f"http://127.0.0.1:{port}/metrics")[2].decode()
        assert "fedml_serving_last_batch_size" in body
    finally:
        runner.stop()


def test_endpoint_scale_to_and_model_db(tmp_path):
    ep = Endpoint("e", _Echo, num_replicas=1)
    try:
        assert len(ep.urls) == 1 and ep.ready()
        ep.scale_to(3)
        whos = {ep.predict({"inputs": i})["who"] for i in range(6)}
        assert len(ep.urls) == 3 and len(whos) == 3  # least-in-flight ties rotate
        ep.scale_to(1)
        assert len(ep.replicas) == 1 and ep.predict({"inputs": 0})["echo"] == 0
        assert ep._route_pool({"prompt": "x" * 4096}) == "prefill"
        assert ep._route_pool({"prompt": "x"}) == "decode"
    finally:
        ep.shutdown()
    db = ModelDB(str(tmp_path / "db.json"))
    db.add(ModelCard("m", "1", "/p1", created_at=1.0))
    db.add(ModelCard("m", "2", "/p2", created_at=2.0))
    assert ModelDB(str(tmp_path / "db.json")).get("m").version == "2"
    mgr = EndpointManager(db)
    mgr.deploy("demo", _Echo, 2)
    try:
        with pytest.raises(ValueError, match="already deployed"):
            mgr.deploy("demo", _Echo)
        assert mgr.endpoints["demo"].predict({"inputs": 5})["echo"] == 5
    finally:
        mgr.undeploy("demo")
    assert "demo" not in mgr.endpoints


def test_replica_set_ready_evicts_retries_and_scales(cpu_children, monkeypatch):
    with time_limit(CHILD_LIMIT_S):
        rs = ReplicaSet(BENCH, desired=2, startup_timeout_s=60)
        try:
            assert len(rs.healthy()) == 2 and all(r.ready() for r in rs.healthy())
            gw = InferenceGateway(rs)
            want = gw.predict({"prompt": "federated benchmark", "max_new_tokens": 4})
            assert isinstance(want["text"], str)
            # every replica serves the same seeded weights
            for r in rs.healthy():
                assert _post(r.url + "/predict", {"prompt": "federated benchmark",
                                                  "max_new_tokens": 4}) == want
            samples = _parse_prom(_get(rs.healthy()[0].url + "/metrics")[2].decode())
            assert samples["fedml_predictor_ready"] == 1.0
            # a gateway retry: a stopped replica times out, the next one answers
            stuck = rs.healthy()[0]
            gw._rr = 0  # the next pick is the stopped replica
            os.kill(stuck.proc.pid, signal.SIGSTOP)
            try:
                assert gw.predict({"prompt": "federated benchmark", "max_new_tokens": 4},
                                  timeout_s=0.5) == want
                assert gw.stats.errors == 1 and stuck.consecutive_failures == 1
                assert stuck in rs.replicas  # one failure does not evict a live replica
            finally:
                os.kill(stuck.proc.pid, signal.SIGCONT)
            # eviction: a killed replica is replaced, the corpse gone
            victim = rs.healthy()[1]
            os.kill(victim.proc.pid, signal.SIGKILL)
            victim.proc.wait(timeout=10)
            for i in range(3):
                assert "text" in gw.predict({"prompt": "endpoint", "max_new_tokens": 2})
            # the replacement starts in the set's environment, not the one
            # this process has now (without the CPU flag it would need a card)
            monkeypatch.delenv("FEDML_REPLICA_PLATFORM")
            rs.reconcile()
            assert victim not in rs.replicas and len(rs.healthy()) == 2
            assert all(_post(r.url + "/predict", {"prompt": "federated benchmark",
                                                  "max_new_tokens": 4}) == want
                       for r in rs.healthy())
            # the autoscaler maps the observed QPS to a count
            scaler = AutoScaler(gw, target_qps_per_replica=1e9, min_replicas=1,
                                max_replicas=2, cooldown_s=0.0)
            gw.reset_window()
            gw.predict({"prompt": "a", "max_new_tokens": 1})
            assert scaler.desired_replicas() == 1
            scaler.tick(now=0.0)   # low load starts the cooldown clock
            assert scaler.tick(now=1.0) == 1 and len(rs.healthy()) == 1
            rs.register_statusz()
            doc = statusz.render(service="gateway")
            assert doc["sections"]["replicas"]["desired"] == 1
            gauges = {(n, tuple(sorted((lab or {}).items()))): v
                      for n, lab, v in rs.prom_gauges() + gw.prom_gauges()}
            assert gauges[("serving_replicas", (("state", "ready"),))] == 1.0
            assert gauges[("serving_gateway_errors", ())] >= 1.0
        finally:
            rs.shutdown()
        assert "replicas" not in statusz.registered_sections()
        assert all(not r.alive() for r in rs.replicas) and rs.replicas == []


def test_disaggregated_pools_route_by_phase(cpu_children):
    with time_limit(CHILD_LIMIT_S):
        drs = DisaggregatedReplicaSet(ECHO, prefill=1, decode=1, startup_timeout_s=60)
        try:
            gw = DisaggregatedGateway(drs, prefill_cutoff_chars=64)
            pids = {role: drs.healthy(role)[0].proc.pid for role in drs.POOLS}
            assert gw.predict({"prompt": "x" * 100})["pid"] == pids["prefill"]
            assert gw.predict({"prompt": "short"})["pid"] == pids["decode"]
            assert gw.predict({"prompt": "short", "prefill_only": True})["pid"] == pids["prefill"]
            assert gw.predict({"prompt": "x" * 100, "pool": "decode"})["pid"] == pids["decode"]
            drs.scale_to("prefill", 0)
            assert gw.predict({"prompt": "x" * 100})["pid"] == pids["decode"]  # fallback
            labels = {tuple(sorted(lab.items())) for _, lab, _ in gw.prom_gauges()}
            assert (("pool", "decode"), ("state", "healthy")) in labels
        finally:
            drs.shutdown()


def test_deploy_isolated_and_a_replica_without_cuda(cpu_children, monkeypatch):
    with time_limit(CHILD_LIMIT_S):
        mgr = EndpointManager()
        gw = mgr.deploy_isolated("bench", BENCH, 1)
        try:
            assert "text" in gw.predict({"prompt": "throughput", "max_new_tokens": 2})
            with pytest.raises(ValueError, match="already deployed"):
                mgr.deploy_isolated("bench", BENCH, 1)
        finally:
            mgr.undeploy("bench")
        assert "bench" not in mgr.endpoints
        # no CUDA and no FEDML_REPLICA_PLATFORM: the child raises before it
        # writes its port, so it never reports ready
        monkeypatch.delenv("FEDML_REPLICA_PLATFORM")
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        with pytest.raises(RuntimeError, match="(?s)died during startup.*CUDA"):
            SubprocessReplica(BENCH, startup_timeout_s=60)


class _FakeChild:
    """Stands in for a SubprocessReplica: records the environment it was
    given and the order it started in."""

    def __init__(self, spec, *, env, events, **kw):
        self.env, self.id = env, f"fake{len(events)}"
        self.consecutive_failures = 0
        events.append(("child", env.get(_build.NO_BUILD_ENV)))

    def await_ready(self, timeout_s):
        self.url = "http://127.0.0.1:0"

    def alive(self):
        return True

    def stop(self):
        pass


@pytest.mark.parametrize("platform", [None, "cpu"])
def test_replica_set_builds_the_kernels_once_before_its_children(monkeypatch, platform):
    """Children that go on the card find the kernels built: the set builds
    them first, in this process, and starts each child with the flag under
    which a missing library raises instead of running nvcc. Children on the
    CPU build nothing."""
    from fedml_tpu_torch.serving import replica_controller as rc

    events = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build", lambda: events.append(("build", None)))
    monkeypatch.setattr(rc, "SubprocessReplica",
                        lambda spec, **kw: _FakeChild(spec, events=events, **kw))
    env = {"FEDML_BENCH_TINY": "1"}
    if platform:
        env["FEDML_REPLICA_PLATFORM"] = platform
    rs = ReplicaSet(BENCH, desired=2, env=env)
    rs.scale_to(3)
    if platform == "cpu":
        assert events == [("child", None)] * 3
    else:
        assert events == [("build", None)] + [("child", "1")] * 3
    assert _build.NO_BUILD_ENV not in env  # the caller's mapping is copied, not changed


def test_a_child_of_a_built_checkout_runs_no_nvcc(monkeypatch, tmp_path):
    """Under the flag a ReplicaSet gives its card children, the build finds
    every library of this checkout's sources or raises: it never starts
    nvcc."""
    def no_nvcc():
        raise AssertionError("the build looked for nvcc")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setenv(_build.NO_BUILD_ENV, "1")
    with pytest.raises(RuntimeError, match=f"{_build.NO_BUILD_ENV}=1"):
        _build.build()
    digest = _build._source_digest()
    libs = [_build._lib_path(src, digest) for src in _build.KERNEL_SOURCES]
    for lib in libs:
        lib.write_bytes(b"")  # what the parent's build left
    assert _build.build() == libs


GEOM = dict(vocab_size=300, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            max_seq_len=64, remat=False)
CORPUS = ["federated silos serve the same text over http",
          "the quick brown fox jumps over the lazy dog"] * 4
PROMPTS = ["federated silos", "the quick brown", "serve", "http text over"]


def test_the_slice_gives_jax_s_text_over_http(monkeypatch):
    """JAX's runner around JAX's predictor, the port's runner around the
    port's predictor on JAX's params (through convert.py): the same texts."""
    monkeypatch.setenv("FEDML_SLO_TICK_S", "3600")
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **GEOM)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **GEOM)
    params = jax.device_get(jt.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    jpred = JPredictor(params, jcfg, jtok.train_bpe(CORPUS, vocab_size=300),
                       default_max_new_tokens=8)
    tpred = LLMPredictor(params, tcfg, ttok.train_bpe(CORPUS, vocab_size=300),
                         default_max_new_tokens=8, device="cpu")
    texts = {}
    for name, runner in (("jax", JRunner(jpred, port=0)), ("port", FedMLInferenceRunner(tpred, port=0))):
        port = runner.start()
        try:
            texts[name] = [_post(f"http://127.0.0.1:{port}/predict", {"prompt": p})["text"]
                           for p in PROMPTS]
        finally:
            runner.stop()
    assert texts["port"] == texts["jax"]
    assert any(texts["port"])
