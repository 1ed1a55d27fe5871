"""The port's telemetry front (prom, statusz, the SLO engine, the flight
recorder) against the JAX package's, on the CPU.

Each side gets the same inputs: the same counters, histograms, gauges and
prefix families in a fresh registry; the same sections on the status page;
the same samples at the same times in a fresh time-series store, ticked at
the same clock. Process-wide ride-alongs that earlier tests in a worker may
have left behind (the JAX package's mesh, netlink and devperf gauges, the
port's devperf gauges, an active SLO engine or fleet view, the global
resilience state) are switched
off on both sides for the comparison, and both default registries are
enabled for it (a test that ran earlier in the worker may have left one
disabled). Tolerances: the Prometheus text
byte-equal; the status page equal but for its clock and pid fields; SLO
transitions equal; a dump's record types and keys equal (the JAX dump's
``mesh`` record aside, which the port leaves out until the mesh is ported).
"""

import json
import threading

import numpy as np
import pytest

from fedml_tpu.core.telemetry import core as jcore
from fedml_tpu.core.telemetry import flight_recorder as jfr
from fedml_tpu.core.telemetry import prom as jprom
from fedml_tpu.core.telemetry import sketches as jsk
from fedml_tpu.core.telemetry import slo as jslo
from fedml_tpu.core.telemetry import statusz as jstatusz
from fedml_tpu.core.telemetry import tsdb as jtsdb
from fedml_tpu_torch.core.telemetry import core as tcore
from fedml_tpu_torch.core.telemetry import flight_recorder as tfr
from fedml_tpu_torch.core.telemetry import prom as tprom
from fedml_tpu_torch.core.telemetry import sketches as tsk
from fedml_tpu_torch.core.telemetry import slo as tslo
from fedml_tpu_torch.core.telemetry import statusz as tstatusz
from fedml_tpu_torch.core.telemetry import tsdb as ttsdb

SIDES = {"jax": (jcore, jprom, jstatusz, jslo, jtsdb, jfr),
         "port": (tcore, tprom, tstatusz, tslo, ttsdb, tfr)}


@pytest.fixture
def registries_on():
    """Both default registries enabled for the test, restored after."""
    regs = [core.get_telemetry() for core in (jcore, tcore)]
    was = [t.enabled for t in regs]
    for t in regs:
        t.set_enabled(True)
    yield
    for t, on in zip(regs, was):
        t.set_enabled(on)


@pytest.fixture
def quiet_ride_alongs(monkeypatch, registries_on):
    """No process-wide gauge or section rides along on either side."""
    import fedml_tpu.core.distributed.mesh as jmesh
    import fedml_tpu.core.resilience as jres
    import fedml_tpu.core.telemetry.devperf as jdev
    import fedml_tpu.core.telemetry.modelwatch as jmw
    import fedml_tpu.core.telemetry.netlink as jnet
    import fedml_tpu_torch.core.resilience as tres
    import fedml_tpu_torch.core.telemetry.devperf as tdev
    import fedml_tpu_torch.core.telemetry.modelwatch as tmw
    import fedml_tpu_torch.core.telemetry.netlink as tnet

    for mod in (jmesh, jnet, jdev, jslo, jsk, tnet, tslo, tsk, tdev):
        monkeypatch.setattr(mod, "prom_gauges", lambda: [])
    for mod in (jmesh, jnet, jdev, jmw, jslo, jsk, jres, tnet, tslo, tsk, tres, tdev, tmw):
        monkeypatch.setattr(mod, "statusz_snapshot", lambda: {})
    for fr in (jfr, tfr):
        monkeypatch.setattr(fr, "active", lambda: None)


def _populate(core, prom):
    t = core.Telemetry()
    prom.register_prefix_family("serving.pool.fallback.", ("pool",),
                                "requests rerouted because the preferred pool had no healthy "
                                "replicas")
    prom.register_prefix_family("serving.admission.rejected.", ("tenant", "reason"),
                                "admission-path rejects by tenant and reason")
    t.counter("serving.request_errors").add(3)
    t.counter("jax.compiles.decode_step").add(2)
    t.counter("comm.retry.grpc").add(5)
    t.counter("serving.pool.fallback.decode").add(1)
    t.counter("serving.admission.rejected.acme.corp.budget").add(4)
    t.counter("serving.admission.rejected.t2.queue_full").add(1)
    t.counter("odd name-with\\chars").add(1)
    rng = np.random.default_rng(0)
    for v in rng.exponential(0.05, 40):
        t.histogram("serving.request_seconds").observe(float(v))
    t.histogram("serving.cb.ttft_seconds").observe(0.25)
    t.histogram("serving.cb.ttft_seconds").observe(float("inf"))
    return t


GAUGES = [("predictor_ready", None, 1.0),
          ("serving_replicas", {"state": "desired"}, 2.0),
          ("serving_replicas", {"state": "ready"}, 2.0),
          ("serving_gateway_qps", None, 12.5),
          ("serving_tenant_usage_share", {"tenant": 'we"ird\\n'}, 0.25),
          ("serving_kv_pages", {"state": "free"}, float("nan"))]


def test_prom_render_is_byte_equal_to_jax(quiet_ride_alongs):
    texts = {name: prom.render(telemetry=_populate(core, prom), gauges=list(GAUGES))
             for name, (core, prom, *_rest) in SIDES.items()}
    assert texts["port"] == texts["jax"]
    assert 'fedml_serving_admission_rejected_total{tenant="acme.corp",reason="budget"} 4' \
        in texts["port"]
    assert 'fedml_jax_compiles_total{fn="decode_step"} 2' in texts["port"]
    assert tprom.CONTENT_TYPE == jprom.CONTENT_TYPE


def _page(statusz, fr, tmp_path):
    rec = fr.FlightRecorder(capacity=16, dump_dir=str(tmp_path), role="serving_replica",
                            enabled=True)
    rec.record(fr.EVENT_MARK, "x")
    statusz.register_section("replicas", lambda: {"desired": 2, "replicas": [{"id": "a"}]})
    statusz.register_section("broken", lambda: 1 / 0)
    try:
        doc = statusz.render(service="inference_runner", extra={"predictor_ready": True})
        doc["flight_recorder"] = rec.statusz()
    finally:
        statusz.unregister_section("replicas")
        statusz.unregister_section("broken")
    for key in ("pid", "uptime_s", "time_unix"):
        assert isinstance(doc.pop(key), (int, float)), key
    doc["telemetry"]["dropped"] = sorted(doc["telemetry"]["dropped"])  # kinds, not counts
    return doc


def test_statusz_render_is_equal_but_for_the_clock(quiet_ride_alongs, tmp_path):
    pages = {name: _page(statusz, fr, tmp_path)
             for name, (_c, _p, statusz, _s, _t, fr) in SIDES.items()}
    assert pages["port"] == pages["jax"]
    assert pages["port"]["sections"]["broken"] == {"error": "ZeroDivisionError('division by zero')"}


def _slo_run(slo, tsdb):
    """One engine over the serving pack plus a floor spec, fed the same
    samples and ticked at the same clock; -> (transitions per tick, the
    final statusz without its clock-read fields, prom gauges)."""
    store = tsdb.TimeSeriesStore(capacity=256, resolution_s=1.0)
    specs = slo.build_specs("serving") + [
        slo.SLOSpec(name="qps_floor", series="serving.requests", signal="rate",
                    comparator=">=", target=0.2, fast_window_s=180.0, slow_window_s=900.0)]
    engine = slo.SLOEngine(specs, store=store, front="serving")
    out = []
    rng = np.random.default_rng(3)
    total = 0.0
    for tick in range(16):
        now = 100.0 + 60.0 * tick
        slow = 3 <= tick < 6  # a latency incident, then recovery
        for v in rng.exponential(8.0 if slow else 0.5, 20):
            store.record_observation("serving.cb.ttft_seconds", float(v), t=now - 1.0)
        total += 5 if tick < 6 else 40
        store.record_counter("serving.requests", total, t=now - 0.5)
        store.record_counter("serving.request_errors", float(tick), t=now - 0.5)
        out.append(engine.tick(now=now))
    doc = engine.statusz()
    for key in ("tick_ms", "fanout_ms"):
        doc.pop(key)
    doc["tsdb"].pop("ingest_ms")
    for row in doc["slos"].values():
        row.pop("since_s")
    return out, doc, engine.prom_gauges()


def test_slo_transitions_are_equal_to_jax(monkeypatch):
    import fedml_tpu.mlops as jmlops

    monkeypatch.setattr(jmlops, "log_alert", lambda *a, **k: None)
    runs = {name: _slo_run(slo, tsdb) for name, (_c, _p, _z, slo, tsdb, _f) in SIDES.items()}
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][1] == runs["jax"][1]
    assert runs["port"][2] == runs["jax"][2]
    fired = [tr for tick in runs["port"][0] for tr in tick]
    assert {"from": "pending", "to": "firing"}.items() <= \
        next(tr for tr in fired if tr["slo"] == "ttft_p99_seconds" and tr["to"] == "firing").items()
    assert any(tr["slo"] == "ttft_p99_seconds" and tr["to"] == "resolved" for tr in fired)


def test_slo_refuses_the_profile_capture():
    from types import SimpleNamespace

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tslo.activate(SimpleNamespace(alert_profile_capture=True), front="serving")
    assert tslo.get_engine() is None or tslo.get_engine().args is None


class _Msg:
    def __init__(self, sender, receiver, params):
        self._s, self._r, self._p = sender, receiver, params

    def get_sender_id(self):
        return self._s

    def get_receiver_id(self):
        return self._r

    def get_params(self):
        return self._p

    def get_type(self):
        return "model_update"


def _dump(core, fr, tmp_path, weights):
    rec = fr.FlightRecorder(capacity=8, dump_dir=str(tmp_path), role="serving_replica")
    fr.install(recorder=rec)
    try:
        tel = core.get_telemetry()
        with tel.span("serving.predict", replica="a"):
            fr.mark("replica_ready", port=1234)
        fr.record_comm("send", _Msg(0, 1, {"w": weights, "round": 3}))
        try:
            with tel.span("serving.decode"):
                raise RuntimeError("boom")
        except RuntimeError as e:
            path = rec.dump(reason="exception", exc_info=(type(e), e, e.__traceback__),
                            alert={"slo": "ttft_p99_seconds", "observed": 9.0})
    finally:
        fr.uninstall()
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_flight_recorder_dump_has_jax_keys(tmp_path, monkeypatch, registries_on):
    import torch

    for sk in (jsk, tsk):
        monkeypatch.setattr(sk, "statusz_snapshot", lambda: None)
    w = np.arange(6, dtype=np.float32)
    dumps = {"jax": _dump(jcore, jfr, tmp_path / "jax", w),
             "port": _dump(tcore, tfr, tmp_path / "port", torch.from_numpy(w))}
    dumps["jax"] = [r for r in dumps["jax"] if r["type"] != "mesh"]

    def shape(records):
        return [(r["type"], sorted(r)) for r in records]

    assert shape(dumps["port"]) == shape(dumps["jax"])
    events = {name: [(r["kind"], r["name"], sorted(r.get("fields", {})))
                     for r in recs if r["type"] == "event"] for name, recs in dumps.items()}
    assert events["port"] == events["jax"]
    comm = [r for r in dumps["port"] if r["type"] == "event" and r["kind"] == "comm_send"]
    assert comm[0]["fields"]["bytes"] == w.nbytes + 8
    stack = next(r for r in dumps["port"] if r["type"] == "span_stack")["spans"]
    assert [s["name"] for s in stack] == ["serving.decode"]
    meta = dumps["port"][0]
    assert meta["type"] == "meta" and meta["schema"] == jfr.DUMP_SCHEMA_VERSION


def test_flight_recorder_excepthooks_restore():
    import sys

    before = (sys.excepthook, threading.excepthook)
    rec = tfr.install(role="t")
    try:
        assert tfr.active() is rec and sys.excepthook is not before[0]
    finally:
        tfr.uninstall()
    assert (sys.excepthook, threading.excepthook) == before and tfr.active() is None


def test_health_prom_gauges_equal_jax():
    from fedml_tpu.core.telemetry.health import HealthTracker as JH
    from fedml_tpu_torch.core.telemetry.health import HealthTracker as TH

    out = []
    for cls in (JH, TH):
        h = cls()
        for rank, dt in ((1, 1.0), (2, 1.1), (3, 9.0)):
            h.observe_round(rank, dt)
        h.end_round(0)
        out.append([(n, lab, round(v, 12)) for n, lab, v in h.prom_gauges()
                    if n == "client_straggler"])
    assert out[0] == out[1] and len(out[1]) == 3
