"""The port's link layer against the JAX package's, on the CPU: netlink's
estimators, registry and cost model, the INMEMORY link throttle, the link
prober, the link-cost consumers (quorum deadline, async admission), the
telemetry surfaces, and federations with every link knob on.

Tolerances: the estimators, snapshots, gauges, statusz sections, flow
events, predictions, throttle delays, deadlines and admission cuts are
compared exactly (both netlink modules read one fake clock). The
federations' final params match JAX's within 1e-5 of their scale (LR in
f32, as ``tests/test_torch_cross_silo.py``); their link readings are
timings and are held to bounds: the throttled pair's predicted upload
at most 2x the broker's delay for that message and at least half its
bytes' term (the estimator halves a sample's latency floor at most, so
its bandwidth reads up to 2x fast, and with no RTT on the client->server
pair the prediction has no latency term).
"""

import queue
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.aggregation.async_buffer import StalenessPolicy as JPolicy
from fedml_tpu.core.distributed.communication.inmemory.broker import InMemoryBroker as JBroker
from fedml_tpu.core.distributed.communication.message import Message as JMessage
from fedml_tpu.core.distributed.communication.mqtt_s3.socket_broker import SocketMqttBroker
from fedml_tpu.core.resilience.quorum import QuorumPolicy as JQuorum
from fedml_tpu.core.telemetry import netlink as jnet
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.core.aggregation.async_buffer import StalenessPolicy as TPolicy
from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker
from fedml_tpu_torch.core.distributed.communication.ip_config import free_port_block
from fedml_tpu_torch.core.distributed.communication.message import Message as TMessage
from fedml_tpu_torch.core.distributed.link_probe import LinkProber, probe_config
from fedml_tpu_torch.core.resilience.quorum import QuorumPolicy as TQuorum
from fedml_tpu_torch.core.telemetry import netlink as tnet
from fedml_tpu_torch.core.telemetry import prom as tprom
from fedml_tpu_torch.core.telemetry import slo as tslo
from fedml_tpu_torch.core.telemetry import statusz as tstatusz
from fedml_tpu_torch.core.telemetry import trace_context
from tests.test_torch_cross_silo import (LR, Federation, _from_jax_params, _global, _jax_p0,
                                         _max_err_of_scale)

FED_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several parties train at once in the federations; under several test
    workers a pool of threads in each only spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_netlink():
    tnet.reset()
    jnet.reset()
    yield
    tnet.reset()
    jnet.reset()


class _Clock:
    """One fake clock for both netlink modules (``time`` is the only clock
    they read): monotonic seconds, wall nanoseconds, perf nanoseconds."""

    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t

    def time_ns(self):
        return int(round(self.t * 1e9))

    def perf_counter_ns(self):
        return int(round(self.t * 1e9))


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(jnet, "time", c)
    monkeypatch.setattr(tnet, "time", c)
    return c


def _msgs(msg_type, sender, receiver, arrays=(), **params):
    """The same message in both packages: numpy arrays on JAX's side, torch
    tensors with the same bytes on the port's."""
    j, t = JMessage(msg_type, sender, receiver), TMessage(msg_type, sender, receiver)
    for k, v in params.items():
        j.add_params(k, v)
        t.add_params(k, v)
    if arrays:
        j.add_params("model_params", {f"w{i}": a for i, a in enumerate(arrays)})
        t.add_params("model_params", {f"w{i}": torch.from_numpy(a.copy())
                                      for i, a in enumerate(arrays)})
    return j, t


# --- payload sizes and the estimators -----------------------------------------------

def test_payload_nbytes_equals_jax_for_tensors_and_arrays():
    rng = np.random.default_rng(0)
    cases = [
        _msgs(2, 0, 1, [rng.standard_normal((10, 10)).astype(np.float32)], name="abcd",
              round_idx=3, flag=True),
        _msgs(3, 1, 0, [np.zeros(20000, np.uint8), np.ones((7, 3), np.float64)]),
        _msgs(2, 0, 1, payload={"a": {"b": {"c": {"d": {"e": {"f": {"g": 1.0}}}}}}}),
    ]
    for j, t in cases:
        assert tnet.payload_nbytes(t) == jnet.payload_nbytes(j) > 0
    assert tnet.payload_nbytes(object()) == jnet.payload_nbytes(object()) == 0
    # the flight recorder's comm events read the same function
    from fedml_tpu_torch.core.telemetry import flight_recorder as tfr

    assert not hasattr(tfr, "payload_nbytes")


def test_robust_ewma_equals_jax_sample_by_sample():
    """A seeded stream with outliers, a regime shift and non-finite values:
    every verdict, value, count and window equal to JAX's."""
    rng = np.random.default_rng(1)
    xs = list(1.0 + 0.05 * rng.standard_normal(12)) + [100.0, 1.0] + [50.0] * 6 \
        + [float("nan"), float("inf")] + list(50.0 + rng.standard_normal(8))
    j, t = jnet.RobustEwma(), tnet.RobustEwma()
    for x in xs:
        assert t.update(x) == j.update(x)
        assert (t.value, t.count, t.rejected, list(t.samples)) == \
            (j.value, j.count, j.rejected, list(j.samples))
    assert t.as_dict() == j.as_dict()
    for d in ({"value": 5.5, "samples": 7}, "junk", {"value": float("nan")}):
        j.restore(d)
        t.restore(d)
        assert t.as_dict() == j.as_dict()


def test_pair_stats_equal_jax(clock):
    j, t = jnet.PairStats(0, 1), tnet.PairStats(0, 1)
    steps = [("on_send", (40000, "inmemory")), ("on_recv", (100, "inmemory", 0.01)),
             ("on_recv", (1 << 20, "inmemory", 1.0)), ("on_probe", (0.040, 0)),
             ("on_probe", (0.240, 65536)), ("on_probe_sent", ()), ("on_probe_lost", ()),
             ("on_probe", (0.041, 0)), ("on_recv", (50000, "grpc", -1.0))]
    for name, a in steps:
        clock.t += 0.25
        getattr(j, name)(*a)
        getattr(t, name)(*a)
        assert t.as_dict() == j.as_dict(), name
    assert t.loss_ratio() == j.loss_ratio()


def _drive(net, clock, msgs):
    """One scripted history on a fresh registry: passive sends and arrivals
    with latencies, probes (answered and lost), a remote merge."""
    reg = net.get_registry()
    for m in msgs:
        clock.t += 0.5
        reg.record_send(m, backend="inmemory")
        clock.t += 0.0125 * (1 + m.get_sender_id())
        reg.record_recv(m, backend="inmemory")
    for peer, rtt in ((1, 0.02), (2, 0.2)):
        for k in range(5):
            clock.t += 0.1
            reg.probe_sent(0, peer)
            reg.observe_probe(0, peer, rtt + 0.001 * k, 0, backend="inmemory")
            reg.probe_sent(0, peer)
            reg.observe_probe(0, peer, rtt + 0.05 + 0.002 * k, 4096, backend="inmemory")
    reg.probe_sent(0, 2)
    reg.probe_lost(0, 2)
    reg.merge_remote(2, {"2->5": {"bw_bytes_per_s": {"value": 3e6, "samples": 4},
                                  "rtt_s": {"value": 0.05, "samples": 4}},
                         "bad": {}, "0->9": "junk"})
    clock.t += 3.0
    return reg


def test_registry_cost_model_and_exports_equal_jax(clock):
    """The same history booked into each package's registry: the send stamp,
    the snapshots, the merge, the gauges, the statusz section, the flow
    events and the cost model's predictions all equal JAX's."""
    rng = np.random.default_rng(2)
    pairs = []
    for sender, receiver in ((1, 0), (2, 0), (0, 1), (0, 2), (1, 0), (2, 0), (1, 1)):
        pairs.append(_msgs(3, sender, receiver,
                           [rng.standard_normal(9000).astype(np.float32)], round_idx=1))
    t0 = clock.t
    jreg = _drive(jnet, clock, [j for j, _ in pairs])
    clock.t = t0
    treg = _drive(tnet, clock, [t for _, t in pairs])
    for j, t in pairs:
        jh, th = j.get(JMessage.MSG_ARG_KEY_TELEMETRY), t.get(TMessage.MSG_ARG_KEY_TELEMETRY)
        assert th == jh
        if t.get_sender_id() != t.get_receiver_id():
            assert isinstance(th[trace_context.SENT_AT_FIELD], int)
    assert treg.delta_snapshot() == jreg.delta_snapshot()
    assert treg.prom_gauges() == jreg.prom_gauges()
    assert treg.statusz() == jreg.statusz()
    assert treg.flow_events(int(900e9)) == jreg.flow_events(int(900e9))
    assert tnet.statusz_snapshot() == jnet.statusz_snapshot()
    assert tnet.prom_gauges() == jnet.prom_gauges()
    for src, dst in ((1, 0), (2, 0), (0, 1), (0, 2), (2, 5), (7, 0)):
        for nbytes in (0, 1000, 1 << 20):
            tp = treg.cost_model().predict_transfer_s(src, dst, nbytes)
            jp = jreg.cost_model().predict_transfer_s(src, dst, nbytes)
            assert (tp.seconds, tp.confidence) == (jp.seconds, jp.confidence)
    for min_conf in (0.0, 0.25, 0.9):
        tpred = tnet.make_upload_predictor(lambda r: 40000 * r, min_confidence=min_conf)
        jpred = jnet.make_upload_predictor(lambda r: 40000 * r, min_confidence=min_conf)
        assert [tpred(r) for r in (1, 2, 3)] == [jpred(r) for r in (1, 2, 3)]
    assert (1, 1) not in treg.pairs()  # a party's message to itself is not a link


def test_surfaces_carry_the_link_families_and_sections(clock):
    """/metrics carries every fedml_link_* family per pair, /statusz the
    ``links`` section, and the SLO engine's tick records ``link.loss_ratio``
    (the worst pair's probe loss), as JAX's surfaces do."""
    assert "links" not in tstatusz.render()["sections"]
    reg = _drive(tnet, clock, [_msgs(3, 1, 0, [np.zeros(20000, np.float32)])[1]])
    text = tprom.render(tel.Telemetry(enabled=True))
    for fam in ("bandwidth_bytes_per_sec", "rtt_seconds", "loss_ratio",
                "last_probe_age_seconds", "bytes_sent", "bytes_received",
                "predicted_mib_seconds", "confidence"):
        for src, dst in ((0, 1), (0, 2)):
            assert f'fedml_link_{fam}{{src="{src}",dst="{dst}",backend="inmemory"}} ' in text, fam
    assert set(tstatusz.render()["sections"]["links"]["pairs"]) == \
        {f"{s}->{d}" for s, d in reg.pairs()}
    tslo.reset()
    engine = tslo.activate(None, front="cross_silo")
    try:
        engine.tick()
        worst = max(s.loss_ratio() for s in reg.pairs().values())
        assert worst > 0 and engine.store.last("link.loss_ratio") == worst
    finally:
        tslo.deactivate(engine)
        tslo.reset()


# --- the INMEMORY link throttle ------------------------------------------------------

def test_throttle_delay_equals_jax_s_broker():
    """Exact: the delay each broker gives the same messages, one end, both
    ends (the slower link), no end throttled, the stop sentinel, cleared."""
    jb, tb = JBroker(), InMemoryBroker()
    for b in (jb, tb):
        b.set_throttle(2, 8e6, base_delay_s=0.01)
        b.set_throttle(3, 1e6, base_delay_s=0.002)
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(70_000).astype(np.float32)]
    for sender, receiver in ((2, 0), (0, 2), (3, 2), (1, 0), (0, 3)):
        j, t = _msgs(3, sender, receiver, arrays)
        assert tb._chaos_delay_s(receiver, t) == jb._chaos_delay_s(receiver, j)
    assert tb._chaos_delay_s(2, object()) == jb._chaos_delay_s(2, object()) == 0.01
    for b in (jb, tb):
        b.clear_throttle(2)
    j, t = _msgs(3, 2, 0, arrays)
    assert tb._chaos_delay_s(0, t) == jb._chaos_delay_s(0, j) == 0.0


def test_throttled_delivery_waits_and_a_failed_timer_fails_the_next_publish(monkeypatch):
    monkeypatch.setattr(threading, "excepthook", lambda args: None)  # the timer's own report
    b = InMemoryBroker()
    b.set_throttle(1, 1e6, base_delay_s=0.05)
    _, t = _msgs(3, 1, 0, [np.zeros(50_000, np.uint8)])
    t0 = time.monotonic()
    b.publish(0, t)
    got = b.queue_for(0).get(timeout=5)
    assert got is t and time.monotonic() - t0 >= 0.1 - 1e-3

    def broken(rank):
        raise RuntimeError("queue gone")

    b.queue_for = broken
    b.publish(0, _msgs(3, 1, 0, [np.zeros(10, np.uint8)])[1])
    deadline = time.monotonic() + 5
    while b.timer_error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert isinstance(b.timer_error, RuntimeError)
    with pytest.raises(RuntimeError, match="throttled delivery failed"):
        b.publish(0, t)


# --- the prober ------------------------------------------------------------------------

def _echo_peer(broker, rank, stop, drop=False):
    """A peer that answers every probe on its broker queue (or none)."""
    q = broker.queue_for(rank)
    while not stop.is_set():
        try:
            m = q.get(timeout=0.02)
        except queue.Empty:
            continue
        if drop:
            continue
        echo = TMessage(9, rank, m.get_sender_id())
        echo.add_params("probe_seq", m.get("probe_seq"))
        echo.add_params("probe_t_send_ns", m.get("probe_t_send_ns"))
        broker.publish(m.get_sender_id(), echo)


def test_prober_rtt_and_loss_over_inmemory():
    """Two peers over one INMEMORY broker, peer 2 throttled (5 ms base
    delay), peer 3 silent: every probe to 1 and 2 is echoed with loss 0 and
    peer 2's RTT floor at least its two crossings; peer 3's probes expire as
    losses; stop() joins the thread."""
    broker = InMemoryBroker()
    broker.set_throttle(2, 1e7, base_delay_s=0.005)
    reg = tnet.NetLinkRegistry()

    def send(peer, seq, t_ns, nbytes):
        m = TMessage(8, 0, peer)
        m.add_params("probe_seq", seq)
        m.add_params("probe_t_send_ns", t_ns)
        if nbytes:
            m.add_params("probe_pad", np.zeros(nbytes, np.uint8))
        broker.publish(peer, m)

    prober = LinkProber(0, send, lambda: [1, 2, 3], interval_s=0.05, payload_bytes=4096,
                        timeout_intervals=4.0, registry=reg, backend="inmemory")
    stop = threading.Event()
    peers = [threading.Thread(target=_echo_peer, args=(broker, r, stop, r == 3), daemon=True)
             for r in (1, 2, 3)]
    answers = threading.Event()

    def collect():
        q = broker.queue_for(0)
        while not stop.is_set():
            try:
                m = q.get(timeout=0.02)
            except queue.Empty:
                continue
            prober.observe_echo(m.get_sender_id(), m.get("probe_seq"), m.get("probe_t_send_ns"))
            if prober.echoes >= 16:
                answers.set()

    threads = peers + [threading.Thread(target=collect, daemon=True)]
    for th in threads:
        th.start()
    prober.start()
    try:
        assert answers.wait(20)
        deadline = time.monotonic() + 10
        while reg.pair((0, 3)).probes_lost < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        prober.stop()
        stop.set()
        for th in threads:
            th.join(5)
    p1, p2, p3 = (reg.pair((0, r), create=False) for r in (1, 2, 3))
    assert p1.probes_answered >= 4 and p2.probes_answered >= 4
    assert p1.probes_lost == 0 and p2.probes_lost == 0 and p1.loss_ratio() == 0.0
    assert p2.rtt.value >= 2 * 0.005 and p2.bw.value is not None
    assert p3.probes_answered == 0 and p3.probes_lost >= 2 and p3.loss_ratio() > 0.5
    assert prober.statusz()["ticks"] >= 2 and prober._thread is None
    assert probe_config(type("A", (), {"link_probe_interval_s": 0.25})()) == \
        {"interval_s": 0.25, "payload_bytes": 65536, "timeout_intervals": 3.0}


def test_prober_that_cannot_send_fails_on_stop():
    def send(peer, seq, t_ns, nbytes):
        raise ConnectionError("peer gone")

    prober = LinkProber(0, send, lambda: [1], interval_s=0.01, registry=tnet.NetLinkRegistry())
    hook = threading.excepthook
    threading.excepthook = lambda args: None  # the thread's own report
    try:
        prober.start()
        deadline = time.monotonic() + 5
        while prober.error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="link prober failed") as ei:
            prober.stop()
    finally:
        threading.excepthook = hook
    assert isinstance(ei.value.__cause__, ConnectionError)


# --- the link-cost consumers ------------------------------------------------------------

class _C:
    def __init__(self, e):
        self.ewma_s = e


class _H:
    def __init__(self, ewmas):
        self._clients = {r: _C(e) for r, e in ewmas.items()}


def _raises(rank):
    raise RuntimeError("no estimate")


PREDICTORS = {"slow_rank": {3: 4.0}.get, "all": {1: 0.5, 2: 0.01, 3: 9.0}.get,
              "none": lambda r: None, "raises": _raises}


@pytest.mark.parametrize("predictor", list(PREDICTORS))
def test_quorum_link_cost_deadlines_equal_jax(predictor):
    rng = np.random.default_rng(4)
    for trial in range(20):
        ewmas = {r: float(rng.uniform(0.01, 3.0)) for r in (1, 2, 3)}
        if trial % 5 == 0:
            ewmas[2] = None
        kw = dict(adaptive=True, adaptive_mult=float(rng.uniform(1.5, 4.0)),
                  min_deadline_s=float(rng.uniform(0.1, 2.0)),
                  deadline_s=None if trial % 2 else float(rng.uniform(1.0, 30.0)))
        for use in (False, True):
            j, t = JQuorum(use_link_cost=use, **kw), TQuorum(use_link_cost=use, **kw)
            for pred in (None, PREDICTORS[predictor]):
                assert t.deadline_for_round(_H(ewmas), link_predict=pred) == \
                    j.deadline_for_round(_H(ewmas), link_predict=pred)
    args = type("A", (), {"quorum_link_cost": True})()
    assert TQuorum.from_args(args).use_link_cost is JQuorum.from_args(args).use_link_cost is True
    budgets = TQuorum(adaptive=True, use_link_cost=True).rank_budgets(
        _H({1: 1.0, 2: 1.0, 3: 1.0}), PREDICTORS["slow_rank"])
    assert budgets == {1: 1.0, 2: 1.0, 3: 5.0}


@pytest.mark.parametrize("predictor", list(PREDICTORS))
def test_async_link_admission_cuts_equal_jax(predictor):
    for max_s in (0, 1, 4, 10):
        for interval in (None, 0.0, 0.1, 1.0, 7.5):
            j, t = JPolicy(max_staleness=max_s), TPolicy(max_staleness=max_s)
            assert t.as_dict() == j.as_dict()
            for p in (j, t):
                p.set_link_predictor(PREDICTORS[predictor], lambda: interval)
            assert t.as_dict() == j.as_dict() and t.as_dict()["link_wired"]
            for rank in (None, 1, 2, 3):
                assert t.admission_cut(rank) == j.admission_cut(rank), (max_s, interval, rank)
                assert [t.admit(s, rank) for s in range(25)] == \
                    [j.admit(s, rank) for s in range(25)]


# --- federations with the link knobs on ------------------------------------------------

THROTTLED, THROTTLE_BPS, BASE_DELAY_S = 2, 1e5, 0.02
LINKED = dict(LR, dataset="mnist", client_num_in_total=3, client_num_per_round=3, comm_round=3,
              batch_size=64,
              adaptive_deadline=True, quorum_link_cost=True, link_wan_health=True,
              link_probe_interval_s=0.1, link_probe_payload_bytes=4096,
              link_probe_timeout_intervals=100)


@pytest.fixture
def short_switch_interval():
    """The parties are threads of one process: a receive loop woken while
    other parties train waits out the interpreter lock's 5 ms switch
    slices, which a passive latency sample would time beside the link."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(0.0005)
    yield
    sys.setswitchinterval(switch)


def _linked_federation(pkg, run_id, kw, prepare=None):
    broker = JBroker if pkg is fedml_tpu else InMemoryBroker
    broker.reset(run_id)
    kw = dict(kw)

    def prep(role, rank, args, dataset, model):
        if rank == THROTTLED:  # set before the runner builds the comm manager
            args.chaos_link_throttle = THROTTLE_BPS
            args.chaos_link_base_delay_s = BASE_DELAY_S
        return prepare(role, rank, args, dataset, model) if prepare else (dataset, model)

    fed = Federation(pkg, run_id, kw, prepare=prep)
    seen = {"budgets": [], "upload_nbytes": {}}
    server = fed.server
    arm, receive = server._arm_deadline_timer, server.handle_message_receive_model_from_client

    def armed():
        arm()
        ewma = {r: c.ewma_s for r, c in server.aggregator.fleet.health._clients.items()}
        seen["budgets"].append({r: (b, ewma[r])
                                for r, b in getattr(server, "deadline_budgets", {}).items()})

    def received(msg):
        # the upload's bytes as the broker sized its delay (the same object)
        seen["upload_nbytes"][msg.get_sender_id()] = pkg_nbytes(msg)
        receive(msg)

    pkg_nbytes = (jnet if pkg is fedml_tpu else tnet).payload_nbytes
    server._arm_deadline_timer = armed
    server.handle_message_receive_model_from_client = received
    fed.run()
    broker.reset(run_id)
    return fed, seen


def test_linked_federation_runs_every_knob_and_tracks_jax(short_switch_interval):
    """LR on the MNIST surrogate, 3 silos x 3 rounds over INMEMORY, silo 2
    throttled, probing every 0.1 s, WAN-aware health and the link-cost
    deadline on: the final params equal JAX's run of the same config within
    FED_TOL, and the port's link readings hold their bounds."""
    p0 = _jax_p0(LINKED)
    jfed, _ = _linked_federation(fedml_tpu, "tnl_linked_jax", LINKED)
    fed, seen = _linked_federation(fedml_tpu_torch, "tnl_linked_port", LINKED,
                                   prepare=_from_jax_params(p0))
    assert _max_err_of_scale(_port_np_tree(_global(fed)), jax.device_get(_global(jfed))) <= FED_TOL
    reg = tnet.get_registry()
    # probes echoed on every pair, none lost on the unthrottled ones
    for r in (1, 2, 3):
        p = reg.pair((0, r), create=False)
        assert p.probes_answered >= 2, r
        if r != THROTTLED:
            assert p.loss_ratio() == 0.0, r
    # the throttled pair's predicted upload against the broker's own delay
    # for its last upload; the unthrottled pairs at least 10x faster
    nbytes = seen["upload_nbytes"]
    transfer = nbytes[THROTTLED] / THROTTLE_BPS
    delay = BASE_DELAY_S + transfer
    slow = tnet.make_upload_predictor(lambda r: nbytes[r])(THROTTLED)
    assert slow is not None and 0.5 * transfer <= slow <= 2.0 * delay, (slow, delay)
    for r in (1, 3):
        fast = tnet.make_upload_predictor(lambda r: nbytes[r], min_confidence=0.0)(r)
        assert fast * 10 <= slow, (r, fast, slow)
    # the last armed deadline stretches the throttled rank's budget past
    # the others' (budget less health EWMA: the link cost)
    stretch = {r: b - e for r, (b, e) in seen["budgets"][-1].items()}
    assert stretch[THROTTLED] > max(stretch[r] for r in (1, 3)), seen["budgets"]
    # WAN-aware health: each rank's last round time is broadcast to arrival
    health = fed.server.aggregator.fleet.health._clients
    assert health[THROTTLED].last_s > max(health[r].last_s for r in (1, 3))


def _port_np_tree(state):
    from fedml_tpu_torch.models.convert import params_to_jax

    return params_to_jax({k: v.detach().cpu() for k, v in state.items()})


def test_async_link_admission_folds_the_throttled_upload(short_switch_interval):
    """FedBuff, 3 silos, publish_k 2, one publish, silo 2 throttled: the
    admission predictor reads each silo's own link (the buffer's index is
    rank - 1), the throttled silo's cut is at least the others', and no
    upload is refused."""
    kw = dict(LR, dataset="mnist", client_num_in_total=3, client_num_per_round=3, comm_round=1,
              async_rounds=True, async_publish_k=2, async_link_admission=True)
    fed, _ = _linked_federation(fedml_tpu_torch, "tnl_async_port", kw)
    buf = fed.server.aggregator.async_buffer
    assert buf.policy.as_dict()["link_wired"]
    # the buffer judges an arrival by silo index (rank - 1); the predictor
    # reads the silo's own link
    cuts = {r: buf.policy.admission_cut(r - 1) for r in (1, 2, 3)}
    assert cuts[THROTTLED] >= max(cuts[1], cuts[3])
    own = tnet.make_upload_predictor(lambda r: fed.server._last_bcast_nbytes)
    for r in (1, 2, 3):
        assert buf.policy._link_predict(r - 1) == own(r), r
    assert buf.stale_rejected_total == 0 and buf.merges_total >= 2


def test_jax_server_with_port_clients_carries_stamps_and_link_deltas(tmp_path):
    """A JAX server and two port clients over a JAX socket broker: the run
    completes, the JAX server books one-way latencies from the port's
    ``ts`` stamps, and merges the port clients' link blocks."""
    broker = SocketMqttBroker(port=free_port_block(1))
    try:
        kw = dict(LR, mqtt_socket=broker.address, object_store_dir=str(tmp_path / "store"),
                  fleet_trace=str(tmp_path / "fleet.json"))
        jfed = Federation(fedml_tpu, "tnl_mixed", kw, backend="MQTT_S3", roles={1: None, 2: None})
        tfed = Federation(fedml_tpu_torch, "tnl_mixed", kw, backend="MQTT_S3", roles={0: None})
        clients = [threading.Thread(target=tfed._party, args=(r,), daemon=True, name=f"port-{r}")
                   for r in tfed.runners]
        jfed.run(others=clients)
        assert not tfed.errors, tfed.errors
    finally:
        broker.stop()
    assert jfed.server.final_metrics["round"] == 1
    jreg = jnet.get_registry()
    for r in (1, 2):
        up = jreg.pair((r, 0), create=False)
        assert up.msgs_recvd >= 3 and up.oneway.value is not None, r
    assert sorted(jreg.statusz()["remote"]) == ["1", "2"]
    treg = tnet.get_registry()
    for r in (1, 2):
        assert treg.pair((r, 0), create=False).msgs_sent >= 3
        assert treg.pair((0, r), create=False).oneway.value is not None
