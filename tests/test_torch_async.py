"""The port's async federation against the JAX package's, on the CPU: the
FedBuff buffer and its staleness policy, the async sinks, the event-driven
simulator, and the three trainers of the slice (the vmapped async driver,
FedAsync's per-arrival mixing and the hierarchical sp trainer).

Tolerances:

- the buffer: the same seeded numpy trees and a scripted arrival order with
  model versions go into both packages' buffers: verdicts and versions
  identical, every published model within 1e-6 of each leaf's scale of
  JAX's (f32 folds in other summation orders; measured 1.1e-7); with
  staleness exponent 0
  and ``publish_k`` within one bucket, the port's publish equals its
  ``engine.aggregate`` bit for bit;
- the event simulator: both packages' ``AsyncEventSim`` get one numpy
  ``train_batch``: the event traces (client, version, verdict) and the
  staleness samples identical, the publishes within 1e-6 of their scale;
- the trainers, from JAX's initial params (``models/convert.py``): LR at
  Parrot config 1's shape (MNIST surrogate, 2 clients) in f32, each eval's
  test_loss within rtol 1e-4 and atol 1e-6 and the final params within
  1e-5 of their scale (``tests/test_torch_fed_trainers.py``'s LR limits;
  measured worst 1.7e-7 and 3.1e-7); CNNCifar on cut CIFAR-10 surrogate
  shards with both packages in float64 (ROADMAP's ground rule for CNN and
  ResNet parity), test_loss within rtol 1e-7 and the final params within
  5e-4 of their update's scale (that file's float64 limits: the folds still
  accumulate in f32; measured worst 1.6e-8 and 2.2e-6, the hierarchical
  trainer, whose groups fold twice a round).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.aggregation import async_buffer as jab
from fedml_tpu.core.aggregation.bucketed import BucketedAggregator as JEngine
from fedml_tpu.core.engine import round_engine as jengine
from fedml_tpu.data import data_loader as jloader
from fedml_tpu.data.dataset import ArrayDataset as JArrayDataset
from fedml_tpu.simulation.vmapped import async_driver as jdrv
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.core.aggregation import async_buffer as tab
from fedml_tpu_torch.core.aggregation.bucketed import BucketedAggregator as TEngine
from fedml_tpu_torch.core.engine import round_engine as tengine
from fedml_tpu_torch.core.resilience import quorum as tq
from fedml_tpu_torch.data import data_loader as tloader
from fedml_tpu_torch.data.dataset import ArrayDataset as TArrayDataset
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.simulation.vmapped import async_driver as tdrv


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch steps: under several test workers a pool of threads
    in each only spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.normal(size=(4, 3))).astype(np.float32),
            "b": (scale * rng.normal(size=(3,))).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in tree.items()}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _of_scale(got, ref):
    """max over leaves of max |got - ref| / max |ref|."""
    return max(float(np.abs(_np(got[k]).astype(np.float64) - _np(ref[k])).max()
                     / np.abs(_np(ref[k])).max()) for k in ref)


class _FakeClient:
    def __init__(self, flagged):
        self.flagged = flagged


class _FakeHealth:
    def __init__(self, flagged_ranks):
        self._clients = {r: _FakeClient(True) for r in flagged_ranks}


# --- the staleness policy ---------------------------------------------------------

def test_staleness_policy_matches_jax():
    for exp in (0.0, 0.5, 1.0, 2.0):
        tp, jp = tab.StalenessPolicy(exponent=exp), jab.StalenessPolicy(exponent=exp)
        assert [tp.weight(s) for s in range(12)] == [jp.weight(s) for s in range(12)]
    assert tab.StalenessPolicy(exponent=0.0).weight(7) == 1.0
    with pytest.raises(ValueError):
        tab.StalenessPolicy(exponent=-0.1)


def test_admission_cut_and_straggler_grace():
    p = tab.StalenessPolicy(max_staleness=10, straggler_grace=1.5, health=_FakeHealth({7}))
    assert p.admission_cut(8) == 10
    assert p.admission_cut(7) == 15  # flagged: ceil(10 * 1.5)
    assert p.admit(12, rank=7) and not p.admit(12, rank=8) and not p.admit(16, rank=7)
    assert tab.StalenessPolicy(max_staleness=10).admission_cut(7) == 10
    args = types.SimpleNamespace(async_staleness_exponent=0.3, async_max_staleness=7,
                                 async_straggler_grace=2.0)
    p = tab.StalenessPolicy.from_args(args, health=_FakeHealth(set()))
    assert (p.exponent, p.max_staleness, p.straggler_grace) == (0.3, 7, 2.0)
    assert p.health is not None and p.as_dict()["health_wired"]


# --- the buffer against JAX's --------------------------------------------------------

# (rank, tree seed, sample_num, client_version); the buffers' versions move
# with their publishes, so a version below the live one is stale
SCRIPT = [(0, 1, 3.0, 0), (1, 2, 1.0, 0), (2, 3, 2.0, 0), (3, 4, 5.0, 0), (4, 5, 1.0, 0),
          (0, 6, 3.0, 0), (1, 7, 1.0, 1), (2, 8, 2.0, 0), (3, 9, 5.0, 1), (4, 10, 1.0, 1),
          (5, 11, 4.0, 0), (0, 12, 3.0, 2), (1, 13, 1.0, 1), (2, 14, 2.0, 2), (3, 15, 5.0, 3),
          (4, 16, 1.0, 3), (5, 17, 4.0, 0), (0, 18, 3.0, 3), (1, 19, 1.0, 4), (2, 20, 2.0, 4),
          (3, 21, 5.0, 0), (4, 22, 1.0, 1), (5, 23, 4.0, 0), (0, 24, 3.0, 5)]


def _drive(buf, to_tree):
    verdicts, versions, models = [], [], []
    for rank, seed, n, v in SCRIPT:
        verdicts.append(buf.submit(rank, to_tree(_tree(seed)), n, client_version=v))
        if buf.ready():
            models.append(buf.publish())
        versions.append(buf.version)
    return verdicts, versions, models


@pytest.mark.parametrize("publish_k,bucket,exponent", [(3, 16, 0.0), (3, 16, 0.5), (5, 2, 0.5),
                                                       (4, 4, 1.0), (6, 4, 0.5)])
def test_buffer_tracks_jax_arrival_by_arrival(publish_k, bucket, exponent):
    """One scripted arrival order with versions, both buffers: identical
    verdicts (max_staleness 2 refuses the stalest) and versions, each publish
    within 1e-6 of JAX's."""
    tbuf = tab.AsyncAggBuffer(publish_k, tab.StalenessPolicy(exponent, max_staleness=2),
                              TEngine(bucket))
    jbuf = jab.AsyncAggBuffer(publish_k, jab.StalenessPolicy(exponent, max_staleness=2),
                              JEngine(bucket_size=bucket))
    tv, tver, tmodels = _drive(tbuf, _t)
    jv, jver, jmodels = _drive(jbuf, lambda t: t)
    assert tv == jv and tver == jver
    assert {tq.ACCEPT, tq.STALE_ACCEPTED, tq.STALE_REJECTED} >= set(tv)
    assert tq.STALE_REJECTED in tv and tq.STALE_ACCEPTED in tv
    assert len(tmodels) == len(jmodels) >= 2
    for got, ref in zip(tmodels, jmodels):
        assert _of_scale(got, jax.device_get(ref)) <= 1e-6
    assert tbuf.statusz()["stale_rejected_total"] == jbuf.statusz()["stale_rejected_total"]
    assert tbuf.last_publish_weight == pytest.approx(jbuf.last_publish_weight, rel=1e-12)


@pytest.mark.parametrize("publish_k,bucket", [(5, 16), (4, 4)])
def test_publish_k_within_a_bucket_is_bit_exact_with_engine_aggregate(publish_k, bucket):
    """The parity anchor: exponent 0 and publish_k == cohort <= bucket
    publishes through engine.aggregate, bit for bit, a window of exactly one
    bucket too (which must stay pending, not fold as it fills)."""
    engine = TEngine(bucket)
    pairs = [(float(i + 1), _t(_tree(i))) for i in range(publish_k)]
    buf = tab.AsyncAggBuffer(publish_k, policy=tab.StalenessPolicy(exponent=0.0), engine=engine)
    for i, (w, t) in enumerate(pairs):
        assert buf.submit(i, t, w, client_version=0) == tq.ACCEPT
    assert buf.statusz()["pending_unfolded"] == publish_k
    _equal(buf.publish(), TEngine(bucket).aggregate(
        [(float(i + 1), _t(_tree(i))) for i in range(publish_k)]))


def test_multibucket_streaming_tracks_aggregate():
    engine = TEngine(4)
    buf = tab.AsyncAggBuffer(publish_k=12, policy=tab.StalenessPolicy(exponent=0.0), engine=engine)
    for i in range(12):
        buf.submit(i, _t(_tree(100 + i)), float(i % 3 + 1), client_version=0)
    assert buf.statusz()["pending_unfolded"] < 12
    out = buf.publish()
    ref = TEngine(4).aggregate([(float(i % 3 + 1), _t(_tree(100 + i))) for i in range(12)])
    assert _of_scale(out, ref) <= 1e-6


@pytest.fixture
def fresh_telemetry():
    t = tel.get_telemetry()
    was = t.enabled
    t.set_enabled(True)
    t.reset()
    yield
    t.reset()
    t.set_enabled(was)


def test_stale_rejected_is_never_folded(fresh_telemetry):
    buf = tab.AsyncAggBuffer(publish_k=4, policy=tab.StalenessPolicy(max_staleness=1))
    buf.version = 3
    assert buf.submit(0, _t(_tree(0)), 1.0, client_version=0) == tq.STALE_REJECTED
    assert buf.merges_total == 0 and buf.depth() == 0 and buf.stale_rejected_total == 1
    assert buf.publish() is None and buf.version == 3
    counters = tel.snapshot()["counters"]
    assert counters[tq.STALE_REJECTED_COUNTER] == 1 and tab.MERGE_COUNTER not in counters


def test_stale_accepted_applies_decayed_weight():
    buf = tab.AsyncAggBuffer(publish_k=2, policy=tab.StalenessPolicy(exponent=1.0,
                                                                      max_staleness=10))
    buf.version = 1
    a, b = _tree(1), _tree(2)
    assert buf.submit(0, _t(a), 2.0, client_version=1) == tq.ACCEPT
    # staleness 1 with exponent 1: weight 4.0 * (1+1)^-1 == 2.0
    assert buf.submit(1, _t(b), 4.0, client_version=0) == tq.STALE_ACCEPTED
    assert buf.stale_accepted_total == 1
    out = buf.publish()
    for k in a:
        np.testing.assert_allclose(out[k].numpy(), (2.0 * a[k] + 2.0 * b[k]) / 4.0, rtol=1e-6)


def test_publish_advances_version_and_resets_window(fresh_telemetry):
    buf = tab.AsyncAggBuffer(publish_k=3, policy=tab.StalenessPolicy(exponent=0.0))
    for i in range(3):
        buf.submit(i, _t(_tree(i)), float(i + 1), client_version=0)
        assert buf.ready() == (i == 2)
    assert buf.publish() is not None
    assert buf.version == 1 and buf.publishes_total == 1
    assert not buf.ready() and buf.depth() == 0
    assert buf.last_publish_merges == 3 and buf.last_publish_weight == pytest.approx(6.0)
    snap = tel.snapshot()
    assert snap["counters"][tab.MERGE_COUNTER] == 3
    assert snap["counters"][tab.PUBLISH_COUNTER] == 1
    assert snap["histograms"][tab.STALENESS_HISTOGRAM]["count"] == 3
    names = [r["name"] for r in snap["spans"]]
    assert names.count("async.merge") == 3 and names.count("async.publish") == 1


def test_staleness_clock_gauges_and_args():
    buf = tab.AsyncAggBuffer(publish_k=2, policy=tab.StalenessPolicy(exponent=0.0))
    buf.submit(4, _t(_tree(0)), 1.0, client_version=0)
    gauges = {name: v for name, _labels, v in buf.prom_gauges()}
    assert gauges["async_buffer_depth"] == 1.0 and gauges["async_model_version"] == 0.0
    buf.submit(9, _t(_tree(1)), 1.0, client_version=0)
    assert buf.statusz()["client_versions"] == {4: 0, 9: 0}
    buf.publish()
    buf.submit(4, _t(_tree(2)), 1.0, client_version=1)
    assert buf.statusz()["client_versions"][4] == 1
    with pytest.raises(ValueError):
        tab.AsyncAggBuffer(publish_k=0)
    args = types.SimpleNamespace(async_publish_k=4, async_staleness_exponent=0.25,
                                 async_max_staleness=6, async_straggler_grace=3.0)
    buf = tab.buffer_from_args(args, health=_FakeHealth(set()))
    assert buf.publish_k == 4 and buf.policy.exponent == 0.25
    assert buf.policy.max_staleness == 6 and buf.policy.health is not None


def test_concurrent_submits_lose_no_merge():
    """submit runs on receive threads: 8 threads x 12 arrivals into one
    buffer (publish_k 96, bucket 4, so the folds run while others submit),
    with a short switch interval. Every merge is counted, every weight
    folded: the publish is the float64 weighted mean within 1e-6."""
    import sys
    import threading

    buf = tab.AsyncAggBuffer(publish_k=96, policy=tab.StalenessPolicy(exponent=0.0),
                             engine=TEngine(4))
    trees = {(t, i): _t(_tree(1000 + 12 * t + i)) for t in range(8) for i in range(12)}

    def worker(t):
        for i in range(12):
            buf.submit(t, trees[(t, i)], float(1 + (t + i) % 5), client_version=0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,), daemon=True) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert buf.merges_total == 96 and buf.ready()
    out = buf.publish()
    total = sum(float(1 + (t + i) % 5) for t, i in trees)
    assert buf.last_publish_weight == total
    for k in out:
        want = sum(float(1 + (t + i) % 5) * trees[(t, i)][k].double() for t, i in trees) / total
        assert float((out[k].double() - want).abs().max() / want.abs().max()) <= 1e-6


# --- snapshot / restore (tests/test_async_buffer.py's cases) ---------------------------

def _fill(buf, n, offset=0):
    for i in range(n):
        buf.submit(i, _t(_tree(50 + offset + i)), float(i + 1), client_version=0)


def test_mid_window_snapshot_restore_then_merges_are_bit_identical():
    a = tab.AsyncAggBuffer(publish_k=6, policy=tab.StalenessPolicy(exponent=0.0),
                           engine=TEngine(4))
    _fill(a, 5)  # one bucket folded into the accumulator, 1 arrival pending
    meta, state = a.export_meta(), a.export_pytree_state()
    assert meta["has_acc"] and len(meta["pending_weights"]) == 1
    assert meta["merges_since_publish"] == 5
    b = tab.AsyncAggBuffer(publish_k=6, policy=tab.StalenessPolicy(exponent=0.0),
                           engine=TEngine(4))
    b.restore(state, meta, template=_t(_tree(0)))
    assert b.depth() == 5 and b.merges_total == a.merges_total
    final = _t(_tree(99))
    a.submit(5, final, 6.0, client_version=0)
    b.submit(5, final, 6.0, client_version=0)
    assert a.ready() and b.ready()
    _equal(a.publish(), b.publish())
    assert a.version == b.version == 1


def test_pending_only_snapshot_keeps_parity_path():
    a = tab.AsyncAggBuffer(publish_k=3, policy=tab.StalenessPolicy(exponent=0.0))
    _fill(a, 2, offset=20)
    meta, state = a.export_meta(), a.export_pytree_state()
    assert not meta["has_acc"] and len(state["pending"]) == 2
    b = tab.AsyncAggBuffer(publish_k=3, policy=tab.StalenessPolicy(exponent=0.0))
    b.restore(state, meta, template=_t(_tree(0)))
    last = _t(_tree(77))
    a.submit(2, last, 3.0, client_version=0)
    b.submit(2, last, 3.0, client_version=0)
    _equal(a.publish(), b.publish())


def test_restore_rebuilds_staleness_clock_and_counters():
    a = tab.AsyncAggBuffer(publish_k=2, policy=tab.StalenessPolicy(max_staleness=1))
    a.version = 2
    a.submit(3, _t(_tree(1)), 1.0, client_version=1)   # stale_accepted
    a.submit(8, _t(_tree(2)), 1.0, client_version=0)   # stale_rejected
    meta, state = a.export_meta(), a.export_pytree_state()
    b = tab.AsyncAggBuffer(publish_k=2, policy=tab.StalenessPolicy(max_staleness=1))
    b.restore(state, meta, template=_t(_tree(0)))
    assert b.version == 2 and b.stale_accepted_total == 1 and b.stale_rejected_total == 1
    assert b.statusz()["client_versions"] == {3: 2}


def test_torn_snapshot_refuses_to_restore():
    a = tab.AsyncAggBuffer(publish_k=4)
    _fill(a, 2)
    meta, state = a.export_meta(), a.export_pytree_state()
    state["pending"] = state["pending"][:1]
    with pytest.raises(ValueError, match="torn"):
        tab.AsyncAggBuffer(publish_k=4).restore(state, meta, template=_t(_tree(0)))


def test_state_template_matches_snapshot_structure():
    """The accumulator is one flat f32 vector over the template's elements
    (the JAX package's is a tree of f32 leaves), and the export is a copy:
    the next fold does not move it."""
    a = tab.AsyncAggBuffer(publish_k=6, engine=TEngine(4))
    _fill(a, 5)
    meta = a.export_meta()
    tmpl = a.state_template(_t(_tree(0)), meta)
    assert tmpl["acc"].dtype == torch.float32 and tmpl["acc"].shape == (15,)
    assert len(tmpl["pending"]) == 1
    snap = a.export_pytree_state()["acc"]
    frozen = snap.clone()
    _fill(a, 4, offset=30)  # folds another bucket into the live accumulator
    assert torch.equal(snap, frozen)
    empty = tab.AsyncAggBuffer(publish_k=2)
    assert empty.state_template(_t(_tree(0)), empty.export_meta()) == {}


# --- the async sinks ---------------------------------------------------------------

def test_async_sinks_and_the_hierarchy_refusal():
    """The buffer's sink; the tree's sink (``as_async_sink`` dispatches on the
    port's ``HierarchyTree``, as JAX does on its own) and
    ``simulate_async_rounds(hierarchy_edges=...)`` run, and the one refusal
    left is the vmapped async API's ``hierarchy_edges``, a knob JAX's API
    does not read either (``tests/test_torch_hierarchy.py`` holds the tree
    against JAX)."""
    from fedml_tpu_torch.core.distributed.hierarchy import HierarchyTree as TTree

    buf = tab.AsyncAggBuffer(publish_k=2, policy=tab.StalenessPolicy(exponent=0.0))
    sink = tengine.as_async_sink(buf)
    assert isinstance(sink, tengine.AsyncBufferSink) and tengine.as_async_sink(sink) is sink
    assert sink.submit(0, _t(_tree(0)), 1.0, 0) == tq.ACCEPT and sink.try_publish() is None
    sink.submit(1, _t(_tree(1)), 1.0, 0)
    version, model = sink.try_publish()
    assert version == 1 == sink.version and sink.publish_k == 2 and sink.high_water == 2
    assert sorted(model) == ["b", "w"] and sink.statusz()["publishes_total"] == 1
    ttree = TTree.build(n_edges=2, publish_k=2, device="cpu")
    for hsink in (tengine.as_async_sink(ttree), tengine.HierarchySink(ttree)):
        assert isinstance(hsink, tengine.HierarchySink) and hsink.raw is ttree
    stats = tdrv.simulate_async_rounds(8, 2, _t(_tree(0)), 1, hierarchy_edges=2)
    assert stats["publishes"] == 1 and stats["merges"] >= 4
    with pytest.raises(NotImplementedError, match="hierarchy_edges.*simulate_async_rounds"):
        tdrv.VmapAsyncFedAvgAPI(types.SimpleNamespace(hierarchy_edges=2), None, None, None)


# --- the event simulator ---------------------------------------------------------

def _numpy_train_batch(step=0.01):
    """One numpy delta function for both packages: pure in (client,
    version), the model read through numpy."""
    def batch(model, client_ids, version):
        out = {}
        for name in ("w", "b"):
            base = np.asarray(_np(model[name]), np.float32)
            out[name] = np.stack([
                base + np.float32(step) * np.random.default_rng([7, int(c), int(version)])
                .standard_normal(base.shape).astype(np.float32) for c in client_ids])
        return out
    return batch


def _recording(sink_cls):
    class Recording(sink_cls):
        def __init__(self, buf):
            super().__init__(buf)
            self.trace = []

        def submit(self, rank, tree, weight, client_version):
            verdict = super().submit(rank, tree, weight, client_version)
            self.trace.append((int(rank), int(client_version), verdict))
            return verdict
    return Recording


def test_event_sim_trace_matches_jax():
    """Both packages' AsyncEventSim over one numpy train_batch, a delay model
    and a staleness cut that rejects some arrivals: the same event trace and
    staleness samples, publishes within 1e-6 of their scale."""
    n, k, pubs = 40, 6, 5
    runs = {}
    for name, pkg_sink, buf, to_model, drv in (
            ("torch", tengine.AsyncBufferSink,
             tab.AsyncAggBuffer(k, tab.StalenessPolicy(0.5, max_staleness=1), TEngine(4)),
             _t, tdrv),
            ("jax", jengine.AsyncBufferSink,
             jab.AsyncAggBuffer(k, jab.StalenessPolicy(0.5, max_staleness=1),
                                JEngine(bucket_size=4)), lambda t: t, jdrv)):
        sink = _recording(pkg_sink)(buf)
        train = _numpy_train_batch()
        if name == "torch":
            def train(model, ids, v, _f=train):
                return _t(_f(model, ids, v))
        models = []
        sim = drv.AsyncEventSim(sink, train, n, initial_model=to_model(_tree(3)),
                                weights=np.arange(1, n + 1, dtype=np.float64),
                                delay=drv.DelayModel(n, heterogeneity=0.8, seed=4),
                                gen_batch=8, on_publish=lambda v, m, _l=models: _l.append(m))
        stats = sim.run(pubs)
        runs[name] = (sink.trace, sim.staleness_samples, models, stats)
    (tt, ts, tm, tst), (jt, js, jm, jst) = runs["torch"], runs["jax"]
    assert tt == jt and ts == js
    assert any(v == tq.STALE_REJECTED for _, _, v in tt)
    assert len(tm) == len(jm) == pubs
    for got, ref in zip(tm, jm):
        assert _of_scale(got, jax.device_get(ref)) <= 1e-6
    for key in ("merges", "publishes", "stale_rejected", "virtual_time", "gen_dispatches",
                "staleness_mean", "buffer_high_water"):
        assert tst[key] == jst[key], key


def test_synthetic_delta_is_pure_in_client_and_version():
    """Client c's delta on version v is the same whatever batch generates
    it; its noise has std ~ step_scale; another (c, v) draws other noise."""
    f = tdrv.make_synthetic_delta_fn(seed=3, step_scale=0.01)
    model = {"w": torch.zeros(64, 32), "b": torch.ones(32), "n": torch.tensor([5])}
    a = f(model, np.array([4, 9, 2]), 5)
    b = f(model, np.array([2]), 5)
    c = f(model, np.array([2, 4]), 6)
    assert torch.equal(a["w"][2], b["w"][0]) and torch.equal(a["b"][2], b["b"][0])
    assert not torch.equal(a["w"][2], c["w"][0]) and not torch.equal(a["w"][0], a["w"][2])
    assert a["n"].shape == (3, 1) and int(a["n"][1]) == 5
    std = float(a["w"].std())
    assert 0.0095 < std < 0.0105, std
    assert abs(float((a["b"] - 1.0).std()) - 0.01) < 0.002


def test_async_sim_same_seed_is_bit_deterministic_and_terminates():
    def run(seed):
        models = []
        sim = tdrv.AsyncEventSim(
            tab.AsyncAggBuffer(8, tab.StalenessPolicy(exponent=0.5), TEngine(16)),
            tdrv.make_synthetic_delta_fn(seed=seed), 32, initial_model=_t(_tree(7)),
            delay=tdrv.DelayModel(32, seed=seed), gen_batch=16,
            on_publish=lambda v, m: models.append((v, m)))
        return sim.run(3), models
    (s1, m1), (s2, m2) = run(3), run(3)
    assert s1["publishes"] == s2["publishes"] == 3 and s1 == {**s2, "server_seconds":
                                                               s1["server_seconds"]}
    assert [v for v, _ in m1] == [v for v, _ in m2] == [1, 2, 3]
    for (_, a), (_, b) in zip(m1, m2):
        _equal(a, b)
    assert s1["merges"] >= 24 and s1["buffer_high_water"] >= 1
    hostile = tdrv.AsyncEventSim(
        tab.AsyncAggBuffer(4, tab.StalenessPolicy(max_staleness=0)),
        tdrv.make_synthetic_delta_fn(seed=0), 16, initial_model=_t(_tree(1)),
        delay=tdrv.DelayModel(16, seed=0), gen_batch=8)
    assert hostile.run(publish_target=100, max_events=300)["publishes"] < 100


def test_delay_model_is_bit_for_bit_jax():
    t, j = tdrv.DelayModel(50, 1.3, 0.7, seed=9), jdrv.DelayModel(50, 1.3, 0.7, seed=9)
    assert np.array_equal(t.base, j.base)
    ids = np.arange(50)[::-1]
    assert np.array_equal(t.draw(ids), j.draw(ids))


def test_simulate_async_rounds_on_a_state_dict():
    stats = tdrv.simulate_async_rounds(64, 8, _t(_tree(5)), 3, gen_batch=16, seed=2)
    assert stats["publishes"] == 3 and stats["n_clients"] == 64 and stats["gen_dispatches"] >= 1


# --- the trainers against JAX -----------------------------------------------------

PARROT = dict(random_seed=0, dataset="mnist", data_cache_dir="", partition_method="hetero",
              partition_alpha=0.5, model="lr", client_num_in_total=2, client_num_per_round=2,
              comm_round=3, epochs=1, batch_size=64, client_optimizer="sgd",
              learning_rate=0.03, weight_decay=0.001, frequency_of_the_test=1)
CNN = dict(PARROT, dataset="cifar10", model="cnn_cifar", batch_size=16, learning_rate=0.01,
           momentum=0.9, weight_decay=5e-4, comm_round=2)
TRAINERS = {
    "async_fedavg": dict(backend="sp", federated_optimizer="Async_FedAvg", async_alpha=0.6,
                         async_staleness_exponent=0.5),
    "hierarchical": dict(backend="sp", federated_optimizer="HierarchicalFL", group_num=2,
                         group_comm_round=2, client_num_in_total=3, client_num_per_round=3),
    "vmap_async": dict(backend="vmap", federated_optimizer="FedAvg", async_rounds=True,
                       async_publish_k=2, async_staleness_exponent=0.5, async_max_staleness=3,
                       client_num_in_total=3, client_num_per_round=3),
}
API = {"async_fedavg": "AsyncFedAvgAPI", "hierarchical": "HierarchicalTrainer",
       "vmap_async": "VmapAsyncFedAvgAPI"}


def _final(api):
    trainer = getattr(api, "model_trainer", None)
    return trainer.get_model_params() if trainer is not None else api.model.params


def _cut_cifar_f64(load, ds_cls, args):
    """The CIFAR-10 surrogate in 3 hetero shards cut to 40, 24 and 33
    examples, the test set to 128 (a cut of scale, for CPU time); images in
    float64."""
    d = load(args)
    cut = {0: 40, 1: 24, 2: 33}
    local = {c: ds_cls(s.x[:cut[c]].astype(np.float64), s.y[:cut[c]]) for c, s in d[5].items()}
    test = ds_cls(d[3].x[:128].astype(np.float64), d[3].y[:128])
    return (sum(len(s) for s in local.values()), 128, d[2], test,
            {c: len(s) for c, s in local.items()}, local, {c: test for c in local}, d[7])


def _run_jax(kw, f64):
    args = fedml_tpu.init(fedml_tpu.default_config("simulation", **kw))
    dataset = _cut_cifar_f64(jloader.load, JArrayDataset, args) if f64 else \
        fedml_tpu.data.load(args)[0]
    model = fedml_tpu.model.create(args, dataset[-1])
    p0 = jax.device_get(model.params)
    if f64:
        model.params = jax.tree.map(lambda leaf: jnp.asarray(leaf, jnp.float64), p0)
    runner = fedml_tpu.FedMLRunner(args, "cpu", dataset, model)
    runner.run()
    api = runner.runner.fl_trainer
    return p0, api, jax.device_get(_final(api))


def _run_port(kw, p0, f64):
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw))
    dataset = _cut_cifar_f64(tloader.load, TArrayDataset, args) if f64 else \
        fedml_tpu_torch.data.load(args)[0]
    model = fedml_tpu_torch.model.create(args, dataset[-1], device="cpu")
    model.module.load_state_dict(params_from_jax(p0))
    model.module.to(torch.float64 if f64 else torch.float32)
    model.params = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
    runner.run()
    api = runner.runner.fl_trainer
    return api, params_to_jax(_final(api))


def _update_of_scale(got, ref, start):
    """max |got - ref| / max |ref - start| over all leaves (flax layout)."""
    g, r, s = (dict(jax.tree_util.tree_leaves_with_path(t)) for t in (got, ref, start))
    num = max(float(np.abs(np.asarray(g[k], np.float64) - np.asarray(r[k], np.float64)).max())
              for k in r)
    den = max(float(np.abs(np.asarray(r[k], np.float64) - np.asarray(s[k], np.float64)).max())
              for k in r)
    return num / den


@pytest.mark.parametrize("model", ["lr", "cnn_f64"])
@pytest.mark.parametrize("trainer", list(TRAINERS))
def test_trainer_tracks_jax(trainer, model):
    f64 = model == "cnn_f64"
    kw = dict(CNN if f64 else PARROT, **TRAINERS[trainer])
    if f64:
        with jax.enable_x64(True):
            p0, japi, ref_w = _run_jax(kw, True)
    else:
        p0, japi, ref_w = _run_jax(kw, False)
    api, w = _run_port(kw, p0, f64)
    assert type(api).__name__ == API[trainer]
    hist, ref = api.metrics_history, japi.metrics_history
    assert len(hist) == len(ref) >= 2
    assert [m["round"] for m in hist] == [m["round"] for m in ref]
    for g, r in zip(hist, ref):
        assert g["test_total"] == r["test_total"]
        if f64:
            assert g["test_correct"] == r["test_correct"]
            np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=1e-7)
        else:
            assert abs(g["test_correct"] - r["test_correct"]) <= 2, (g, r)
            np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=1e-4, atol=1e-6)
    if f64:
        assert all(_np(v).dtype == np.float64 for v in jax.tree.leaves(w))
        assert _update_of_scale(w, ref_w, p0) <= 5e-4
    else:
        assert _update_of_scale(w, ref_w, jax.tree.map(np.zeros_like, ref_w)) <= 1e-5
    if trainer == "hierarchical":
        assert np.array_equal(api.group_indexes, japi.group_indexes)
        assert api.group_to_clients == japi.group_to_clients
    if trainer == "vmap_async":
        assert api.stats["publishes"] == kw["comm_round"] and api.stats["merges"] >= 4
