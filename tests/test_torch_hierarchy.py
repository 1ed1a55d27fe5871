"""The port's edge->regional->root tree (``core/distributed/hierarchy.py``),
its async sink and ``simulate_async_rounds(hierarchy_edges=...)`` against
the JAX package's, on the CPU.

The same seeded numpy trees (``tests/test_torch_async.py``'s helpers) go
into both packages' trees. Tolerances:

- versions, forwards, window weights, verdicts, the event traces and the
  staleness samples: identical;
- every published model: within 1e-6 of each leaf's scale of JAX's, the
  flat async parity bound of ``tests/test_torch_async.py`` (f32 folds in
  other summation orders; each tier adds one fold of at most a bucket);
- a tree with unit weights and exponent 0: its root publish within rtol
  1e-5 of the plain mean (JAX's own test's limit).
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.core.aggregation import async_buffer as jab
from fedml_tpu.core.aggregation.bucketed import BucketedAggregator as JEngine
from fedml_tpu.core.distributed.hierarchy import HierarchyTree as JTree
from fedml_tpu.core.engine import round_engine as jengine
from fedml_tpu.simulation.vmapped import async_driver as jdrv
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.core.aggregation import async_buffer as tab
from fedml_tpu_torch.core.aggregation.bucketed import BucketedAggregator as TEngine
from fedml_tpu_torch.core.distributed import hierarchy as thier
from fedml_tpu_torch.core.distributed.hierarchy import HierarchyTree as TTree
from fedml_tpu_torch.core.engine import round_engine as tengine
from fedml_tpu_torch.core.telemetry import sketches as tsk
from fedml_tpu_torch.simulation.vmapped import async_driver as tdrv
from tests.test_torch_async import _np, _numpy_train_batch, _of_scale, _recording, _t, _tree

PARITY_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch folds: under several test workers a pool of threads
    in each only spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_sketch_state():
    """A tree registers its root as the process's sketch provider (last-built
    tree wins): keep one test's tree out of the next."""
    tsk.reset()
    yield
    tsk.reset()


def _pair(n_edges, publish_k, exponent=0.0, bucket=16, **kw):
    ttree = TTree.build(n_edges=n_edges, publish_k=publish_k,
                        policy=tab.StalenessPolicy(exponent=exponent),
                        engine=TEngine(bucket), device="cpu", **kw)
    jtree = JTree.build(n_edges=n_edges, publish_k=publish_k,
                        policy=jab.StalenessPolicy(exponent=exponent),
                        engine=JEngine(bucket_size=bucket), **kw)
    return ttree, jtree


# --- JAX's TestHierarchy cases, in both packages -------------------------------

def test_edge_regional_root_cascade_and_version_sync():
    m = [_tree(200 + i) for i in range(4)]
    ttree, jtree = _pair(2, 2, regional_fanout=2)
    ttree_init = TTree.build(n_edges=1, device="cpu", initial_model=_t(_tree(0)))
    assert ttree_init.latest_model() is not None and ttree_init.version == 0
    assert len(ttree.regionals) == len(jtree.regionals) == 1
    # ranks route rank % n_edges: 0,2 -> edge-0; 1,3 -> edge-1
    for rank in range(4):
        assert ttree.submit(rank, _t(m[rank]), 1.0, client_version=0) == \
            jtree.submit(rank, m[rank], 1.0, client_version=0)
    assert ttree.version == jtree.version == 1
    got, ref = ttree.latest_model(), jax.device_get(jtree.latest_model())
    assert _of_scale(got, ref) <= PARITY_TOL
    # unit weights + exponent 0: the root publish is the plain mean
    for k in got:
        np.testing.assert_allclose(_np(got[k]), np.mean([x[k] for x in m], axis=0), rtol=1e-5)
    # downward sync: every tier now judges staleness against version 1
    assert all(node.buffer.version == 1 for node in ttree.nodes())
    assert [e.forwards for e in ttree.edges] == [e.forwards for e in jtree.edges] == [1, 1]
    assert sum(n.forwards for n in ttree.nodes()) == 3
    tdoc, jdoc = ttree.statusz(), jtree.statusz()
    assert tdoc["version"] == jdoc["version"] == 1
    assert set(tdoc["nodes"]) == set(jdoc["nodes"]) == {"root", "regional-0", "edge-0", "edge-1"}
    for name in tdoc["nodes"]:
        for key in ("tier", "parent", "children", "forwards", "fleet_merges"):
            assert tdoc["nodes"][name][key] == jdoc["nodes"][name][key], (name, key)
    def rows(tree):
        return sorted((name, sorted(lbl.items()), v) for name, lbl, v in tree.prom_gauges())

    assert rows(ttree) == rows(jtree)


def test_edge_window_weight_forwards_upward():
    """An edge publish forwards as ONE submission weighted by the window's
    streamed weight, so unbalanced edges keep sample weighting; with
    exponent 0.5 a stale arrival's decay rides up in that weight."""
    for exponent, versions, expect in ((0.0, (0, 0), 4.0), (0.5, (0, -3), 3.0 + 0.5)):
        ttree, jtree = _pair(2, 2, exponent=exponent, regional_fanout=2)
        for tree in (ttree, jtree):
            for node in tree.nodes():
                node.buffer.version = 3  # a root at version 3
        for tree, conv in ((ttree, _t), (jtree, lambda x: x)):
            tree.submit(0, conv(_tree(1)), 3.0, client_version=3 + versions[0])
            tree.submit(2, conv(_tree(2)), 1.0, client_version=3 + versions[1])
        assert ttree.edges[0].buffer.last_publish_weight == \
            jtree.edges[0].buffer.last_publish_weight == pytest.approx(expect)
        assert ttree.regionals[0].buffer.export_meta()["pending_weights"] == \
            jtree.regionals[0].buffer.export_meta()["pending_weights"] == [pytest.approx(expect)]


def test_single_edge_degenerate_tree():
    ttree, jtree = _pair(1, 2)
    for tree, conv in ((ttree, _t), (jtree, lambda x: x)):
        tree.submit(0, conv(_tree(3)), 1.0, client_version=0)
        tree.submit(1, conv(_tree(4)), 1.0, client_version=0)
        assert tree.version == 1 and tree.latest_model() is not None
    assert _of_scale(ttree.latest_model(), jax.device_get(jtree.latest_model())) <= PARITY_TOL


def test_build_rejects_zero_edges_and_foreign_devices():
    for build in (TTree.build, JTree.build):
        with pytest.raises(ValueError):
            build(n_edges=0)
    if not torch.cuda.is_available():  # no silent CPU fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            TTree.build(n_edges=2)
    tree = TTree.build(n_edges=2, device="cpu")
    assert tree.device == torch.device("cpu")
    with pytest.raises(ValueError, match="folds on cpu"):
        tree.submit(0, {"w": torch.zeros(3, device="meta")}, 1.0, client_version=0)
    with pytest.raises(ValueError, match="folds on cpu"):
        TTree.build(n_edges=2, device="cpu", initial_model={"w": torch.zeros(3, device="meta")})


def test_forwards_pass_the_edge_publish_by_reference_and_count():
    """No copy between tiers: the regional's pending entry IS the edge's
    published state dict; the forward counter counts every forward."""
    tree = TTree.build(n_edges=2, regional_fanout=2, publish_k=2, root_publish_k=2,
                       policy=tab.StalenessPolicy(exponent=0.0), device="cpu")
    seen = []
    orig = tree.regionals[0]._submit_from_child

    def spy(child, weight, model):
        seen.append(model)
        return orig(child, weight, model)

    tree.regionals[0]._submit_from_child = spy
    c0 = tel.counter(thier.FORWARD_COUNTER).value
    with tel.activated(None):
        for rank in (0, 2):
            tree.submit(rank, _t(_tree(rank)), 1.0, client_version=0)
    pending = tree.regionals[0].buffer._pending
    assert len(seen) == 1 and pending[0][1] is seen[0]
    for rank in (1, 3):
        tree.submit(rank, _t(_tree(rank)), 1.0, client_version=0)
    assert tel.counter(thier.FORWARD_COUNTER).value - c0 == \
        sum(n.forwards for n in tree.nodes()) == 3
    names = [r["name"] for r in tel.snapshot()["spans"]]
    assert "hierarchy.publish" in names and "hierarchy.version_sync" in names


# --- the async sink and the event simulator over a tree --------------------------

def test_hierarchy_sink_version_watch():
    """JAX's tests/test_round_engine.py HierarchySink case, in both packages."""
    outs = []
    for eng, build, conv in ((tengine, lambda **k: TTree.build(device="cpu", **k), _t),
                             (jengine, JTree.build, lambda x: x)):
        tree = build(n_edges=2, publish_k=1, root_publish_k=1)
        sink = eng.as_async_sink(tree)
        assert isinstance(sink, eng.HierarchySink) and eng.as_async_sink(sink) is sink
        assert sink.publish_k == 1 and sink.try_publish() is None  # nothing moved yet
        sink.submit(0, conv({"w": np.full((3,), 4.0, np.float32)}), 1.0, sink.version)
        version, model = sink.try_publish()
        assert version == int(tree.version) == 1 and sink.high_water >= 1
        assert sink.try_publish() is None  # same version -> no republish
        outs.append(_np(model["w"]))
    assert np.array_equal(outs[0], outs[1])


def _sim_pair(n, tree_kw, pubs, weights=None, seed=4, gen_batch=8):
    runs = {}
    for name, build, eng_mod, drv, to_model in (
            ("torch", lambda **k: TTree.build(device="cpu", **k), tengine, tdrv, _t),
            ("jax", JTree.build, jengine, jdrv, lambda t: t)):
        kw = dict(tree_kw)
        kw["policy"] = (tab if name == "torch" else jab).StalenessPolicy(
            kw.pop("exponent"), max_staleness=kw.pop("max_staleness"))
        kw["engine"] = TEngine(4) if name == "torch" else JEngine(bucket_size=4)
        tree = build(**kw)
        sink = _recording(eng_mod.HierarchySink)(tree)
        train = _numpy_train_batch()
        if name == "torch":
            def train(model, ids, v, _f=train):
                return _t(_f(model, ids, v))
        models = []
        sim = drv.AsyncEventSim(sink, train, n, initial_model=to_model(_tree(3)),
                                weights=weights, delay=drv.DelayModel(n, heterogeneity=0.8,
                                                                      seed=seed),
                                gen_batch=gen_batch,
                                on_publish=lambda v, m, _l=models: _l.append((v, m)))
        runs[name] = (sink.trace, sim.staleness_samples, models, sim.run(pubs), tree)
    return runs["torch"], runs["jax"]


def test_event_sim_over_a_tree_tracks_jax_publish_by_publish():
    """A 3-edge tree, fanout 2, exponent 0.5 and a staleness cut: the same
    event trace (client, version, verdict), staleness samples and versions,
    every root publish within PARITY_TOL of JAX's."""
    (tt, ts, tm, tst, ttree), (jt, js, jm, jst, jtree) = _sim_pair(
        30, dict(n_edges=3, regional_fanout=2, publish_k=3, exponent=0.5, max_staleness=2),
        pubs=4, weights=np.arange(1, 31, dtype=np.float64))
    assert tt == jt and ts == js and max(ts) > 0
    assert [v for v, _ in tm] == [v for v, _ in jm] == [1, 2, 3, 4]
    for (_, got), (_, ref) in zip(tm, jm):
        assert _of_scale(got, jax.device_get(ref)) <= PARITY_TOL
    for key in ("merges", "publishes", "stale_rejected", "virtual_time", "gen_dispatches",
                "staleness_mean", "staleness_p99", "buffer_high_water"):
        assert tst[key] == jst[key], key
    assert [n.forwards for n in ttree.nodes()] == [n.forwards for n in jtree.nodes()]
    assert [n.buffer.merges_total for n in ttree.nodes()] == \
        [n.buffer.merges_total for n in jtree.nodes()]
    # regionals fold decayed window weights, not sample counts
    assert ttree.regionals[0].buffer.last_publish_weight == \
        pytest.approx(jtree.regionals[0].buffer.last_publish_weight)


class _Installing:
    """Record every model an AsyncEventSim installs (its publishes)."""

    def __init__(self, base):
        self.base, self.models = base, []

    def __call__(self, *a, **k):
        sim = self.base(*a, **k)
        install = sim._install_model

        def record(version, model):
            self.models.append((version, model))
            install(version, model)

        sim._install_model = record
        return sim


def test_simulate_async_rounds_with_hierarchy_edges_tracks_jax(monkeypatch):
    """simulate_async_rounds(hierarchy_edges=2) in both packages, both driven
    by one numpy train_batch: the same stats and each publish within
    PARITY_TOL."""
    batch = _numpy_train_batch()
    monkeypatch.setattr(tdrv, "make_synthetic_delta_fn",
                        lambda seed=0: lambda m, ids, v: _t(batch(m, ids, v)))
    monkeypatch.setattr(jdrv, "make_synthetic_delta_fn", lambda seed=0: batch)
    recs = {}
    for name, drv, template in (("torch", tdrv, _t(_tree(5))), ("jax", jdrv, _tree(5))):
        rec = _Installing(drv.AsyncEventSim)
        monkeypatch.setattr(drv, "AsyncEventSim", rec)
        stats = drv.simulate_async_rounds(24, 2, template, 3, hierarchy_edges=2, gen_batch=8,
                                          seed=1)
        recs[name] = (stats, rec.models)
    (tst, tm), (jst, jm) = recs["torch"], recs["jax"]
    assert tst["publishes"] == jst["publishes"] == 3
    for key in ("merges", "stale_rejected", "virtual_time", "gen_dispatches",
                "staleness_mean", "staleness_p50", "staleness_p99", "buffer_high_water"):
        assert tst[key] == jst[key], key
    assert [v for v, _ in tm] == [v for v, _ in jm] == [1, 2, 3]
    for (_, got), (_, ref) in zip(tm, jm):
        assert _of_scale(got, jax.device_get(ref)) <= PARITY_TOL


def test_simulate_async_rounds_builds_the_tree_on_the_templates_device(monkeypatch):
    built = []
    orig = TTree.build.__func__

    def build(cls, *a, **k):
        tree = orig(cls, *a, **k)
        built.append((a, k, tree))
        return tree

    monkeypatch.setattr(TTree, "build", classmethod(build))
    stats = tdrv.simulate_async_rounds(16, 2, _t(_tree(5)), 2, hierarchy_edges=3, gen_batch=8)
    assert stats["publishes"] == 2 and len(built) == 1
    (a, k, tree) = built[0]
    assert a == (3,) and k["publish_k"] == 2 and tree.device == torch.device("cpu")
    assert len(tree.edges) == 3 and tree.version == 2
