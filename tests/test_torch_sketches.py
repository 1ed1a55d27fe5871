"""The port's fleet sketches (``core/telemetry/sketches.py``, a copy of the
JAX package's) and the fleet view's sketch half (``core/telemetry/fleet.py``)
against the JAX package's, on the CPU.

Everything here is host numpy with seeded splitmix64 hashing, so the
comparisons are exact:

- each sketch's ``to_bytes()`` and ``FleetSketches.to_wire()`` byte-equal to
  JAX's for the same observations, but for the wire's two clock counters
  (``observe_ns``, ``merge_ns``: each package's own ``perf_counter_ns``),
  which are left out;
- a JAX wire parses in the port and the port's in JAX, and a wire merged
  into the other package's ``FleetTelemetry`` gives the same sketch view;
- the fleet's exact and sketch-only modes, child slots, summaries and trace
  summary lane equal JAX's for the same deltas;
- after ``flush_sketches`` the root's ``sketch_view()`` of a port tree equals
  the flat merge of the same observations, bucket for bucket, and JAX's
  root view of the same tree.

Each test resets both packages' process-wide sketch state (the active
provider is "last-built tree wins").
"""

import json

import numpy as np
import pytest
import torch

from fedml_tpu.core import telemetry as jtel
from fedml_tpu.core.distributed.hierarchy import HierarchyTree as JTree
from fedml_tpu.core.telemetry import fleet as jfleet
from fedml_tpu.core.telemetry import sketches as jsk
from fedml_tpu_torch.core import telemetry as ttel
from fedml_tpu_torch.core.distributed.hierarchy import HierarchyTree as TTree
from fedml_tpu_torch.core.telemetry import fleet as tfleet
from fedml_tpu_torch.core.telemetry import sketches as tsk


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The trees fold small tensors: under several test workers a pool of
    threads in each only spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_sketch_state():
    tsk.reset()
    jsk.reset()
    yield
    tsk.reset()
    jsk.reset()


def _train_delta(dur_s, round_idx=0, error=False):
    rec = {"name": "client.train", "t0_ns": 0, "dur_ns": int(dur_s * 1e9),
           "attrs": {"round": round_idx}}
    if error:
        rec["error"] = True
    return {"spans": [rec]}


def _no_clock(wire):
    out = json.loads(json.dumps(wire))
    for k in ("observe_ns", "merge_ns"):
        out["c"].pop(k, None)
    return out


def _snap(doc):
    """A sketch snapshot without its two clock fields."""
    out = json.loads(json.dumps(doc))
    for k in ("observe_ms", "merge_ms"):
        out.pop(k, None)
    return out


def _feed(mod, seed, n=400, offset=0):
    rng = np.random.default_rng(seed)
    fs = mod.FleetSketches()
    ranks = np.arange(offset, offset + n)
    fs.observe_round_times(ranks, rng.lognormal(0.0, 1.2, size=n))
    fs.observe_delta_norms(ranks, rng.uniform(0.5, 2.0, size=n), n_outliers=3)
    fs.observe_stalenesses(ranks, rng.integers(0, 5, size=n).astype(np.float64))
    for r in range(5):
        fs.observe_round_time(int(offset + r), 10.0 + r)
        fs.observe_staleness(int(offset + r), float(r))
        fs.observe_delta_norm(int(offset + r), 1.5, outlier=r == 0)
    return fs


# --- the sketches, byte for byte ------------------------------------------------

DISTS = {
    "lognormal": lambda rng, n: rng.lognormal(0.0, 1.5, size=n),
    "uniform": lambda rng, n: rng.uniform(1e-3, 100.0, size=n),
    "with_zeros": lambda rng, n: np.concatenate([np.zeros(7), rng.exponential(2.0, n - 7)]),
}


@pytest.mark.parametrize("dist", sorted(DISTS))
def test_quantile_sketch_bytes_equal_jax(dist):
    rng = np.random.default_rng(3)
    vals = DISTS[dist](rng, 2000)
    t, j = tsk.QuantileSketch(alpha=0.01), jsk.QuantileSketch(alpha=0.01)
    t.add_many(vals[:1500])
    j.add_many(vals[:1500])
    for v in vals[1500:]:
        t.add(float(v))
        j.add(float(v))
    assert t.to_bytes() == j.to_bytes()
    for q in (0.5, 0.9, 0.99, 0.999):
        assert t.quantile(q) == j.quantile(q)
    back = tsk.QuantileSketch.from_bytes(j.to_bytes())
    assert back == t and jsk.QuantileSketch.from_bytes(t.to_bytes()).to_bytes() == j.to_bytes()


def test_topk_and_cardinality_bytes_equal_jax():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 5000, size=3000)
    weights = rng.exponential(1.0, size=3000)
    tt, jt = tsk.TopK(k=16), jsk.TopK(k=16)
    tt.add_many(keys, weights)
    jt.add_many(keys, weights)
    for name in ("rank-a", "rank-b", 77):
        tt.add(name, 50.0)
        jt.add(name, 50.0)
    assert tt.to_bytes() == jt.to_bytes() and tt.topk() == jt.topk()
    th, jh = tsk.CardinalitySketch(), jsk.CardinalitySketch()
    th.add_many(keys)
    jh.add_many(keys)
    th.add("silo-x")
    jh.add("silo-x")
    assert th.to_bytes() == jh.to_bytes() and th.estimate() == jh.estimate()
    assert tsk.TopK.from_bytes(jt.to_bytes()).to_bytes() == jt.to_bytes()
    assert jsk.CardinalitySketch.from_bytes(th.to_bytes()).to_bytes() == th.to_bytes()


def test_fleet_wire_equal_jax_and_parses_both_ways():
    t, j = _feed(tsk, 11), _feed(jsk, 11)
    assert tsk.WIRE_VERSION == jsk.WIRE_VERSION
    assert _no_clock(t.to_wire()) == _no_clock(j.to_wire())
    # a JAX wire parses in the port and the reverse, unchanged
    assert _no_clock(tsk.FleetSketches.from_wire(j.to_wire()).to_wire()) == \
        _no_clock(j.to_wire())
    assert _no_clock(jsk.FleetSketches.from_wire(t.to_wire()).to_wire()) == \
        _no_clock(t.to_wire())
    assert _snap(t.snapshot()) == _snap(j.snapshot())
    with pytest.raises(ValueError):
        tsk.FleetSketches.from_wire({"v": 99})


def test_merges_equal_jax_and_are_associative():
    ta, tb, tc = (_feed(tsk, s, offset=1000 * s) for s in (1, 2, 3))
    ja, jb, jc = (_feed(jsk, s, offset=1000 * s) for s in (1, 2, 3))
    left = ta.copy().merge(tb).merge(tc)
    right = ta.copy().merge(tb.copy().merge(tc))
    assert _no_clock(left.to_wire()) == _no_clock(ja.copy().merge(jb).merge(jc).to_wire())
    assert _no_clock(right.to_wire()) == _no_clock(ja.copy().merge(jb.copy().merge(jc)).to_wire())
    # quantile buckets and registers are integers: associative exactly; the
    # count-min table sums floats, within 1e-9 (JAX's own test's limit)
    for fam in tsk.FLEET_FAMILIES:
        assert left.quantiles[fam] == right.quantiles[fam]
    assert np.array_equal(left.clients.registers, right.clients.registers)
    assert np.allclose(left.offenders.table, right.offenders.table, atol=1e-9)
    # a JAX sketch merges into a port sketch and the reverse
    assert _no_clock(ta.copy().merge(tsk.FleetSketches.from_wire(jb.to_wire())).to_wire()) == \
        _no_clock(ja.copy().merge(jsk.FleetSketches.from_wire(tb.to_wire())).to_wire())


def test_prom_gauges_and_riders_equal_jax():
    t, j = _feed(tsk, 13), _feed(jsk, 13)
    assert t.prom_gauges() == j.prom_gauges()
    tsk.set_active_provider(lambda: t)
    jsk.set_active_provider(lambda: j)
    assert tsk.prom_gauges() == jsk.prom_gauges()

    class Store:
        def __init__(self):
            self.gauges = {}

        def record_gauge(self, name, value):
            self.gauges[name] = value

    ts, js = Store(), Store()
    tsk.tsdb_collector(ts)
    jsk.tsdb_collector(js)
    assert ts.gauges == js.gauges and "fleet.round_time_p99" in ts.gauges
    assert _snap(tsk.statusz_snapshot()) == _snap(jsk.statusz_snapshot())
    tsk.reset()
    assert tsk.get_active() is None and tsk.statusz_snapshot() is None


def test_budget_and_threshold_match_jax(monkeypatch):
    script = [("admit", "a", 15), ("admit", "b", 10), ("release", "a"), ("admit", "b", 10),
              ("admit", "c", 300), ("admit", "c", 4)]
    docs = []
    for mod in (tsk, jsk):
        b = mod.TelemetryCardinalityBudget(max_series=20, per_family=16)
        out = [b.admit(*a) if op == "admit" else b.release(*a) for op, *a in script]
        docs.append((out, b.snapshot(), b.prom_gauges()))
    assert docs[0] == docs[1]
    monkeypatch.setenv("FEDML_FLEET_SKETCH_THRESHOLD", "9")
    assert tsk.exact_threshold() == jsk.exact_threshold() == 9


# --- the fleet view's sketch half -------------------------------------------------

def _fleet_script(mod, monkeypatch, threshold):
    monkeypatch.setenv("FEDML_FLEET_SKETCH_THRESHOLD", str(threshold))
    f = mod.FleetTelemetry()
    out = [f.merge_client_delta(r, _train_delta(1.0 + 0.25 * r)) for r in range(10)]
    out.append(f.merge_client_delta(3, _train_delta(2.0, error=True)))
    out.append(f.merge_client_delta(4, _train_delta(9.0), direct=False))
    out.append(f.merge_client_delta(50, _train_delta(3.0), direct=False))
    summary = f.summary()
    return f, out, summary


@pytest.mark.parametrize("threshold", [4, 256])
def test_exact_and_sketch_only_modes_match_jax(monkeypatch, threshold):
    tf, tout, tsum = _fleet_script(tfleet, monkeypatch, threshold)
    jf, jout, jsum = _fleet_script(jfleet, monkeypatch, threshold)
    assert tout == jout and tf.sketch_mode == jf.sketch_mode == (threshold == 4)
    assert tf.ranks == jf.ranks and tf.sketch_only_merges == jf.sketch_only_merges
    tsum["sketches"], jsum["sketches"] = _snap(tsum["sketches"]), _snap(jsum["sketches"])
    assert tsum == jsum
    # direct=False replays feed no sketch: 10 round times, the failure none
    assert tf.sketch_view().quantiles["round_time_s"].count == 10
    assert _no_clock(tf.wire_view()) == _no_clock(jf.wire_view())
    if threshold == 4:
        assert tf.ranks == [0, 1, 2, 3] and tsum["sketch_only_merges"] == 8


def test_child_wires_cross_packages_and_replace_their_slot():
    """A JAX child's wire merges into a port FleetTelemetry and the port's
    into JAX's; a re-forwarded (grown) wire replaces its slot."""
    views = []
    for parent_mod, child_mod in ((tfleet, jsk), (jfleet, tsk)):
        child = child_mod.FleetSketches()
        child.observe_round_time(1, 2.0)
        parent = parent_mod.FleetTelemetry()
        assert parent.merge_client_delta(0, {"sketches": child.to_wire()})
        child.observe_round_time(2, 3.0)
        assert parent.merge_client_delta(0, {"sketches": child.to_wire()})
        assert parent.merge_client_delta(1, _train_delta(4.0))
        view = parent.sketch_view()
        assert view.quantiles["round_time_s"].count == 3 and parent.ranks == [1]
        assert parent.merge_client_delta(2, {"sketches": {"v": 1, "q": {}}})  # unusable: kept out
        views.append(_no_clock(parent.sketch_view().to_wire()))
        assert parent.merges == 4
    assert views[0] == views[1]


def test_trace_summary_lane_matches_jax(tmp_path):
    docs = []
    for mod, tmod in ((tfleet, ttel), (jfleet, jtel)):
        f = mod.FleetTelemetry()
        for r in range(12):
            f.merge_client_delta(r, _train_delta(1.0 + r))
        path = f.export_fleet_trace(str(tmp_path / f"{mod.__name__}.json"),
                                    server=tmod.Telemetry(enabled=True), max_client_lanes=4)
        doc = json.load(open(path))
        names = sorted(e["args"]["name"] for e in doc["traceEvents"]
                       if e.get("ph") == "M" and e.get("name") == "process_name")
        summary = [e for e in doc["traceEvents"] if e.get("name") == "fleet.sketch_summary"]
        docs.append((names, _snap(summary[0]["args"])))
    assert docs[0] == docs[1]
    assert {n for n in docs[0][0] if n.startswith("client-")} == {
        f"client-{r}" for r in (8, 9, 10, 11)}
    assert any(n.startswith("fleet-summary") for n in docs[0][0])


# --- the sketches through the tree -----------------------------------------------

def _drive_trees(monkeypatch, threshold, n_edges=4, fanout=2, n=60):
    monkeypatch.setenv("FEDML_FLEET_SKETCH_THRESHOLD", threshold)
    rng = np.random.default_rng(37)
    ttree = TTree.build(n_edges=n_edges, regional_fanout=fanout, publish_k=64, device="cpu")
    jtree = JTree.build(n_edges=n_edges, regional_fanout=fanout, publish_k=64)
    tmodel, jmodel = {"w": torch.ones(4)}, {"w": np.ones(4, np.float32)}
    flat = tsk.FleetSketches()
    for rank in range(n):
        dur = float(rng.lognormal(0.5, 0.4))
        ttree.submit(rank, tmodel, 1.0, rank % 3, telemetry_delta=_train_delta(dur))
        jtree.submit(rank, jmodel, 1.0, rank % 3, telemetry_delta=_train_delta(dur))
        flat.observe_round_time(rank, dur)
    return ttree, jtree, flat


@pytest.mark.parametrize("threshold", ["2", "100000"])
def test_root_view_equals_flat_merge_and_jax(monkeypatch, threshold):
    """4 edges -> 2 regionals -> root, in sketch mode and exact mode: after
    flush_sketches the root's view equals one flat FleetSketches fed the same
    round times, and JAX's root view of the same tree, bucket for bucket."""
    ttree, jtree, flat = _drive_trees(monkeypatch, threshold)
    ttree.flush_sketches()
    jtree.flush_sketches()
    root = ttree._root_sketch_view()
    assert root.quantiles["round_time_s"] == flat.quantiles["round_time_s"]
    assert np.array_equal(root.clients.registers, flat.clients.registers)
    assert np.allclose(root.offenders.table, flat.offenders.table, atol=1e-9)
    # one staleness observation a client submission, observed at the edges only
    assert root.quantiles["staleness"].count == 60
    assert root.observations == 60  # the round times
    assert _no_clock(root.to_wire()) == _no_clock(jtree._root_sketch_view().to_wire())
    # the tree is the active provider: the riders read its root
    assert tsk.active_snapshot()["observations"] == 60
    ttree.flush_sketches()  # cumulative wires replace slots: no growth
    assert ttree._root_sketch_view().quantiles["round_time_s"].count == 60
    for t_node, j_node in zip(ttree.nodes(), jtree.nodes()):
        assert t_node.fleet.ranks == j_node.fleet.ranks
        assert t_node.statusz()["sketch_observations"] == \
            j_node.statusz()["sketch_observations"]
