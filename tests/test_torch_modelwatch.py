"""The port's modelwatch against the JAX package's, on the CPU.

The same seeded numpy trees go through JAX's ``telemetry/modelwatch.py`` and
the port's. Tolerances:

- stat rows and aggregate stats: norms, cosines and update ratios within
  rtol 1e-5 (both packages sum in f32, JAX leaf by leaf in its tree's
  order, the port over the flat vector in the state dict's order, so they
  agree to f32 rounding); NaN and Inf counts, group keys and ranks exact;
- verdicts, z-scores and the ledger's outputs: the same host arithmetic on
  the same inputs, so exact (z within 1e-12);
- quarantine and the fused fold: bit-exact against the honest-only and the
  unwatched fold;
- the sp and cross-silo fronts in float64 (the folds and stats are f32 in
  both packages; training in float64 keeps f32 noise out of the deltas):
  each round's rows by rank within rtol 1e-5;
- the LLM guard: ``param_norm`` within rtol 1e-5 of JAX's on JAX's small
  test model in f32, NaN and Inf counts exact.

JAX parties run in threads only where a JAX cross-silo federation is
compared; the end-to-end chaos cluster is the port's alone (JAX's
``PRNGKey`` dispatch from several threads has taken a test worker down).
"""

import copy
import json
import math
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.aggregation.async_buffer import AsyncAggBuffer as JBuffer
from fedml_tpu.core.aggregation.async_buffer import StalenessPolicy as JPolicy
from fedml_tpu.core.aggregation.bucketed import BucketedAggregator as JAggregator
from fedml_tpu.core.distributed.communication.inmemory.broker import InMemoryBroker as JBroker
from fedml_tpu.core.resilience import quorum as jquorum
from fedml_tpu.core.telemetry import flight_recorder as jfr
from fedml_tpu.core.telemetry import modelwatch as jmw
from fedml_tpu.core.telemetry.slo import SLOSpec as JSpec
from fedml_tpu.core.telemetry.tsdb import TimeSeriesStore as JStore
from fedml_tpu.data import data_loader as jloader
from fedml_tpu.data.dataset import ArrayDataset as JArrayDataset
from fedml_tpu_torch.core import telemetry as ttel
from fedml_tpu_torch.core.aggregation.async_buffer import AsyncAggBuffer as TBuffer
from fedml_tpu_torch.core.aggregation.async_buffer import StalenessPolicy as TPolicy
from fedml_tpu_torch.core.aggregation.bucketed import BucketedAggregator
from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker
from fedml_tpu_torch.core.resilience import quorum as tquorum
from fedml_tpu_torch.core.telemetry import flight_recorder as tfr
from fedml_tpu_torch.core.telemetry import modelwatch as tmw
from fedml_tpu_torch.core.telemetry import slo as tslo
from fedml_tpu_torch.core.telemetry import tsdb as ttsdb
from fedml_tpu_torch.core.telemetry.fleet import FleetTelemetry
from fedml_tpu_torch.core.telemetry.slo import SLOSpec as TSpec
from fedml_tpu_torch.core.telemetry.tsdb import TimeSeriesStore as TStore
from fedml_tpu_torch.data import data_loader as tloader
from fedml_tpu_torch.data.dataset import ArrayDataset as TArrayDataset
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.train.llm.llm_trainer import synthetic_token_batches
from tests.test_torch_cross_silo import Federation
from tests.test_torch_llm_trainer import _trainers

RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch steps: under several test workers a pool of threads
    in each only spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0, nan=False, mixed=False):
    """A numpy tree: f32 leaves (and, mixed, a bf16 leaf and an int32 leaf,
    as JAX's own tests mix dtypes)."""
    t = {"w": (rng.normal(size=(4, 3)) * scale).astype(np.float32),
         "b": (rng.normal(size=(3,)) * scale).astype(np.float32)}
    if mixed:
        t["e"] = (rng.normal(size=(5,)) * scale).astype(jnp.bfloat16)
        t["step"] = np.asarray(rng.integers(0, 5), np.int32)
    if nan:
        t["w"] = t["w"].copy()
        t["w"][0, 0] = np.nan
    return t


def _t(tree):
    """The same tree as a port state dict (bf16 stays bf16)."""
    out = {}
    for k, v in tree.items():
        arr = np.asarray(v)
        if arr.dtype == jnp.bfloat16:
            out[k] = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(arr.copy())
    return out


def _close(got, want, what):
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), (what, got)
    else:
        assert got == pytest.approx(want, rel=RTOL), (what, got, want)


def _rows_close(trows, jrows):
    assert [r["rank"] for r in trows] == [r["rank"] for r in jrows]
    for t, j in zip(trows, jrows):
        for key in ("norm", "cosine", "update_ratio"):
            _close(t[key], j[key], (j["rank"], key))
        assert (t["nan"], t["inf"], t["quarantined"]) == (j["nan"], j["inf"], j["quarantined"])
        assert list(t["group_norms"]) == list(j["group_norms"])
        for g in j["group_norms"]:
            _close(t["group_norms"][g], j["group_norms"][g], (j["rank"], g))


def _agg_close(t, j):
    assert sorted(t) == sorted(j)
    assert (t["nan"], t["inf"]) == (j["nan"], j["inf"])
    assert (t["cosine_prev"] is None) == (j["cosine_prev"] is None)
    for key in ("update_norm", "ref_norm", "update_ratio", "cosine_prev"):
        if j[key] is not None:
            _close(t[key], j[key], key)


# --- the stat math -------------------------------------------------------------

@pytest.mark.parametrize("mixed", [False, True], ids=["float32", "mixed"])
@pytest.mark.parametrize("with_prev", [False, True], ids=["first", "with_prev"])
def test_block_rows_and_finish_match_jax(mixed, with_prev):
    """Rows of a watched block (a NaN client among them) and the aggregate
    vector of ``finish``, with and without ``prev_update``. The mixed tree
    shows JAX's group keys (``bfloat16``, ``float32``, ``int32``) and the
    f32 accumulation of a bf16 leaf."""
    rng = np.random.default_rng(0)
    ref = _tree(rng, mixed=mixed)
    clients = [_tree(rng, s, mixed=mixed) for s in (1.0, 2.0, 0.5)]
    clients.append(_tree(rng, nan=True, mixed=mixed))
    published = [_tree(rng, 0.1, mixed=mixed) for _ in range(2)]
    jprev = tprev = None
    if with_prev:
        js = jmw.WatchSession(ref)
        jprev = js.finish(published[0]).update_tree
        ts = tmw.WatchSession(_t(ref))
        tprev = ts.finish(_t(published[0])).update_tree
    js = jmw.WatchSession(ref, prev_update=jprev)
    js.watch_block(clients)
    jst = js.finish(published[1])
    ts = tmw.WatchSession(_t(ref), prev_update=tprev)
    ts.watch_block([_t(c) for c in clients])
    tst = ts.finish(_t(published[1]))
    assert tst.groups == jst.groups == (["bfloat16", "float32", "int32"] if mixed
                                        else ["float32"])
    _rows_close(tst.rows, jst.rows)
    assert tst.rows[3]["nan"] == 1 and math.isnan(tst.rows[3]["norm"])
    _agg_close(tst.agg, jst.agg)
    assert (tst.agg["cosine_prev"] is None) is (not with_prev)
    # the update tree stays on the device as f32 leaves: the next prev
    assert all(v.dtype == torch.float32 for v in tst.update_tree.values())


def test_client_stat_and_train_guard_match_jax():
    rng = np.random.default_rng(1)
    ref = _tree(rng, mixed=True)
    tree = _tree(rng, 3.0, mixed=True)
    js, ts = jmw.WatchSession(ref), tmw.WatchSession(_t(ref))
    jrow = np.asarray(jmw.client_stat(tree, js), np.float64)
    trow = tmw.client_stat(_t(tree), ts).numpy().astype(np.float64)
    np.testing.assert_allclose(trow, jrow, rtol=RTOL)
    bad = dict(tree, w=np.asarray([[np.nan, np.inf], [1.0, -np.inf]], np.float32))
    for t in (tree, bad):
        jg = np.asarray(jmw.train_guard(t), np.float64)
        tg = tmw.train_guard(_t(t)).numpy().astype(np.float64)
        np.testing.assert_array_equal(tg[1:], jg[1:])
        if t is tree:
            np.testing.assert_allclose(tg[0], jg[0], rtol=RTOL)
    assert tg[1] == 1 and tg[2] == 2


@pytest.mark.parametrize("norms", [
    [1.0, 1.1, 0.9, 50.0], [1.0, float("nan"), 2.0], [1.0, 1.0, 1.0, 1.0],
    [0.5, 3.0], [1.0, 1.2, 0.8, 1.1, 0.2, 30.0, float("inf")]])
def test_outlier_verdicts_match_jax(norms):
    tz, tf = tmw.outlier_verdicts(norms)
    jz, jf = jmw.outlier_verdicts(norms)
    assert tf == jf
    np.testing.assert_allclose(tz, jz, rtol=1e-12)


def _stats(mod, norms, update_norm=1.0, nan=0, quarantined=()):
    rows = [{"rank": i, "norm": float(n), "cosine": 0.5 - 0.1 * i, "update_ratio": 0.1 * n,
             "nan": int(not math.isfinite(n)), "inf": 0, "group_norms": {"float32": float(n)},
             "quarantined": i in quarantined} for i, n in enumerate(norms)]
    agg = {"update_norm": float(update_norm), "nan": int(nan), "inf": 0,
           "cosine_prev": 0.9 if update_norm < 30 else -0.2, "ref_norm": 10.0,
           "update_ratio": 0.1 * update_norm}
    return mod.RoundStats(rows, agg, None, ["float32"])


ROUNDS = [([1.0, 1.1, 0.9, 50.0], 2.0, 0, ()), ([1.0, 1.2, 0.8, 40.0], 2.0, 0, (3,)),
          ([1.1, 1.0, 0.9, 1.0], 45.0, 0, ()), ([1.0, float("nan"), 1.0, 1.0], float("nan"), 3, ())]


def _series(store, name):
    return [v for ring in store.resolve(name) for _, v in ring.samples()]


def test_ledger_matches_jax_over_a_round_sequence():
    """Both ledgers fed the same RoundStats: each round's output, the tsdb
    series the SLO pack watches, the statusz snapshot, the prom triples, the
    annotated report, the alert context (answering modelwatch series only),
    the streaming z and a quarantine note."""
    led = {"jax": jmw.ContributionLedger(), "port": tmw.ContributionLedger()}
    stores = {"jax": JStore(capacity=64, resolution_s=0.0),
              "port": TStore(capacity=64, resolution_s=0.0)}
    from fedml_tpu.core.telemetry import tsdb as jtsdb

    outs = {}
    for side, (mod, tsdb_mod) in {"jax": (jmw, jtsdb), "port": (tmw, ttsdb)}.items():
        led[side].note_quarantined(7, 99.0, 12.5)
        tsdb_mod.install(stores[side])
        try:
            outs[side] = [led[side].observe_round(r, _stats(mod, *args))
                          for r, args in enumerate(ROUNDS)]
        finally:
            tsdb_mod.uninstall()
    assert json.dumps(outs["port"], sort_keys=True) == json.dumps(outs["jax"], sort_keys=True)
    assert outs["port"][2]["divergence_ratio"] > 10.0
    for name in ("modelwatch.nan_count", "modelwatch.agg_update_norm",
                 "modelwatch.divergence_ratio", "modelwatch.cosine_drift",
                 "modelwatch.outlier_rate"):
        tv, jv = _series(stores["port"], name), _series(stores["jax"], name)
        assert tv == jv and tv, name
    t, j = led["port"], led["jax"]
    assert t.statusz_snapshot() == j.statusz_snapshot()
    assert t.prom_gauges() == j.prom_gauges()
    assert t.annotate_report({"round": 3}) == j.annotate_report({"round": 3})
    for spec in ("modelwatch.nan_count", "health.straggler_ratio"):
        tc = t.alert_context(TSpec(name="x", series=spec, signal="last", target=0.0))
        jc = j.alert_context(JSpec(name="x", series=spec, signal="last", target=0.0))
        assert tc == jc and (tc is None) == (spec != "modelwatch.nan_count")
    for n in (1.0, 5.0, float("nan"), 0.95):
        assert t.streaming_z(n) == pytest.approx(j.streaming_z(n), rel=1e-12)
    assert (t.rounds, t.nan_rounds, t.quarantined_total) == (4, 1, 1)


# --- quarantine ------------------------------------------------------------------

def _screen(mod, trees, quarantine, conv=lambda t: t):
    ref = trees[0]
    sess = mod.WatchSession(conv(ref))
    led = mod.ContributionLedger()
    pairs = [(1.0, conv(t)) for t in trees[1:]]
    kept = mod.screen_cohort(sess, pairs, list(range(len(pairs))), ledger=led,
                             quarantine=quarantine)
    return sess, led, pairs, kept


def test_sync_quarantine_is_bit_exact_against_the_honest_only_fold():
    rng = np.random.default_rng(3)
    trees = [_tree(rng)] + [_tree(rng) for _ in range(5)] + [_tree(rng, 80.0)]
    sess, led, pairs, kept = _screen(tmw, trees, True, _t)
    _, jled, _, jkept = _screen(jmw, trees, True)
    assert len(kept) == len(jkept) == 5
    eng = BucketedAggregator(bucket_size=4)
    a, b = eng.aggregate(kept), eng.aggregate(pairs[:5])
    assert all(torch.equal(a[k], b[k]) for k in b)
    stats = sess.finish(a)
    assert [r["rank"] for r in stats.rows if r["quarantined"]] == [5]
    led.observe_round(0, stats)
    assert led.statusz_snapshot()["clients"]["5"]["quarantined"] == 1
    assert led.last_outlier_rate == pytest.approx(1 / 6)
    assert led.quarantined_total == jled.quarantined_total == 1


def test_nan_upload_is_always_quarantined_and_an_all_outlier_cohort_folds_whole():
    rng = np.random.default_rng(4)
    trees = [_tree(rng)] + [_tree(rng) for _ in range(3)] + [_tree(rng, nan=True)]
    sess, _, _, kept = _screen(tmw, trees, True, _t)
    assert len(kept) == 3 and list(sess.quarantined) == [3]
    bad = [_tree(rng)] + [_tree(rng, nan=True) for _ in range(3)]
    sess, _, pairs, kept = _screen(tmw, bad, True, _t)
    jsess, _, _, jkept = _screen(jmw, bad, True)
    assert len(kept) == len(jkept) == 3 and all(a is b for a, b in zip(kept, pairs))
    assert not sess.quarantined and not jsess.quarantined


def test_quarantine_off_returns_the_pairs_unchanged():
    rng = np.random.default_rng(6)
    trees = [_tree(rng), _tree(rng, 99.0), _tree(rng), _tree(rng), _tree(rng, nan=True)]
    sess, led, pairs, kept = _screen(tmw, trees, False, _t)
    assert len(kept) == len(pairs) and all(a is b for a, b in zip(kept, pairs))
    assert sess.n_clients == 4 and not led.quarantined_total


def _arrivals(rng):
    return ([(r, _tree(rng)) for r in range(6)] + [(90, _tree(rng, 500.0)), (91, _tree(rng, nan=True))]
            + [(6, _tree(rng))])


def test_async_streaming_quarantine_rejects_outliers_as_jax_does():
    """Six honest arrivals fill the streaming-z window; a 500x delta and a
    NaN delta get ``outlier_rejected`` in both packages; the publish folds
    the rest and the ledger counts each quarantine once."""
    rng = np.random.default_rng(7)
    ref, arrivals = _tree(rng), _arrivals(rng)
    verdicts, leds, bufs = {}, {}, {}
    for side, (mod, buf_cls, pol, conv) in {
            "jax": (jmw, JBuffer, JPolicy, lambda t: t),
            "port": (tmw, TBuffer, TPolicy, _t)}.items():
        eng = (BucketedAggregator if side == "port" else JAggregator)(bucket_size=4)
        led = leds[side] = mod.ContributionLedger()
        buf = bufs[side] = buf_cls(publish_k=7, policy=pol(exponent=0.0), engine=eng)
        assert buf.enable_watch(conv(ref), ledger=led, quarantine=True)
        verdicts[side] = [buf.submit(r, conv(t), 1.0, None) for r, t in arrivals]
        assert buf.publish() is not None
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"][6:8] == [tquorum.OUTLIER_REJECTED] * 2 == [jquorum.OUTLIER_REJECTED] * 2
    t, j = leds["port"], leds["jax"]
    assert t.quarantined_total == j.quarantined_total == 2 and t.rounds == j.rounds == 1
    assert t.last_outlier_rate == pytest.approx(j.last_outlier_rate) == pytest.approx(2 / 9)
    ts, js = t.statusz_snapshot(), j.statusz_snapshot()
    assert sorted(ts["clients"]) == sorted(js["clients"])
    for rank, row in js["clients"].items():
        got = ts["clients"][rank]
        assert (got["quarantined"], got["outlier"]) == (row["quarantined"], row["outlier"])
        if isinstance(row["norm"], str):  # a non-finite norm, rendered
            assert got["norm"] == row["norm"]
        else:
            assert got["norm"] == pytest.approx(row["norm"], rel=RTOL, abs=1e-6), rank
    st = bufs["port"].statusz()
    assert st["modelwatch"] and st["modelwatch_quarantine"] and st["quarantined_total"] == 2


# --- the fused fold ---------------------------------------------------------------

@pytest.mark.parametrize("mixed", [False, True], ids=["float32", "mixed"])
def test_watched_fold_is_bit_equal_to_the_unwatched_fold(mixed):
    """``aggregate`` and both fold sites of the async buffer (eager buckets
    and the publish-time tail): the same bits with and without a watch, and
    the watched rows equal the stats-only rows of the same cohort."""
    rng = np.random.default_rng(8)
    ref = _t(_tree(rng, mixed=mixed))
    pairs = [(float(i + 1), _t(_tree(rng, mixed=mixed))) for i in range(7)]
    eng = BucketedAggregator(bucket_size=4)
    plain = eng.aggregate(pairs)
    sess = tmw.WatchSession(ref)
    watched = eng.aggregate(pairs, watch=sess)
    assert all(torch.equal(plain[k], watched[k]) for k in plain)
    rows = sess.finish(watched).rows
    screen = tmw.WatchSession(ref)
    tmw.screen_cohort(screen, pairs, bucket_size=4)
    assert [r["norm"] for r in rows] == [r["norm"] for r in screen.finish(watched).rows]
    assert len(rows) == 7
    outs = []
    for watch in (False, True):
        buf = TBuffer(publish_k=7, policy=TPolicy(exponent=0.0), engine=eng)
        if watch:
            led = tmw.ContributionLedger()
            assert buf.enable_watch(ref, ledger=led)
        for r, (n, t) in enumerate(pairs):
            buf.submit(r, t, n, None)
        outs.append(buf.publish())
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    assert led.rounds == 1 and sorted(led.statusz_snapshot()["clients"]) == \
        [str(r) for r in range(7)]


def test_fleet_ledger_is_lazy_and_feeds_the_fleet_sketches():
    fleet = FleetTelemetry()
    assert fleet._ledger is None
    led = fleet.ledger
    assert isinstance(led, tmw.ContributionLedger) and fleet.ledger is led
    assert led.sketches is fleet.sketches


# --- the fronts ------------------------------------------------------------------

SP = dict(random_seed=0, dataset="mnist", data_cache_dir="", partition_method="hetero",
          partition_alpha=0.5, model="lr", federated_optimizer="FedAvg",
          client_num_in_total=4, client_num_per_round=4, comm_round=2, epochs=1,
          batch_size=32, client_optimizer="sgd", learning_rate=0.03, frequency_of_the_test=1,
          backend="sp")
# the sp simulators of both packages read no chaos knob (the cross-silo
# client's run_local_round does): the sp tests scale cohort slot
# SCALED_SLOT's upload SCALE-fold in round 1 at the server rule, as
# chaos_scale_delta with chaos_scale_at_round=1 does to a silo's upload
SCALED_SLOT, SCALE = 2, 50.0


def _scale_round_1(api, scale):
    update, calls = api._server_update, []

    def scaled(w_global, w_locals):
        calls.append(1)
        if len(calls) == 2:
            w_locals = list(w_locals)
            n, tree = w_locals[SCALED_SLOT]
            w_locals[SCALED_SLOT] = (n, scale(tree))
        return update(w_global, w_locals)

    api._server_update = scaled


def _f64_data(load, ds_cls, args, n=64, n_test=128):
    """The config's shards cut to their first ``n`` examples and the test
    set to ``n_test`` (a cut of scale, for CPU time); inputs in float64."""
    d = load(args)
    local = {c: ds_cls(np.asarray(s.x[:n], np.float64), s.y[:n]) for c, s in d[5].items()}
    test = ds_cls(np.asarray(d[3].x[:n_test], np.float64), d[3].y[:n_test])
    return (sum(len(s) for s in local.values()), n_test, d[2], test,
            {c: len(s) for c, s in local.items()}, local, {c: test for c in local}, d[7])


def _recording(ledger):
    seen = []
    observe = ledger.observe_round

    def recorded(round_idx, stats):
        seen.append((round_idx, copy.deepcopy(stats.rows), dict(stats.agg)))
        return observe(round_idx, stats)

    ledger.observe_round = recorded
    return seen


def _jax_sp(kw, data=None, scaled=False):
    args = fedml_tpu.init(fedml_tpu.default_config("simulation", **kw))
    data = data or fedml_tpu.data.load(args)[0]
    model = fedml_tpu.model.create(args, data[-1])
    p0 = jax.device_get(model.params)
    if data[3].x.dtype == np.float64:
        model.params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), p0)
    runner = fedml_tpu.FedMLRunner(args, "cpu", data, model)
    api = runner.runner.fl_trainer
    if scaled:
        _scale_round_1(api, lambda t: jax.tree.map(lambda v: v * SCALE, t))
    seen = _recording(api._mw_ledger) if api._mw_ledger is not None else None
    runner.run()
    return p0, api, seen


def _port_sp(kw, p0, data=None, dtype=torch.float32, scaled=False):
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw))
    data = data or fedml_tpu_torch.data.load(args)[0]
    model = fedml_tpu_torch.model.create(args, data[-1], device="cpu")
    model.module.load_state_dict(params_from_jax(p0))
    model.module.to(dtype)
    model.params = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), data, model)
    api = runner.runner.fl_trainer
    if scaled:
        _scale_round_1(api, lambda t: {k: v * SCALE for k, v in t.items()})
    seen = _recording(api._mw_ledger) if api._mw_ledger is not None else None
    runner.run()
    return api, seen


def _assert_rounds_close(tseen, jseen, n_rounds):
    assert [r for r, _, _ in tseen] == [r for r, _, _ in jseen] == list(range(n_rounds))
    for (_, trows, tagg), (_, jrows, jagg) in zip(tseen, jseen):
        _rows_close(trows, jrows)
        _agg_close(tagg, jagg)


def test_sp_fedavg_rows_match_jax_in_float64():
    """Two sp FedAvg rounds in float64, slot 2's upload scaled 50x in round
    1: the same rows, aggregate stats and ledger verdicts by cohort position
    in both packages, and slot 2 flagged an outlier in round 1."""
    jdata = _f64_data(jloader.load, JArrayDataset, fedml_tpu.default_config("simulation", **SP))
    tdata = _f64_data(tloader.load, TArrayDataset,
                      fedml_tpu_torch.default_config("simulation", **SP))
    with jax.enable_x64(True):
        p0, japi, jseen = _jax_sp(SP, jdata, scaled=True)
    tapi, tseen = _port_sp(SP, p0, tdata, torch.float64, scaled=True)
    _assert_rounds_close(tseen, jseen, 2)
    assert tseen[0][1][0]["group_norms"].keys() == {"float64"}
    norms = [r["norm"] for r in tseen[1][1]]
    assert norms[SCALED_SLOT] > 10 * max(n for i, n in enumerate(norms) if i != SCALED_SLOT)
    assert tapi._mw_ledger.statusz_snapshot()["aggregate"]["outliers"] == [SCALED_SLOT]
    ts, js = tapi._mw_ledger.statusz_snapshot(), japi._mw_ledger.statusz_snapshot()
    assert sorted(ts["clients"]) == sorted(js["clients"]) and ts["rounds"] == js["rounds"] == 2
    for rank, row in js["clients"].items():
        assert ts["clients"][rank]["outlier"] == row["outlier"]
        _close(ts["clients"][rank]["share"], row["share"], rank)
    assert tmw.get_active() is None  # train() cleared it


CS = dict(client_num_in_total=3, client_num_per_round=3, comm_round=2, epochs=1,
          batch_size=16, frequency_of_the_test=1, dataset="synthetic", model="lr",
          random_seed=0, scenario="horizontal", data_cache_dir="", learning_rate=0.03)


def test_cross_silo_rows_match_jax_in_float64():
    """A cross-silo INMEMORY federation in float64, silo 3 uploading 50x
    weights (``chaos_scale_delta``): the same rows by sender rank in the
    port's server and JAX's, and silo 3 flagged an outlier in both."""
    def prep(pkg):
        def prepare(role, rank, args, dataset, model):
            if rank == 3:
                args.chaos_scale_delta = 50.0
            if pkg is fedml_tpu:
                model.params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), p0)
            else:
                model.module.load_state_dict(params_from_jax(p0))
                model.module.to(torch.float64)
                model.params = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
            return dataset, model
        return prepare

    args = fedml_tpu.init(fedml_tpu.default_config("cross_silo", **CS))
    _, output_dim = fedml_tpu.data.load(args)
    p0 = jax.device_get(fedml_tpu.model.create(args, output_dim).params)
    jdata = _f64_data(jloader.load, JArrayDataset, fedml_tpu.default_config("cross_silo", **CS),
                      n=48, n_test=64)
    tdata = _f64_data(tloader.load, TArrayDataset,
                      fedml_tpu_torch.default_config("cross_silo", **CS), n=48, n_test=64)
    seen = {}
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)  # global: the parties run on their own threads
    try:
        JBroker.reset("tmw_jax_cs")
        fed = Federation(fedml_tpu, "tmw_jax_cs", CS, prepare=prep(fedml_tpu),
                         load=lambda a: (jdata, output_dim))
        seen["jax"] = _recording(fed.server.aggregator.fleet.ledger)
        fed.run()
        JBroker.reset("tmw_jax_cs")
    finally:
        jax.config.update("jax_enable_x64", prev)
    InMemoryBroker.reset("tmw_port_cs")
    fed = Federation(fedml_tpu_torch, "tmw_port_cs", CS, prepare=prep(fedml_tpu_torch),
                     load=lambda a: (tdata, output_dim))
    led = fed.server.aggregator.fleet.ledger
    seen["port"] = _recording(led)
    fed.run()
    InMemoryBroker.reset("tmw_port_cs")
    _assert_rounds_close(seen["port"], seen["jax"], 2)
    assert [r["rank"] for r in seen["port"][0][1]] == [1, 2, 3]
    assert led.statusz_snapshot()["clients"]["3"]["outlier"] is True
    assert led.statusz_snapshot()["clients"]["1"]["outlier"] is False
    assert tmw.get_active() is None  # the server's run cleared it


@pytest.mark.parametrize("opt,watched", [("FedAvg", False), ("FedOpt", True)],
                         ids=["fold_at_arrival", "pairs"])
def test_pipelined_rounds_watch_as_jax_does(opt, watched):
    """``client_execution: pipelined``: fold-at-arrival (plain FedAvg) runs
    unwatched in both packages; pairs mode (FedOpt) goes through the server
    rule and is watched in both."""
    kw = dict(SP, comm_round=1, federated_optimizer=opt, client_execution="pipelined")
    p0, japi, jseen = _jax_sp(kw)
    tapi, tseen = _port_sp(kw, p0)
    assert len(tseen) == len(jseen) == (1 if watched else 0)
    assert tapi._mw_ledger.rounds == japi._mw_ledger.rounds == len(jseen)
    if watched:
        _assert_rounds_close(tseen, jseen, 1)


def test_sp_quarantine_runs_and_drops_a_nan_upload():
    """The sp front's ``modelwatch_quarantine`` gate is gone: a round with
    one client's upload NaN-poisoned publishes the fold of the others."""
    kw = dict(SP, comm_round=1, modelwatch_quarantine=True)
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw))
    data = fedml_tpu_torch.data.load(args)[0]
    model = fedml_tpu_torch.model.create(args, data[-1], device="cpu")
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), data, model)
    api = runner.runner.fl_trainer
    update, seen = api._server_update, {}

    def poisoned(w_global, w_locals):
        w_locals = list(w_locals)
        n, tree = w_locals[2]
        w_locals[2] = (n, {k: v.clone().fill_(float("nan")) for k, v in tree.items()})
        seen["w_locals"] = w_locals
        return update(w_global, w_locals)

    api._server_update = poisoned
    runner.run()
    snap = api._mw_ledger.statusz_snapshot()
    dropped = {int(r) for r, row in snap["clients"].items() if row["quarantined"]}
    assert 2 in dropped and snap["quarantined_total"] == len(dropped) < 4
    kept = [p for i, p in enumerate(seen["w_locals"]) if i not in dropped]
    want = api.aggregator.aggregate(kept)
    out = api.model_trainer.get_model_params()
    assert all(torch.equal(out[k], want[k]) for k in out)


# --- the port's end-to-end chaos cluster -------------------------------------------

def test_chaos_nan_and_scale_trip_modelwatch_slos(tmp_path, monkeypatch):
    """The port's mirror of JAX's end-to-end test: client 2 NaN-poisons its
    round-2 upload, client 3 uploads 50x weights every round.
    ``client_outlier_rate`` fires first, then ``nan_storm``; each captures
    exactly one flight-recorder snapshot, the outlier snapshot's rows show
    rank 3 an outlier and rank 1 ok; /statusz has the ``modelwatch`` section
    and /metrics the ledger's gauges. The pages are read right after the
    last round's SLO tick, while the server still serves them."""
    fr_dir = tmp_path / "fr"
    monkeypatch.setenv("FEDML_FR_DIR", str(fr_dir))
    port_file = tmp_path / "statusz.port"
    kw = dict(CS, comm_round=4, statusz_port=0, statusz_port_file=str(port_file))
    pages = {}

    def prepare(role, rank, args, dataset, model):
        if rank == 2:
            args.chaos_nan_at_round = 2
        if rank == 3:
            args.chaos_scale_delta = 50.0
        return dataset, model

    t = ttel.get_telemetry()
    was = t.enabled
    t.set_enabled(True)
    try:
        InMemoryBroker.reset("tmw_chaos")
        fed = Federation(fedml_tpu_torch, "tmw_chaos", kw, prepare=prepare)
        server = fed.server
        tick = server._slo_tick

        def probed():
            tick()
            if int(server.args.round_idx) == 3:
                port = int(port_file.read_text())
                for page in ("statusz", "metrics"):
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/{page}",
                                                timeout=10) as resp:
                        pages[page] = resp.read().decode()
                pages["engine"] = tslo.get_engine()

        server._slo_tick = probed
        fed.run()
        InMemoryBroker.reset("tmw_chaos")
    finally:
        t.set_enabled(was)
    doc = json.loads(pages["statusz"])
    alerts = doc["sections"]["alerts"]
    assert alerts["slos"]["nan_storm"]["state"] == "firing"
    assert alerts["slos"]["nan_storm"]["snapshot_path"]
    mw = doc["sections"]["modelwatch"]
    assert mw["rounds"] == 4 and mw["nan_rounds"] >= 1 and set(mw["clients"]) == {"1", "2", "3"}
    metrics = pages["metrics"]
    assert 'fedml_alert_active{slo="nan_storm"} 1' in metrics
    for fam, rank in (("delta_norm", 1), ("contribution", 3), ("outlier_score", 3)):
        assert f'fedml_client_{fam}{{rank="{rank}"}}' in metrics
    by_reason = {}
    for d in sorted(fr_dir.glob("fr_*.jsonl")):
        recs = [json.loads(line) for line in d.read_text().splitlines()]
        by_reason.setdefault(recs[0]["reason"], []).append(recs)
    assert len(by_reason.get("slo_alert:nan_storm", [])) == 1
    assert len(by_reason.get("slo_alert:client_outlier_rate", [])) == 1
    (nan_recs,) = by_reason["slo_alert:nan_storm"]
    (alert,) = [r for r in nan_recs if r["type"] == "alert"]
    assert alert["transition"] == "pending->firing" and alert["clients"]
    (out_recs,) = by_reason["slo_alert:client_outlier_rate"]
    (out_alert,) = [r for r in out_recs if r["type"] == "alert"]
    rows = {c["rank"]: c for c in out_alert["clients"]}
    assert rows["3"]["verdict"] == "outlier" and rows["1"]["verdict"] == "ok"
    assert rows["1"]["nan"] == 0
    z3 = rows["3"]["z"]
    assert z3 == "inf" or float(z3) >= tmw.z_threshold()
    assert any(tr["slo"] == "nan_storm" and tr["to"] == "firing" for tr in pages["engine"].history)
    assert tslo.get_engine() is None and tmw.get_active() is None


def test_async_cross_silo_aggregator_quarantines_the_scaled_silo():
    """The cross-silo aggregator under ``async_rounds`` and
    ``modelwatch_quarantine`` watches its buffer: once honest arrivals fill
    the streaming window, silo 3's 50x upload gets ``outlier_rejected`` and
    never folds, and the publish's rows reach the fleet's ledger, the
    process's active one."""
    kw = dict(CS, async_rounds=True, async_publish_k=4, async_staleness_exponent=0.0,
              modelwatch_quarantine=True)
    InMemoryBroker.reset("tmw_async_q")
    fed = Federation(fedml_tpu_torch, "tmw_async_q", kw)
    agg = fed.server.aggregator
    try:
        _async_quarantine(agg)
    finally:
        tmw.clear_active()
        InMemoryBroker.reset("tmw_async_q")


def test_a_nested_global_is_watched_through_its_state_dict_names():
    """A global held in the flax layout (the adapters a FedLLM silo
    exchanges) beside uploads that a hook made state dicts: the session
    flattens it through ``models.convert``, so its rows equal those of the
    flat global's session, and JAX's on the same leaves. The bf16 leaf
    between f32 leaves splits the f32 group into two column runs. An upload
    of another size raises."""
    rng = np.random.default_rng(11)

    def leaves(scale=1.0):
        return {"fc.weight": (rng.normal(size=(3, 4)) * scale).astype(np.float32),
                "fc.bias": (rng.normal(size=(3,)) * scale).astype(np.float32),
                "emb.weight": (rng.normal(size=(5, 2)) * scale).astype(jnp.bfloat16),
                "out.weight": (rng.normal(size=(2, 4)) * scale).astype(np.float32)}

    ref, clients, published = leaves(), [leaves(s) for s in (1.0, 3.0, 0.5)], leaves(0.1)
    flat = tmw.WatchSession(_t(ref))
    assert flat.group_slices == [[(15, 25)], [(0, 15), (25, 33)]]
    nested = tmw.WatchSession(params_to_jax(_t(ref)))
    for sess in (flat, nested):
        sess.watch_block([_t(c) for c in clients])
    rows = [s.finish(_t(published)).rows for s in (flat, nested)]
    assert rows[0] == rows[1]
    js = jmw.WatchSession(ref)
    js.watch_block(clients)
    _rows_close(rows[1], js.finish(published).rows)
    with pytest.raises(ValueError, match="elements against"):
        nested.watch_block([{k: v[..., :1] for k, v in _t(clients[0]).items()}])


def _async_quarantine(agg):
    assert tmw.get_active() is agg.fleet.ledger
    g = agg.get_global_model_params()
    rng = np.random.default_rng(9)

    def upload(scale=1.0):
        return {k: (v + torch.from_numpy(rng.normal(0, 0.01, v.shape).astype(np.float32))) * scale
                for k, v in g.items()}

    verdicts = [agg.submit_async_result(i % 2, upload(), 16.0, 0) for i in range(3)]
    verdicts.append(agg.submit_async_result(2, upload(50.0), 16.0, 0))
    verdicts.append(agg.submit_async_result(0, upload(), 16.0, 0))
    assert verdicts == [tquorum.ACCEPT] * 3 + [tquorum.OUTLIER_REJECTED, tquorum.ACCEPT]
    assert agg.publish_async() is not None
    st = agg.async_buffer.statusz()
    assert st["modelwatch"] and st["modelwatch_quarantine"] and st["quarantined_total"] == 1
    snap = agg.fleet.ledger.statusz_snapshot()
    assert snap["rounds"] == 1 and snap["clients"]["2"]["quarantined"] == 1
    assert sorted(snap["clients"]) == ["0", "1", "2"]


# --- the LLM guard ---------------------------------------------------------------

def _flax_path(torch_name):
    """The flax path of the port's parameter ``torch_name`` (convert.py)."""
    probe = params_to_jax({torch_name: torch.zeros(1, 1)})
    path = []
    while isinstance(probe, dict):
        (k, probe), = probe.items()
        path.append(k)
    return path


def test_llm_guard_param_norm_and_mark_match_jax(tmp_path, monkeypatch):
    """One window on JAX's small test model in f32 on both trainers:
    ``param_norm`` within rtol 1e-5 of JAX's; then an adapter with a NaN
    planted gives the ``modelwatch_train_guard`` mark on both sides."""
    jtr, ttr, _ = _trainers(tmp_path)
    batch = next(synthetic_token_batches(256, 32, 2, 1, seed=0))
    jm, tm = jtr.train(iter([batch])), ttr.train(iter([batch]))
    assert tm["param_norm"] == pytest.approx(jm["param_norm"], rel=RTOL)
    marks = {"jax": [], "port": []}
    for side, mod in (("jax", jfr), ("port", tfr)):
        monkeypatch.setattr(mod, "mark", lambda name, _s=side, **f: marks[_s].append((name, f)))
    name = next(n for n in ttr.model.state_dict() if "lora_a" in n)
    with torch.no_grad():
        ttr.model.state_dict()[name].view(-1)[0] = float("nan")
    jpath = _flax_path(name)

    def plant(path, v):
        keys = [getattr(k, "key", None) for k in path]
        return v.at[(0,) * v.ndim].set(jnp.nan) if keys == jpath else v

    jtr.params = jax.tree_util.tree_map_with_path(plant, jtr.params)
    jm, tm = jtr.train(iter([batch])), ttr.train(iter([batch]))
    (_, tf), = [m for m in marks["port"] if m[0] == "modelwatch_train_guard"]
    (_, jf), = [m for m in marks["jax"] if m[0] == "modelwatch_train_guard"]
    assert tf["nan"] > 0 and jf["nan"] > 0 and tf["inf"] == jf["inf"] == 0
    assert math.isnan(tf["final_loss"]) and math.isnan(jf["final_loss"])
    assert math.isnan(tm["param_norm"]) and math.isnan(jm["param_norm"])
