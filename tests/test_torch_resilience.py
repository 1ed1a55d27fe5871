"""The port's resilience subsystem against the JAX package's, on the CPU:
quorum rounds, durable round state, the chaos knobs and the SIGKILL drills.

- ``RoundQuorum`` / ``QuorumPolicy``: the same event scripts through both
  packages give the same verdicts, arrival and missing lists, status and
  counters; ``overprovisioned_cohort_size`` over a grid. Exact.
- Round state: a round trip, a torn round ignored, the second async save
  dropped and counted, the numpy RNG captured exactly, the sidecar's keys
  and values equal to JAX's for the same save, and a save enqueued before an
  in-place update holding the values it was given.
- The sp simulator with ``resilience_dir`` bit-equal to the run without it
  for every server rule with state, and resumed in process from a shorter
  run bit-equal to the whole run for those whose state is all on the server
  (FedAvg, FedOpt, Mime); its final params against JAX's (LR on the
  synthetic set from JAX's params, resilience on in both) within 1e-5 of
  their scale (the LR limits of tests/test_torch_cross_silo.py).
- A dead silo under quorum (3 silos, one raising in round 0, JAX's
  ``test_one_dead_client_cannot_hang_the_round``): every round closes
  partial, missing exactly the dead rank, which health marks failed; the
  final params within 1e-5 of their scale of JAX's same federation.
- The three SIGKILL drills (``tools/resilience_drill.py``: sp, cross-silo,
  cross-silo async), each in its own subprocess under a timeout: the crash
  exits by SIGKILL with a complete round short of the end, and the resumed
  store's final state is bit-equal to the baseline's.
- The chaos NaN and scale payloads equal to JAX's ``_apply_delta_chaos``.
"""

import copy
import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core import telemetry as jtel
from fedml_tpu.core.distributed.communication.inmemory.broker import InMemoryBroker as JBroker
from fedml_tpu.core.engine import round_engine as jengine
from fedml_tpu.core.resilience import quorum as jquorum
from fedml_tpu.core.resilience import round_state as jrs
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker
from fedml_tpu_torch.core.engine import round_engine as tengine
from fedml_tpu_torch.core.resilience import quorum as tquorum
from fedml_tpu_torch.core.resilience import round_state as trs
from fedml_tpu_torch.core.resilience import statusz_snapshot
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.tools import resilience_drill as drill
from fedml_tpu_torch.utils import checkpoint as tckpt

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120
DRILL_TIMEOUT_S = 300

SP = dict(model="lr", dataset="synthetic", random_seed=0, comm_round=4, client_num_in_total=4,
          client_num_per_round=2, epochs=1, batch_size=16, frequency_of_the_test=2, backend="sp",
          data_cache_dir="")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small steps, several parties at once, several test workers: a
    pool of threads in each only spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_telemetry():
    """Both packages' registries enabled and empty for the test."""
    regs = (tel.get_telemetry(), jtel.get_telemetry())
    was = [r.enabled for r in regs]
    for r in regs:
        r.set_enabled(True)
        r.reset()
    yield
    for r, w in zip(regs, was):
        r.reset()
        r.set_enabled(w)


def _counters(mod):
    return {k: v for k, v in mod.snapshot()["counters"].items() if k.startswith("quorum.")}


# --- quorum ------------------------------------------------------------------

class _Clients:
    """A duck-typed health object: rank -> EWMA round time."""

    class _C:
        def __init__(self, e):
            self.ewma_s = e

    def __init__(self, ewmas):
        self._clients = {r: self._C(e) for r, e in ewmas.items()}


POLICIES = [dict(), dict(round_deadline_s=5.0), dict(quorum_frac=0.5),
            dict(adaptive_deadline=True), dict(adaptive_deadline=True, round_deadline_s=4.0),
            dict(adaptive_deadline=True, adaptive_deadline_mult=2.0, adaptive_deadline_min_s=9.0),
            dict(overprovision_frac=0.25, quorum_frac=0.75)]


@pytest.mark.parametrize("knobs", POLICIES, ids=[",".join(p) or "default" for p in POLICIES])
def test_quorum_policy_matches_jax(knobs):
    args = type("A", (), dict(knobs))()
    tp, jp = tquorum.QuorumPolicy.from_args(args), jquorum.QuorumPolicy.from_args(args)
    assert tp.enabled == jp.enabled
    assert [tp.min_quorum(k) for k in range(1, 17)] == [jp.min_quorum(k) for k in range(1, 17)]
    for ewmas in ({}, {1: 0.5, 2: 2.0, 3: None}, {1: 0.1}):
        h = _Clients(ewmas)
        assert tp.deadline_for_round(h) == jp.deadline_for_round(h)
    assert tp.deadline_for_round(None) == jp.deadline_for_round(None)


def test_overprovisioned_cohort_size_matches_jax_on_a_grid():
    for k in (1, 2, 3, 12, 16):
        for frac in (0.0, 0.25, 0.5, 1.0):
            for flagged in (False, True):
                for avail in (1, 3, 15, 16, 40):
                    got = tquorum.overprovisioned_cohort_size(k, frac, flagged, avail)
                    assert got == jquorum.overprovisioned_cohort_size(k, frac, flagged, avail)
    assert tquorum.overprovisioned_cohort_size(12, 0.25, True, 16) == 15


# event scripts: (round, expected, keep_k, policy knobs, ops); an op is
# ("d", rank, tagged round) or one of "complete", "met", "close"
QUORUM_SCRIPTS = {
    "accept_complete": (0, [1, 2, 3], 3, dict(deadline_s=60),
                        [("d", 1, 0), "complete", ("d", 1, 0), ("d", 2, 0), ("d", 3, 0),
                         "complete"]),
    "late": (5, [1, 2], 2, dict(deadline_s=60),
             [("d", 1, 4), ("d", 2, None), ("d", 1, 5), "complete"]),
    "surplus": (0, [1, 2, 3], 2, dict(overprovision_frac=0.5),
                [("d", 1, 0), ("d", 3, 0), "complete", ("d", 2, 0)]),
    "deadline_unmet_then_met": (0, [1, 2, 3], 3, dict(deadline_s=1, quorum_frac=0.5),
                                ["met", ("d", 1, 0), "met", ("d", 2, 0), "met", "close",
                                 ("d", 3, 0)]),
    "partial_close": (2, [4, 7, 9, 11], 4, dict(deadline_s=1, quorum_frac=0.75),
                      [("d", 9, 2), ("d", 4, 2), ("d", 11, 1), ("d", 7, 2), "met", "close",
                       ("d", 11, 2)]),
    "keep_k_above_cohort": (1, [2], 5, dict(quorum_frac=0.5), [("d", 2, 1), "complete", "close"]),
}


def _play(mod, script):
    round_idx, expected, keep_k, pol, ops = script
    q = mod.RoundQuorum(round_idx, expected, keep_k, mod.QuorumPolicy(**pol))
    out = []
    for op in ops:
        if op == "complete":
            out.append(q.complete())
        elif op == "met":
            out.append(q.deadline_quorum_met())
        elif op == "close":
            out.append(q.close_partial())
        else:
            out.append(q.on_delta(op[1], op[2]))
    return out, q.arrived(), q.missing(), q.statusz()


@pytest.mark.parametrize("script", list(QUORUM_SCRIPTS))
def test_round_quorum_event_scripts_match_jax(script, fresh_telemetry):
    got = _play(tquorum, QUORUM_SCRIPTS[script])
    ref = _play(jquorum, QUORUM_SCRIPTS[script])
    assert got == ref
    assert _counters(tel) == _counters(jtel)


# --- durable round state -----------------------------------------------------

def _tstate(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"model": {"w": torch.randn(2, 3, generator=g), "b": torch.ones(3)},
            "fedopt": {"state": {0: {"step": torch.tensor(2.0),
                                     "exp_avg": torch.randn(3, generator=g)}},
                       "param_groups": [{"lr": 0.1, "betas": (0.9, 0.99), "params": [0]}]}}


def test_round_state_round_trip(tmp_path):
    store = trs.RoundStateStore(str(tmp_path / "rs"))
    state = _tstate()
    np.random.seed(123)
    np.random.random(7)  # advance the stream so the capture is not trivial
    assert store.save_round(0, state, cohort=[1, 3], wait=True)
    before = np.random.random(4)
    np.random.seed(999)  # clobber
    rs = trs.RoundStateStore(str(tmp_path / "rs")).resume(template=_tstate(1))
    assert rs is not None and rs.round_idx == 0 and rs.cohort == [1, 3]
    assert drill.bit_equal(rs.state, state)
    trs.restore_numpy_rng(rs.meta.get("numpy_rng"))
    np.testing.assert_array_equal(np.random.random(4), before)
    assert statusz_snapshot()["resumed_round"] == 0
    assert trs.RoundStateStore(str(tmp_path / "empty")).resume() is None
    store.close()


def test_watermark_ignores_torn_round(tmp_path):
    """A sidecar and a step file written without the watermark's commit
    (the shape a SIGKILL mid-save leaves) must not move the resume point."""
    store = trs.RoundStateStore(str(tmp_path / "rs"))
    store.save_round(0, {"model": {"w": torch.zeros(2)}}, wait=True)
    (tmp_path / "rs" / "meta-1.json").write_text(json.dumps({"round_idx": 1}))
    torch.save({"model": {"w": torch.ones(2)}}, str(tmp_path / "rs" / "step_1.pt"))
    (tmp_path / "rs" / "step_2.pt.tmp").write_bytes(b"torn")
    assert store.latest_complete_round() == 0
    rs = store.resume()
    assert rs.round_idx == 0 and torch.equal(rs.state["model"]["w"], torch.zeros(2))
    store.close()


def test_step_file_is_the_bare_tree_as_the_synchronous_manager_wrote_it(tmp_path):
    """A step file is ``torch.save`` of the tree itself: a store written
    without the async path (the LLM trainer's checkpoints) restores, and an
    async save reads back as the tree it was given."""
    tree = {"params": {"w": torch.arange(4.0)}, "step": torch.tensor(7)}
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    torch.save(tree, str(tmp_path / "ck" / "step_3.pt"))
    got = mgr.restore()
    assert torch.equal(got["params"]["w"], tree["params"]["w"]) and int(got["step"]) == 7
    assert mgr.save(4, tree, wait=False)
    mgr.wait_until_finished()
    assert mgr.latest_complete_step() == 4
    raw = torch.load(str(tmp_path / "ck" / "step_4.pt"), weights_only=True)
    assert sorted(raw) == ["params", "step"] and torch.equal(raw["params"]["w"], tree["params"]["w"])
    mgr.close()


def _slow_writes(monkeypatch, seconds):
    real = tckpt.write_durably

    def slow(path, write):
        time.sleep(seconds)  # holds the waiter thread: a save still in flight
        real(path, write)

    monkeypatch.setattr(tckpt, "write_durably", slow)


def test_second_async_save_is_dropped_and_counted(tmp_path, monkeypatch, fresh_telemetry):
    _slow_writes(monkeypatch, 0.4)
    store = trs.RoundStateStore(str(tmp_path / "rs"))
    st = {"model": {"w": torch.ones(4)}}
    assert store.save_round(0, st, wait=False) is True
    assert store.save_round(1, st, wait=False) is False  # dropped
    store.wait()
    assert store.latest_complete_round() == 0
    snap = tel.snapshot()
    assert snap["counters"][tckpt.DROPPED_COUNTER] == 1
    assert snap["histograms"][tckpt.SAVE_SECONDS_HISTOGRAM]["count"] == 1
    assert statusz_snapshot()["checkpoint_dropped_total"] == 1
    # a synchronous save waits for the one in flight instead of dropping
    assert store.save_round(2, st, wait=False) and store.save_round(3, st, wait=True)
    assert store.latest_complete_round() == 3
    store.close()


def test_save_enqueued_before_an_in_place_update_holds_its_round(tmp_path, monkeypatch):
    """The next round writes into the same storage (the trainer loads the
    global in place, FedOpt and SCAFFOLD step in place): an async save
    enqueued at round r must hold round r's values although the write
    happens after round r+1 has updated them."""
    _slow_writes(monkeypatch, 0.3)
    store = trs.RoundStateStore(str(tmp_path / "rs"))
    state = _tstate()
    want = copy.deepcopy(state)
    assert store.save_round(0, state, wait=False)
    with torch.no_grad():
        state["model"]["w"].add_(1.0)                        # "round 1" in place
        state["fedopt"]["state"][0]["exp_avg"].mul_(3.0)
    store.wait()
    rs = store.resume()
    assert drill.bit_equal(rs.state, want) and not drill.bit_equal(rs.state, state)
    store.close()


def test_rng_capture_is_exact_and_jax_compatible():
    np.random.seed(7)
    np.random.random(11)
    st = trs.capture_numpy_rng()
    assert st == jrs.capture_numpy_rng()
    a = np.random.random(5)
    trs.restore_numpy_rng(st)
    np.testing.assert_array_equal(np.random.random(5), a)
    jrs.restore_numpy_rng(st)
    np.testing.assert_array_equal(np.random.random(5), a)


def test_sidecar_equals_jax_for_the_same_save(tmp_path):
    health = {"3": {"ewma_s": 1.5, "last_s": 1.2, "rounds": 2, "consecutive_failures": 0,
                    "total_failures": 1, "straggler_rounds": 0, "flagged": False}}
    extra = {"trainer_round": 6, "async_buffer": {"version": 1, "pending_weights": [16.0]},
             "fl_round_idx": 1}
    sidecars = []
    for mod, state in ((trs, {"model": {"w": torch.ones(3)}}),
                       (jrs, {"model": {"w": np.ones(3, np.float32)}})):
        np.random.seed(11)
        np.random.random(3)
        store = mod.RoundStateStore(str(tmp_path / mod.__name__))
        store.save_round(4, state, cohort=[np.int64(2), 3], health=health, extra_meta=extra,
                         wait=True)
        sidecars.append(json.loads((tmp_path / mod.__name__ / "meta-4.json").read_text()))
        store.close()
    assert sidecars[0] == sidecars[1]
    assert sorted(sidecars[0]) == ["async_buffer", "cohort", "fl_round_idx", "health",
                                   "numpy_rng", "round_idx", "trainer_round"]


def test_checkpointer_steps_and_kill_semantics(tmp_path, monkeypatch):
    """Sync mode steps by round; async mode keeps a monotone counter that
    resumes above the store's newest complete step; the final round and the
    kills drain and save synchronously."""
    kills = []
    monkeypatch.setattr(tengine.os, "kill", lambda pid, sig: kills.append(sig))
    store = trs.RoundStateStore(str(tmp_path / "rs"))
    args = type("A", (), {"chaos_kill_after_round": 1})()
    ck = tengine.RoundCheckpointer(store, args)
    ck.save(0, {"model": {"w": torch.zeros(1)}})
    ck.save(1, {"model": {"w": torch.ones(1)}})
    assert len(kills) == 1
    ck.save(2, {"model": {"w": torch.ones(1)}}, final=True)
    assert store.latest_complete_round() == 2

    class Buf:
        merges_total = 3

        def export_pytree_state(self):
            return {"acc": torch.arange(4.0), "pending": [{"w": torch.ones(1)}]}

        def export_meta(self):
            return {"version": 1, "pending_weights": [2.0], "has_acc": True}

    ack = tengine.RoundCheckpointer(store, type("A", (), {"chaos_kill_after_merges": 3})(),
                                    async_mode=True)
    ack.save(1, {"model": {"w": torch.ones(1)}}, async_buffer=Buf())
    assert len(kills) == 2 and store.latest_complete_round() == 3
    meta = store.read_meta(3)
    assert meta["fl_round_idx"] == 1 and meta["async_buffer"]["pending_weights"] == [2.0]
    assert torch.equal(store.resume().state["async_buffer"]["acc"], torch.arange(4.0))
    store.close()


# --- the sp front --------------------------------------------------------------

def _run_sp_port(kw, p0=None):
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw))
    dataset, output_dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, output_dim, device="cpu")
    if p0 is not None:
        model.module.load_state_dict(params_from_jax(p0))
        model.params = {k: v.clone() for k, v in model.module.state_dict().items()}
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
    runner.run()
    api = runner.runner.fl_trainer
    return api, api.model_trainer.get_model_params()


ALGOS = {"FedAvg": {}, "FedOpt": dict(server_optimizer="adam", server_lr=0.01),
         "SCAFFOLD": {}, "FedDyn": {}, "Mime": {}}


@pytest.mark.parametrize("algo", list(ALGOS))
def test_sp_with_resilience_is_bit_equal_to_without_and_resumes(algo, tmp_path):
    kw = dict(SP, federated_optimizer=algo, **ALGOS[algo])
    plain_api, plain = _run_sp_port(kw)
    api, w = _run_sp_port(dict(kw, resilience_dir=str(tmp_path / "full")))
    assert drill.bit_equal(w, plain)
    assert api.metrics_history == plain_api.metrics_history
    rs = drill.final_state(str(tmp_path / "full"))
    state_key = {"SCAFFOLD": "scaffold_c", "FedDyn": "feddyn_h", "Mime": "mime_s",
                 "FedOpt": "fedopt"}.get(algo)
    assert rs.round_idx == SP["comm_round"] - 1
    assert sorted(rs.state) == sorted(["model"] + ([state_key] if state_key else []))
    assert drill.bit_equal(rs.state["model"], w)
    assert rs.meta["trainer_round"] == SP["comm_round"] * SP["client_num_per_round"]
    if algo in ("SCAFFOLD", "FedDyn"):
        # their trainers keep client-side state (SCAFFOLD's c_local, FedDyn's
        # lam) that the round state does not hold, in the JAX package too: a
        # resumed run restarts it from zero
        return
    # a run cut after round 1, then resumed to the end: the whole run's params
    _run_sp_port(dict(kw, comm_round=2, resilience_dir=str(tmp_path / "cut")))
    _, resumed = _run_sp_port(dict(kw, resilience_dir=str(tmp_path / "cut"), resume=True))
    assert drill.bit_equal(resumed, plain)
    assert drill.bit_equal(drill.final_state(str(tmp_path / "cut")).state, rs.state)


def test_sp_with_resilience_tracks_jax(tmp_path):
    jargs = fedml_tpu.init(fedml_tpu.default_config(
        "simulation", **dict(SP, resilience_dir=str(tmp_path / "jax"))))
    jdata, jout = fedml_tpu.data.load(jargs)
    jmodel = fedml_tpu.model.create(jargs, jout)
    p0 = jax.device_get(jmodel.params)
    jrunner = fedml_tpu.FedMLRunner(jargs, "cpu", jdata, jmodel)
    jrunner.run()
    ref = jax.device_get(jrunner.runner.fl_trainer.model_trainer.get_model_params())
    api, w = _run_sp_port(dict(SP, resilience_dir=str(tmp_path / "port")), p0=p0)
    got = params_to_jax(w)
    for k in ref:
        for leaf in ref[k]:
            r, g = np.asarray(ref[k][leaf]), np.asarray(got[k][leaf])
            assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), (k, leaf)
    jstore = jrs.RoundStateStore(str(tmp_path / "jax"))
    jmeta = jstore.read_meta(jstore.latest_complete_round())
    jstore.close()
    tmeta = trs.RoundStateStore(str(tmp_path / "port")).read_meta(SP["comm_round"] - 1)
    assert tmeta == jmeta


# --- the cross-silo front: a dead silo under quorum ---------------------------

DEAD, DEAD_ROUNDS = 2, 2


def _dead_silo_federation(pkg, run_id, p0=None):
    """3 silos over INMEMORY, silo 2 raising in round 0, the server with a
    3 s deadline and quorum_frac 0.5 (JAX's dead-client drill); built
    through each package's entry points, not yet run."""
    n = 3
    runners = {}
    for rank in range(n + 1):
        role = "server" if rank == 0 else "client"
        over = dict(run_id=run_id, rank=rank, role=role, backend="INMEMORY",
                    scenario="horizontal", client_num_in_total=n, client_num_per_round=n,
                    comm_round=DEAD_ROUNDS, epochs=1, batch_size=16,
                    frequency_of_the_test=DEAD_ROUNDS + 1, dataset="synthetic", model="lr",
                    random_seed=0, data_cache_dir="")
        if role == "server":
            over.update(round_deadline_s=3.0, quorum_frac=0.5)
        if rank == DEAD:
            over["chaos_raise_at_round"] = 0
        if pkg is fedml_tpu_torch:
            over["using_gpu"] = False
        args = pkg.init(pkg.default_config("cross_silo", **over))
        dev = pkg.device.get_device(args) if pkg is fedml_tpu else pkg.get_device(args)
        dataset, output_dim = pkg.data.load(args)
        if pkg is fedml_tpu:
            model = pkg.model.create(args, output_dim)
        else:
            model = pkg.model.create(args, output_dim, device=dev)
            if p0 is not None:
                model.module.load_state_dict(params_from_jax(p0))
                model.params = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
        runners[rank] = pkg.FedMLRunner(args, dev, dataset, model)
    return runners


def _run_parties(runners):
    """Every party as a thread; the chaos silo's injected raise ends its
    thread alone (recorded as "died"), and every thread must end."""
    results = {}

    def party(rank):
        try:
            results[rank] = runners[rank].run()
        except RuntimeError as e:
            results[rank] = f"died: {e}"

    threads = [threading.Thread(target=party, args=(r,), daemon=True) for r in runners]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), "a dead silo hung the quorum-armed federation"
    return results


def test_one_dead_silo_cannot_hang_the_round_and_tracks_jax(monkeypatch, fresh_telemetry):
    closes = {}
    for mod, key in ((tquorum, "port"), (jquorum, "jax")):
        real = mod.RoundQuorum.close_partial

        def recorded(self, _real=real, _key=key):
            missing = _real(self)
            closes.setdefault(_key, []).append((self.round_idx, missing, sorted(self.arrived())))
            return missing

        monkeypatch.setattr(mod.RoundQuorum, "close_partial", recorded)
    JBroker.reset("tres_dead_jax")
    jrunners = _dead_silo_federation(fedml_tpu, "tres_dead_jax")
    jagg = jrunners[0].runner.server_manager.aggregator
    p0 = jax.device_get(jagg.get_global_model_params())
    jres = _run_parties(jrunners)
    ref = jax.device_get(jagg.get_global_model_params())
    InMemoryBroker.reset("tres_dead_port")
    runners = _dead_silo_federation(fedml_tpu_torch, "tres_dead_port", p0=p0)
    res = _run_parties(runners)
    agg = runners[0].runner.server_manager.aggregator
    assert str(res[DEAD]).startswith("died") and str(jres[DEAD]).startswith("died")
    assert all(not str(res[r]).startswith("died") for r in res if r != DEAD)
    want = [(r, [DEAD], [1, 3]) for r in range(DEAD_ROUNDS)]
    assert closes["port"] == closes["jax"] == want
    assert tel.snapshot()["counters"][tquorum.PARTIAL_COUNTER] == DEAD_ROUNDS
    health = agg.fleet.health.export_state()
    assert health[str(DEAD)]["total_failures"] == DEAD_ROUNDS and agg.fleet.merges > 0
    got = params_to_jax(agg.get_global_model_params())
    for k in ref:
        for leaf in ref[k]:
            r, g = np.asarray(ref[k][leaf]), np.asarray(got[k][leaf])
            assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), (k, leaf)
    JBroker.reset("tres_dead_jax")
    InMemoryBroker.reset("tres_dead_port")


def test_client_telemetry_delta_is_json_and_feeds_health(fresh_telemetry):
    """Every upload carries the client's delta: JSON (no tensor, no
    torch.Size), with the client.train span the health tracker reads."""
    shipped = []
    from fedml_tpu_torch.core.telemetry import fleet as tfleet

    real = tfleet.FleetTelemetry.merge_client_delta

    def recorded(self, rank, delta):
        shipped.append(json.dumps(delta))
        return real(self, rank, delta)

    tfleet.FleetTelemetry.merge_client_delta = recorded
    try:
        runners = _dead_silo_federation(fedml_tpu_torch, "tres_delta")
        _run_parties(runners)
    finally:
        tfleet.FleetTelemetry.merge_client_delta = real
    InMemoryBroker.reset("tres_delta")
    rounds = DEAD_ROUNDS
    assert len(shipped) == 2 * rounds
    for d in map(json.loads, shipped):
        assert [s["name"] for s in d["spans"]].count("client.train") == 1
    state = runners[0].runner.server_manager.aggregator.fleet.health.export_state()
    assert state["1"]["rounds"] == state["3"]["rounds"] == rounds


# --- the SIGKILL drills ----------------------------------------------------------

def _drill(name, mode, rdir, expect_kill=False):
    proc = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.tools.resilience_drill", name, mode, str(rdir),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=DRILL_TIMEOUT_S, cwd=_REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    if expect_kill:
        assert proc.returncode in (-9, 137), (name, mode, proc.returncode, proc.stderr[-2000:])
    else:
        assert proc.returncode == 0, (name, mode, proc.returncode, proc.stderr[-2000:])
    return proc


@pytest.mark.parametrize("name", drill.DRILLS)
def test_sigkill_drill_resumes_bit_identical(name, tmp_path):
    base, crash = tmp_path / "baseline", tmp_path / "crash"
    _drill(name, "baseline", base)
    _drill(name, "crash", crash, expect_kill=True)
    partial = drill.final_state(str(crash))
    final = drill.final_state(str(base))
    if name == "cs_async":
        # killed after the committed snapshot of merge 3: a non-empty buffer
        assert partial.meta["fl_round_idx"] == 1
        assert partial.meta["async_buffer"]["merges_total"] == drill.KILL_AFTER_MERGES
        assert len(partial.meta["async_buffer"]["pending_weights"]) == 1
        assert len(partial.state["async_buffer"]["pending"]) == 1
    else:
        assert partial.round_idx < final.round_idx
    _drill(name, "resume", crash)
    resumed = drill.final_state(str(crash))
    assert resumed.round_idx == final.round_idx
    assert drill.bit_equal(resumed.state, final.state)


# --- chaos payloads --------------------------------------------------------------

CHAOS = {"nan": dict(chaos_nan_at_round=2), "scale": dict(chaos_scale_delta=3.0),
         "scale_at": dict(chaos_scale_delta=0.5, chaos_scale_at_round=2),
         "scale_other_round": dict(chaos_scale_delta=0.5, chaos_scale_at_round=1),
         "off": dict(chaos_scale_delta=1.0)}


@pytest.mark.parametrize("case", list(CHAOS))
@pytest.mark.parametrize("pair", [False, True])
def test_chaos_payloads_equal_jax(case, pair):
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32), "n": np.arange(3, dtype=np.int32)}
    args = type("A", (), CHAOS[case])()
    tin = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    got = tengine._apply_delta_chaos((tin, 7) if pair else tin, args, 2, 1)
    ref = jengine._apply_delta_chaos((tree, 7) if pair else tree, args, 2, 1)
    if pair:
        assert got[1] == ref[1] == 7
        got, ref = got[0], ref[0]
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        assert got[k].dtype == torch.from_numpy(np.asarray(ref[k])).dtype


def test_run_local_round_delay_raise_and_refusals():
    args = type("A", (), dict(chaos_train_delay_s=0.2, chaos_train_delay_rounds=1,
                              chaos_raise_at_round=3))()
    t0 = time.perf_counter()
    assert tengine.run_local_round(lambda: {"w": torch.ones(1)}, args, 0, rank=1)["w"].item() == 1.0
    assert time.perf_counter() - t0 >= 0.2
    t0 = time.perf_counter()
    tengine.run_local_round(lambda: {"w": torch.ones(1)}, args, 1, rank=1)
    assert time.perf_counter() - t0 < 0.2  # past chaos_train_delay_rounds
    with pytest.raises(RuntimeError, match="chaos: injected failure at round 3 on rank 1"):
        tengine.run_local_round(lambda: {}, args, 3, rank=1)
    ok = fedml_tpu_torch.default_config("cross_silo", chaos_train_delay_s=1.0, chaos_nan_at_round=0,
                                        chaos_kill_after_round=1, chaos_scale_delta=2.0,
                                        chaos_secagg_drop_upload_at_round=0,
                                        chaos_link_throttle=1e6, chaos_link_base_delay_s=0.1)
    tengine.refuse_chaos_knobs(ok)
    for knob in ("chaos_split_kill_rank", "chaos_split_send_fail_n"):
        with pytest.raises(NotImplementedError, match=knob):
            tengine.refuse_chaos_knobs(fedml_tpu_torch.default_config("cross_silo", **{knob: 1}))


def test_deadline_of_an_old_round_never_closes_the_next(tmp_path):
    """The timer thread's callback: a deadline of round r that fires after
    the round advanced does nothing; at its own round it closes partially
    when the quorum is met (the missing rank marked failed), else re-arms."""
    args = fedml_tpu_torch.default_config(
        "cross_silo", run_id="tres_timer", rank=0, role="server", backend="INMEMORY",
        dataset="synthetic", model="lr", client_num_in_total=3, client_num_per_round=3,
        using_gpu=False, quorum_frac=0.5, round_deadline_s=30.0)
    dataset, output_dim = fedml_tpu_torch.data.load(copy.copy(args))
    model = fedml_tpu_torch.model.create(args, output_dim, device="cpu")
    server = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model) \
        .runner.server_manager
    closed = []
    server._complete_round = lambda: closed.append(int(server.args.round_idx))
    policy = tquorum.QuorumPolicy.from_args(args)
    server._round_quorum = q = tquorum.RoundQuorum(0, [1, 2, 3], 3, policy)
    server.args.round_idx = 1
    server._on_round_deadline(0)                   # round 0's timer, round 1 running
    assert closed == [] and not q.statusz()["closed"]
    server.args.round_idx = 0
    server._on_round_deadline(0)                   # nothing arrived: extend
    assert closed == [] and server._deadline_timer is not None
    server._cancel_deadline_timer()
    q.on_delta(1, 0)
    q.on_delta(3, 0)
    server._on_round_deadline(0)
    assert closed == [0] and q.statusz()["closed"]
    assert server.aggregator.fleet.health.export_state()["2"]["total_failures"] == 1
    InMemoryBroker.reset("tres_timer")


def test_first_delta_ships_no_span_recorded_before_the_client(fresh_telemetry):
    """Thread idents are reused once a thread ends: a span an earlier party
    recorded under the ident of this client's thread must not ride the
    client's first upload, or health would read another party's round
    time."""
    from fedml_tpu_torch.core.distributed.communication.message import Message

    t = tel.get_telemetry()
    with t.span("client.train", round=7):  # an earlier party on this thread's ident
        pass
    args = fedml_tpu_torch.default_config(
        "cross_silo", run_id="tres_cursor", rank=1, role="client", backend="INMEMORY",
        dataset="synthetic", model="lr", client_num_in_total=2, client_num_per_round=2,
        using_gpu=False)
    dataset, output_dim = fedml_tpu_torch.data.load(copy.copy(args))
    model = fedml_tpu_torch.model.create(args, output_dim, device="cpu")
    client = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model) \
        .runner.client_manager
    with t.span("client.train", round=0):  # this client's own round
        pass
    msg = Message(3, 1, 0)
    client._attach_telemetry_delta(msg)
    delta = msg.get(Message.MSG_ARG_KEY_TELEMETRY)["delta"]
    assert [s["attrs"]["round"] for s in delta["spans"] if s["name"] == "client.train"] == [0]
    InMemoryBroker.reset("tres_cursor")
