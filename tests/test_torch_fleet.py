"""The port's fleet view (health, fleet telemetry) against the JAX package's,
on the CPU.

``health.py`` is a copy but for its ``/metrics`` gauges and ``fleet.py``
JAX's but for modelwatch's ledger and netlink, so every comparison here is
exact: the same observations and deltas give the same reports, exported
states, per-rank summaries and fleet sketches. Only the fields that read
the clock differ by construction and are left out: a client's
``silence_s`` (seconds since its last report, on each package's monotonic
clock, and the ``score`` that drops to 0 past the silence threshold) and
the sketches' own ingest and merge times (``observe_ms``, ``merge_ms``).
``tests/test_torch_sketches.py`` holds the sketches themselves.
"""

import json

import pytest

from fedml_tpu.core.telemetry import fleet as jfleet
from fedml_tpu.core.telemetry import health as jhealth
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.core.telemetry import fleet as tfleet
from fedml_tpu_torch.core.telemetry import health as thealth


def _no_clock(report):
    """A health report or statusz dict without its clock-read fields."""
    out = json.loads(json.dumps(report))
    # statusz nests the last report, whose clients carry silence_s as well
    for doc in (out, out.get("last_report") or {}):
        for c in doc.get("clients", {}).values():
            c.pop("silence_s", None)
    return out


def _feed_health(mod, script):
    h = mod.HealthTracker(ewma_alpha=0.3, mad_z_threshold=3.5, min_gap_s=0.1,
                          silence_threshold_s=300.0)
    reports = []
    for op, *a in script:
        if op == "obs":
            h.observe_round(*a)
        elif op == "fail":
            h.observe_failure(*a)
        elif op == "beat":
            h.heartbeat(*a)
        else:
            reports.append(_no_clock(h.end_round(*a)))
    return h, reports


HEALTH_SCRIPTS = {
    # one straggler among five, then it recovers
    "straggler": [("obs", r, 1.0 + 0.01 * r) for r in range(1, 5)] + [("obs", 5, 4.0), ("end", 0)]
                 + [("obs", r, 1.0) for r in range(1, 6)] + [("end", 1)],
    # MAD == 0: two tie exactly, the absolute floor decides
    "mad_zero": [("obs", 1, 1.0), ("obs", 2, 1.0), ("obs", 3, 1.0), ("obs", 4, 1.5), ("end", 0)],
    # a cohort of two cannot flag; failures and heartbeats
    "small_and_failures": [("obs", 1, 1.0), ("obs", 2, 9.0), ("fail", 3), ("fail", 3),
                           ("beat", 2), ("end", 0), ("obs", 3, 2.0), ("end", 1)],
    # a rank reporting twice in a round keeps its latest value
    "twice": [("obs", 1, 1.0), ("obs", 1, 3.0), ("obs", 2, 1.1), ("obs", 3, 1.2),
              ("obs", 4, 1.0), ("end", 7)],
}


@pytest.mark.parametrize("script", list(HEALTH_SCRIPTS))
def test_health_tracker_matches_jax(script):
    th, tr = _feed_health(thealth, HEALTH_SCRIPTS[script])
    jh, jr = _feed_health(jhealth, HEALTH_SCRIPTS[script])
    assert tr == jr
    assert th.export_state() == jh.export_state()
    assert _no_clock(th.statusz()) == _no_clock(jh.statusz())
    # a resumed tracker carries the baselines the adaptive deadline reads
    restored = thealth.HealthTracker()
    restored.restore_state(json.loads(json.dumps(th.export_state())))
    assert restored.export_state() == th.export_state()


@pytest.mark.parametrize("values", [[1.0, 1.1, 0.9, 5.0], [2.0, 2.0, 2.0], [0.3],
                                    [1, 2, 3, 4, 100]])
def test_robust_zscores_match_jax(values):
    assert thealth.robust_zscores(list(values)) == jhealth.robust_zscores(list(values))


def _delta(rank, durations, error_round=None, extra=None):
    spans = [{"name": "client.train", "t0_ns": 1_000 * i, "dur_ns": int(d * 1e9), "seq": i + 1,
              "tid": 100 + rank, "attrs": {"round": i}} for i, d in enumerate(durations)]
    if error_round is not None:
        spans[error_round]["error"] = True
    d = {"spans": spans + [{"name": "client.upload", "t0_ns": 5, "dur_ns": 7, "seq": 99,
                            "tid": 100 + rank, "attrs": {}}],
         "counters": {"x": rank}, "histograms": {}, "span_stats": {"client.train": {"count": 1}},
         "thread_names": {str(100 + rank): f"party-{rank}"}, "epoch_unix_ns": 123,
         "dropped": 0, "rank": rank}
    d.update(extra or {})
    return d


def _merge_script(mod):
    f = mod.FleetTelemetry()
    f.set_expected_ranks([1, 2, 3, 4])
    out = [f.merge_client_delta(r, _delta(r, [1.0 + 0.01 * r])) for r in (1, 2, 3)]
    out.append(f.merge_client_delta(4, _delta(4, [5.0])))
    out.append(f.merge_client_delta(9, _delta(9, [1.0])))            # outside the cohort: stale
    out.append(f.merge_client_delta(2, "junk"))                      # rejected
    out.append(f.merge_client_delta("x", {}))                        # rejected
    out.append(f.merge_client_delta(3, _delta(3, [1.0, 2.0], error_round=1,
                                              extra={"future_key": 1, "link": {"a": 1}})))
    report = f.health.end_round(0)
    f.set_expected_ranks(None)
    out.append(f.merge_client_delta(9, _delta(9, [1.2])))
    summary = f.summary()
    for k in ("observe_ms", "merge_ms"):  # each package's own clock
        summary["sketches"].pop(k)
    return f, out, _no_clock(report), summary


def test_fleet_merge_health_and_summary_match_jax():
    tf, tout, trep, tsum = _merge_script(tfleet)
    jf, jout, jrep, jsum = _merge_script(jfleet)
    assert tout == jout == [True, True, True, True, False, False, False, True, True]
    assert trep == jrep and trep["stragglers"] == [4]
    assert tsum == jsum
    assert tsum["stale"] == 1 and tsum["rejected"] == 2
    assert tsum["unknown_keys"] == ["future_key", "rank"]  # the port's and JAX's clients add "rank"
    assert tf.health.export_state() == jf.health.export_state()
    assert tf.health.export_state()["3"]["total_failures"] == 1
    assert tf.ranks == jf.ranks == [1, 2, 3, 4, 9]


def test_a_child_tiers_sketch_wire_is_known_and_unread():
    """A delta carrying JAX's hierarchy sketch wire and netlink block merges
    like any other: neither is an unknown key, and the health feed does not
    read them (the same health as without them, and as JAX's merge). The
    sketch wire is a child tier's slot: the port's sketch view takes it as
    JAX's does, and netlink's block stays unread."""
    from fedml_tpu.core.telemetry import sketches as jsk
    from fedml_tpu_torch.core.telemetry import sketches as tsk

    js = jsk.FleetSketches()
    js.observe_round_times([1, 2], [1.0, 2.0])
    extra = {"sketches": js.to_wire(), "link": {"1->0": {"bytes": 10}}}
    states, views = [], []
    for mod, with_extra in ((tfleet, True), (tfleet, False), (jfleet, True)):
        f = mod.FleetTelemetry()
        for r in (1, 2, 3):
            assert f.merge_client_delta(r, _delta(r, [1.0 + r], extra=extra if with_extra else None))
        f.health.end_round(0)
        if mod is tfleet and with_extra:
            assert f.summary()["unknown_keys"] == ["rank"]
        states.append(f.health.export_state())
        view = f.sketch_view()
        views.append((view.observations, view.quantiles["round_time_s"].to_bytes()))
    assert states[0] == states[1] == states[2]
    # three direct round times, plus a slot of the wire's two for each rank
    # that carried it (a slot is keyed by the sender's rank)
    assert views[0] == views[2] and views[0][0] == 3 + 3 * 2 and views[1][0] == 3
    assert isinstance(tsk.FleetSketches.from_wire(js.to_wire()), tsk.FleetSketches)


def test_fleet_trace_has_a_lane_per_client(tmp_path):
    f, *_ = _merge_script(tfleet)
    t = tel.Telemetry()
    with t.span("server.round", round=0):
        pass
    path = f.export_fleet_trace(str(tmp_path / "fleet.json"), server=t)
    doc = json.load(open(path))
    lanes = {e["args"]["name"] for e in doc["traceEvents"] if e.get("name") == "process_name"}
    assert lanes == {"server", "client-1", "client-2", "client-3", "client-4", "client-9"}
    assert any(e.get("name") == "server.round" and e["pid"] == 0 for e in doc["traceEvents"])
