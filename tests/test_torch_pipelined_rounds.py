"""Pipelined round execution in the port (``fedml_tpu_torch/core/pipeline``)
against the JAX package's (``tests/test_pipelined_rounds.py``), on the CPU.

- the executor: order kept, overlap measured, zero overlap when one stage
  owns the work, a stage error raised without a hang, its series, its
  flight-recorder marks and the round's trace context on every worker;
- the micro-batch planner: the same verdicts as JAX's for the same probes,
  with both netlink modules on one fake clock (exact);
- the sp front: fold-at-arrival (FedAvg) and pairs mode (SCAFFOLD, FedOpt)
  bit-equal to the port's sequential round (exact, f32);
- the port's pipelined round against JAX's pipelined round in float64 (LR
  on the MNIST surrogate, both packages in float64): the final params
  within ``F64_TOL`` of their scale. The folds accumulate in f32 in both
  packages, in other summation orders, about an f32 ulp apart (measured
  worst 1.1e-7 of the params' scale, FedAvg and FedOpt);
- the ``pipeline_overlap_frac`` SLO: a collapsed pipeline fires, a healthy
  one does not.
"""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.pipeline import microbatch as jmb
from fedml_tpu.core.telemetry import netlink as jnet
from fedml_tpu.data import data_loader as jloader
from fedml_tpu.data.dataset import ArrayDataset as JArrayDataset
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.core.pipeline import (
    MicroBatchPlan,
    PipelineError,
    PipelinedBufferSink,
    PipelinedExecution,
    PipelinedExecutor,
    StageSpec,
    even_micro_batches,
    plan_micro_batches,
)
from fedml_tpu_torch.core.telemetry import flight_recorder as tfr
from fedml_tpu_torch.core.telemetry import netlink as tnet
from fedml_tpu_torch.core.telemetry import slo as tslo
from fedml_tpu_torch.core.telemetry import trace_context
from fedml_tpu_torch.data import data_loader as tloader
from fedml_tpu_torch.data.dataset import ArrayDataset as TArrayDataset
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

F64_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch steps: under several test workers a pool of threads
    in each only spins against the others'."""
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


@pytest.fixture
def telemetry_on():
    """Telemetry on and empty for the test, its state put back after."""
    was = tel.get_telemetry().enabled
    tel.set_enabled(True)
    tel.reset()
    yield
    tel.reset()
    tel.set_enabled(was)


# --- the executor ----------------------------------------------------------------

def test_output_order_preserved():
    ex = PipelinedExecutor([StageSpec("a", lambda x: x + 1), StageSpec("b", lambda x: x * 10)])
    report = ex.run(range(20))
    assert report.outputs == [(i + 1) * 10 for i in range(20)]
    assert [s.items for s in report.stages] == [20, 20]


def test_stages_overlap():
    """Two equal sleep stages: the wall beats the serial sum and at least
    half of the achievable overlap is realized."""
    dt = 0.02
    ex = PipelinedExecutor([StageSpec("sleep1", lambda x: (time.sleep(dt), x)[1]),
                            StageSpec("sleep2", lambda x: (time.sleep(dt), x)[1])])
    report = ex.run(range(10))
    assert report.wall_s < report.serial_s
    assert report.overlap_frac >= 0.5


def test_collapsed_pipeline_reports_zero_overlap():
    ex = PipelinedExecutor([StageSpec("work", lambda x: (time.sleep(0.01), x)[1]),
                            StageSpec("noop", lambda x: x)])
    report = ex.run(range(6))
    assert report.overlap_frac < 0.2
    assert report.bottleneck == "work"


def test_stage_error_propagates_without_hanging():
    def boom(x):
        if x == 3:
            raise ValueError("injected")
        return x

    ex = PipelinedExecutor([StageSpec("boom", boom), StageSpec("sink", lambda x: x)])
    t0 = time.monotonic()
    with pytest.raises(PipelineError) as ei:
        ex.run(range(50))
    assert ei.value.stage == "boom" and isinstance(ei.value.cause, ValueError)
    assert time.monotonic() - t0 < 10.0
    assert not [t for t in threading.enumerate() if t.name.startswith("pipeline-")]


def test_single_stage_and_empty_input():
    ex = PipelinedExecutor([StageSpec("only", lambda x: x * 2)])
    assert ex.run([1, 2, 3]).outputs == [2, 4, 6]
    report = ex.run([])
    assert report.outputs == [] and report.overlap_frac == 0.0


def test_emits_pipeline_series(telemetry_on):
    PipelinedExecutor([StageSpec("a", lambda x: x)]).run(range(4))
    snap = tel.snapshot()
    assert any("pipeline.items" in k for k in snap["counters"])
    for series in ("pipeline.stage_seconds", "pipeline.overlap_frac",
                   "pipeline.stage_stall_seconds", "pipeline.queue_depth"):
        assert any(series in k for k in snap["histograms"]), series


def test_flight_recorder_marks_and_trace_context_on_workers(tmp_path, telemetry_on):
    """One mark at the run's start and end and one event per stage drain;
    a stage span's parent is the caller's round span on every worker."""
    rec = tfr.install(role="t", recorder=tfr.FlightRecorder(dump_dir=str(tmp_path)))
    ctx = trace_context.TraceContext(trace_context.new_trace_id(), 41, 3)
    try:
        with trace_context.activated(ctx):
            PipelinedExecutor([StageSpec("a", lambda x: x), StageSpec("b", lambda x: x)],
                              name="pipeline").run(range(3))
        names = [e[2] for e in rec.events()]
        assert "pipeline_run" in names and "pipeline_done" in names
        assert "pipeline.a.drained" in names and "pipeline.b.drained" in names
        spans = [r for r in tel.snapshot()["spans"] if r["name"] in ("pipeline.a", "pipeline.b")]
        assert len(spans) == 6
        assert all(r.get("trace_id") == ctx.trace_id and r.get("trace_parent") == 41
                   and r.get("trace_round") == 3 for r in spans)
    finally:
        tfr.uninstall()


# --- the micro-batch planner -----------------------------------------------------

class _Clock:
    """One fake clock for both netlink modules: their estimators' freshness
    reads ``time.monotonic``, which must not differ between the sides."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time_ns(self):
        return int(self.t * 1e9)

    def perf_counter_ns(self):
        return int(self.t * 1e9)


def _prime(net, src, dst, *, rtt_s, bw_bytes_s, n=5):
    reg = net.get_registry()
    for _ in range(n):
        reg.observe_probe(src, dst, rtt_s, 0)
    nbytes = int(bw_bytes_s * rtt_s)
    for _ in range(n):
        reg.observe_probe(src, dst, rtt_s + 2.0 * nbytes / bw_bytes_s, nbytes)


PLANS = {
    # (link or None, total bytes, compute s, planner kwargs)
    "cold": (None, 10_000, 1.0, dict(default_chunks=4)),
    "balanced": ((0.010, 1e6), 100_000, 1.0, dict(max_chunks=64)),
    "balanced_clamped": ((0.010, 1e6), 100_000, 0.2, dict(max_chunks=8)),
    "bandwidth_bound": ((0.010, 1e4), 100_000, 0.5, {}),
    "clamps": ((0.010, 1e6), 100, 100.0, dict(min_chunks=2, max_chunks=6)),
    "stale_link": ((0.010, 1e6), 100_000, 1.0, dict(min_confidence=0.9)),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_planner_verdicts_equal_jax(case, monkeypatch):
    """Exact: the same probes on both sides' registries give the same plan
    (chunks, chunk bytes, predicted seconds, confidence, reason)."""
    link, total, compute, kw = PLANS[case]
    clock = _Clock()
    plans = {}
    for side, (net, plan_fn) in {"jax": (jnet, jmb.plan_micro_batches),
                                 "port": (tnet, plan_micro_batches)}.items():
        monkeypatch.setattr(net, "time", clock)
        clock.t = 1000.0
        if link is not None:
            _prime(net, 1, 0, rtt_s=link[0], bw_bytes_s=link[1])
        clock.t = 1030.0 if case == "stale_link" else 1000.5  # freshness decays
        plans[side] = plan_fn(total, compute, src=1, dst=0, **kw).as_dict()
    assert plans["port"] == plans["jax"]
    assert isinstance(plan_micro_batches(1, 0.0, src=9, dst=0), MicroBatchPlan)


def test_even_micro_batches_equal_jax():
    for b in range(1, 40):
        for m in range(0, 12):
            assert even_micro_batches(b, m) == jmb.even_micro_batches(b, m), (b, m)


# --- the sp front: pipelined against sequential ------------------------------------

SP = dict(random_seed=0, dataset="mnist", data_cache_dir="", partition_method="hetero",
          partition_alpha=0.5, model="lr", client_num_in_total=4, client_num_per_round=2,
          comm_round=2, epochs=1, batch_size=16, client_optimizer="sgd",
          learning_rate=0.03, weight_decay=0.001, frequency_of_the_test=1, backend="sp")


def _port_api(optimizer, **over):
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config(
        "simulation", using_gpu=False, **{**SP, "federated_optimizer": optimizer, **over}))
    dataset, dim = fedml_tpu_torch.data.load(args)
    model = fedml_tpu_torch.model.create(args, dim, device="cpu")
    return FedAvgAPI(args, torch.device("cpu"), dataset, model)


def _equal(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("optimizer,fold_at_arrival", [
    ("FedAvg", True), ("SCAFFOLD", False), ("FedOpt", False)])
def test_pipelined_round_is_bit_equal_to_sequential(optimizer, fold_at_arrival):
    """Exact: the published model after 2 rounds, and each round's eval."""
    seq = _port_api(optimizer)
    seq.train()
    pipe = _port_api(optimizer, client_execution="pipelined")
    built = {}
    orig = pipe._build_execution

    def capture():
        built["strategy"], built["sink"] = orig()
        return built["strategy"], built["sink"]

    pipe._build_execution = capture
    pipe.train()
    strategy, sink = built["strategy"], built["sink"]
    assert isinstance(strategy, PipelinedExecution)
    assert strategy.fold_at_arrival is fold_at_arrival
    assert isinstance(sink, PipelinedBufferSink) is fold_at_arrival
    assert [s.name for s in strategy.last_report.stages] == ["train", "compress", "uplink", "fold"]
    assert strategy.last_plan is not None and 0.0 <= strategy.last_report.overlap_frac <= 1.0
    assert _equal(seq.model_trainer.get_model_params(), pipe.model_trainer.get_model_params())
    assert seq.metrics_history == pipe.metrics_history


def test_other_client_execution_values_raise():
    with pytest.raises(NotImplementedError, match="threaded"):
        _port_api("FedAvg", client_execution="threaded")


def _f64_mnist(load, ds_cls, args):
    """The MNIST surrogate's shards and test set with float64 images."""
    d = load(args)
    local = {c: ds_cls(s.x.astype(np.float64), s.y) for c, s in d[5].items()}
    test = ds_cls(d[3].x[:512].astype(np.float64), d[3].y[:512])
    return (d[0], 512, d[2], test, d[4], local, {c: test for c in local}, d[7])


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


@pytest.mark.parametrize("optimizer", ["FedAvg", "FedOpt"])
def test_pipelined_round_tracks_jax_s_in_float64(optimizer):
    """Both packages' pipelined rounds (fold-at-arrival for FedAvg, pairs
    mode for FedOpt) from JAX's initial params, in float64: the final
    params within F64_TOL of their scale."""
    kw = dict(SP, federated_optimizer=optimizer, client_execution="pipelined")
    jdata = _f64_mnist(jloader.load, JArrayDataset, fedml_tpu.default_config("simulation", **kw))
    # process-wide: the pipeline's train stage runs JAX on a worker thread,
    # which jax.enable_x64's thread-local context would not reach
    jax.config.update("jax_enable_x64", True)
    try:
        jargs = fedml_tpu.init(fedml_tpu.default_config("simulation", **kw))
        jmodel = fedml_tpu.model.create(jargs, jdata[-1])
        jmodel.params = jax.tree.map(lambda leaf: jnp.asarray(leaf, jnp.float64), jmodel.params)
        p0 = jax.device_get(jmodel.params)
        runner = fedml_tpu.FedMLRunner(jargs, "cpu", jdata, jmodel)
        runner.run()
        ref = jax.device_get(runner.runner.fl_trainer.model_trainer.get_model_params())
    finally:
        jax.config.update("jax_enable_x64", False)

    targs = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw))
    tdata = _f64_mnist(tloader.load, TArrayDataset, targs)
    model = fedml_tpu_torch.model.create(targs, tdata[-1], device="cpu")
    model.module.load_state_dict(params_from_jax(p0))
    model.module.to(torch.float64)
    model.params = {k: v.clone() for k, v in model.module.state_dict().items()}
    api = FedAvgAPI(targs, torch.device("cpu"), tdata, model)
    api.train()
    got = params_to_jax(api.model_trainer.get_model_params())
    g, r = _leaves(got), _leaves(ref)
    assert all(np.asarray(g[k]).dtype == np.float64 for k in g)
    err = max(float(np.abs(np.asarray(g[k]) - np.asarray(r[k])).max()) for k in r)
    scale = max(float(np.abs(np.asarray(r[k])).max()) for k in r)
    assert err <= F64_TOL * scale, err / scale


# --- the pipeline_overlap_frac SLO ------------------------------------------------

def _overlap_transitions(stages, n):
    tslo.reset()
    engine = tslo.activate(types.SimpleNamespace(), front="engine")
    try:
        PipelinedExecutor(stages).run(range(n))
        transitions = []
        for _ in range(3):
            transitions += engine.tick()
        return transitions
    finally:
        tslo.deactivate(engine)
        tslo.reset()


def test_collapsed_pipeline_fires_pipeline_overlap_frac(telemetry_on):
    transitions = _overlap_transitions(
        [StageSpec("work", lambda x: (time.sleep(0.005), x)[1]), StageSpec("noop", lambda x: x)], 6)
    overlap = [t for t in transitions if t["slo"] == "pipeline_overlap_frac"]
    assert overlap and overlap[-1]["to"] == "firing", transitions
    assert not any(t["slo"] == "pipeline_stage_stall_p99_seconds" for t in transitions)


def test_healthy_pipeline_does_not_alert(telemetry_on):
    dt = 0.01
    transitions = _overlap_transitions(
        [StageSpec("a", lambda x: (time.sleep(dt), x)[1]),
         StageSpec("b", lambda x: (time.sleep(dt), x)[1])], 8)
    assert not any(t["slo"] == "pipeline_overlap_frac" for t in transitions)
