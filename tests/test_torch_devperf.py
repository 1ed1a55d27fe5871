"""The port's devperf (``fedml_tpu_torch/core/telemetry/devperf.py``) and its
device table (``core/distributed/device_specs.py``) against the JAX
package's, on the CPU; mirrors ``tests/test_devperf.py``.

Tolerances:

- the fold, ``observe_window`` and the snapshot on the same label, wall
  time, steps, tokens, hint and device-kind string: equal to 1e-12 relative
  (the same host float math);
- the H100 rows: NVIDIA's datasheet values exactly;
- prom: the ``fedml_program_*`` and ``fedml_device_*`` lines byte-equal to
  JAX's render of the same registry;
- the LLM trainer's MFU: tokens/s x FLOPs a token / peak within 1e-9, and
  its FLOPs a token equal to the JAX trainer's for the same model;
- a decode chunk's FLOPs: :func:`decode_flops` equal to a token-by-token
  count of the same chunk.

The sampler runs on an injected stats source (the CPU has no device
memory to read) and must leave no thread behind.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from fedml_tpu.core.telemetry import core as jcore
from fedml_tpu.core.telemetry import devperf as jdev
from fedml_tpu.core.telemetry import prom as jprom
from fedml_tpu_torch.core.distributed import device_specs as tspecs
from fedml_tpu_torch.core.telemetry import core as tcore
from fedml_tpu_torch.core.telemetry import devperf as tdev
from fedml_tpu_torch.core.telemetry import flight_recorder as tfr
from fedml_tpu_torch.core.telemetry import prom as tprom
from fedml_tpu_torch.core.telemetry import slo as tslo
from fedml_tpu_torch.core.telemetry import statusz as tstatusz
from fedml_tpu_torch.core.telemetry import tsdb as ttsdb

# the fields both packages' records keep (the port's adds "dtype")
SHARED = ("label", "n_devices", "device_kind", "captured", "flops_hint",
          "flops_per_token_hint", "flops_source", "peak_flops_per_sec", "calls", "steps",
          "tokens", "device_seconds", "last_step_wall_s", "achieved_flops_per_sec", "mfu")


@pytest.fixture(autouse=True)
def fresh_registries(monkeypatch):
    """Each test starts from empty registries on both sides, with devperf
    on, and leaves none behind."""
    monkeypatch.delenv("FEDML_DEVPERF", raising=False)
    jdev.reset()
    tdev.reset()
    yield
    jdev.reset()
    tdev.reset()
    ttsdb.reset()


def _both_registered(label, kind, **hints):
    for dev in (jdev, tdev):
        reg = dev.get_registry()
        reg.register(label, **hints)
        reg.note_capture(label, device_kind=kind, flops_xla=None, bytes_accessed=None,
                         memory=None, aot=False)


def _close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return a == pytest.approx(b, rel=1e-12, abs=0.0)
    return a == b


@pytest.mark.parametrize("kind", ["cpu", "unknown-chip", ""])
@pytest.mark.parametrize("case", [
    dict(hints=dict(flops_per_token_hint=250.0), wall=0.4, steps=8, tokens=8 * 512),
    dict(hints=dict(flops_per_token_hint=6.5e9), wall=1.7, steps=3, tokens=3 * 4096),
    dict(hints=dict(flops_hint=123.0), wall=0.5, steps=1, tokens=None),
])
def test_fold_and_snapshot_equal_jax(kind, case):
    """The same window folded twice into both registries: the same MFU,
    rates and counts, field by field."""
    _both_registered("t_parity", kind, **case["hints"])
    for _ in range(2):
        mj = jdev.observe_window("t_parity", case["wall"], case["steps"], tokens=case["tokens"])
        mt = tdev.observe_window("t_parity", case["wall"], case["steps"], tokens=case["tokens"])
        assert mt == pytest.approx(mj, rel=1e-12)
    rj = jdev.snapshot()["programs"]["t_parity"]
    rt = tdev.snapshot()["programs"]["t_parity"]
    for key in SHARED:
        assert _close(rt[key], rj[key]), (key, rt[key], rj[key])
    assert rt["flops_source"] == tdev.FLOPS_SOURCE_ANALYTIC == jdev.FLOPS_SOURCE_ANALYTIC
    assert rt["dtype"] == "bfloat16"
    fold_j = jdev.get_registry().fold("t_parity", case["wall"], case["steps"], case["tokens"])
    fold_t = tdev.get_registry().fold("t_parity", case["wall"], case["steps"], case["tokens"])
    assert all(_close(a, b) for a, b in zip(fold_t, fold_j)), (fold_t, fold_j)


def test_degenerate_windows_and_unknown_labels_fold_nothing():
    _both_registered("t_deg", "cpu", flops_hint=1.0)
    for dev in (jdev, tdev):
        assert dev.get_registry().fold("t_deg", 0.0, 1, None) is None
        assert dev.get_registry().fold("t_deg", 1.0, 0, None) is None
        assert dev.get_registry().fold("no_such_label", 1.0, 1, None) is None
        assert dev.observe_step("no_such_label", 1.0) is None


def test_a_window_s_own_flops_win_over_the_hints():
    """The decode steps pass their own analytic count (P3)."""
    tdev.instrument(lambda: None, "t_own", flops_hint=1.0, device="cpu")
    mfu = tdev.observe_step("t_own", 2.0, steps=4, tokens=32, flops=8e12)
    assert mfu == pytest.approx(8e12 / 2.0 / tspecs.peak_flops_per_sec("cpu"), rel=1e-12)
    rec = tdev.snapshot()["programs"]["t_own"]
    assert rec["steps"] == 4 and rec["tokens"] == 32 and rec["device_seconds"] == 2.0


def test_disabled_layer_registers_and_folds_nothing(monkeypatch):
    monkeypatch.setenv("FEDML_DEVPERF", "0")
    fn = object()
    assert tdev.instrument(fn, "t_off", flops_hint=1.0) is fn
    assert tdev.observe_step("t_off", 1.0) is None
    assert tdev.start_hbm_sampler() is None
    assert tdev.statusz_snapshot() == {} and tdev.prom_gauges() == []
    assert tdev.snapshot()["programs"] == {}


@pytest.mark.parametrize("name,row,bf16,tf32,f32,hbm,bw", [
    ("NVIDIA H100 80GB HBM3", "h100", 989.4, 494.7, 66.9, 80 * 2**30, 3.35e12),
    ("NVIDIA H100 PCIe", "h100 pcie", 756.5, 378.0, 51.0, 80 * 2**30, 2.0e12),
    ("NVIDIA H100 NVL", "h100 nvl", 835.5, 417.5, 60.0, 94 * 2**30, 3.9e12),
])
def test_h100_rows(name, row, bf16, tf32, f32, hbm, bw):
    """Most specific first: PCIe and NVL before the bare SXM row."""
    assert tspecs.device_row(name) == row
    assert tspecs.peak_tflops(name, torch.bfloat16) == bf16
    assert tspecs.peak_tflops(name, "float16") == bf16
    assert tspecs.peak_tflops(name, torch.float32) == f32
    assert tspecs.peak_tflops(name, "tfloat32") == tf32
    assert tspecs.device_hbm_bytes(name) == hbm
    assert tspecs.hbm_bandwidth_bytes_per_sec(name) == bw
    assert tspecs.roofline_ridge_flops_per_byte(name) == pytest.approx(bf16 * 1e12 / bw)


@pytest.mark.parametrize("name", ["cpu", "NVIDIA A100-SXM4-80GB", "TPU v4", ""])
def test_unknown_devices_keep_jax_s_defaults(name):
    """No row: the JAX package's 2 TFLOP/s (half at 32 bits) and 50 GB/s,
    so a CPU run still has a peak. A TPU kind is unknown here."""
    from fedml_tpu.core.distributed import device_specs as jspecs

    assert tspecs.device_row(name) is None
    assert tspecs.peak_tflops(name, torch.bfloat16) == jspecs.UNKNOWN_PEAK_TFLOPS == 2.0
    assert tspecs.peak_tflops(name, torch.float32) == 1.0
    assert tspecs.device_hbm_bytes(name) is None
    assert tspecs.hbm_bandwidth_bytes_per_sec(name) == jspecs.UNKNOWN_BANDWIDTH_BYTES_PER_S
    with pytest.raises(ValueError, match="int8"):
        tspecs.peak_tflops(name, "int8")


def test_device_kind_of_the_cpu():
    assert tdev.device_kind("cpu") == "cpu"
    tdev.instrument(lambda: None, "t_kind", flops_hint=1.0, device=torch.device("cpu"),
                    dtype=torch.float32)
    rec = tdev.snapshot()["programs"]["t_kind"]
    assert rec["device_kind"] == "cpu" and rec["dtype"] == "float32"
    assert rec["peak_flops_per_sec"] == 1e12
    assert rec["memory"] == {}  # no card to read


def _families(text):
    return [line for line in text.splitlines()
            if line.startswith(("fedml_program_", "fedml_device_"))
            or any(f in line for f in (" fedml_program_", " fedml_device_"))]


def test_prom_families_equal_jax_s_render():
    """The same programs and HBM rows: the fedml_program_* counters and
    fedml_device_* gauges render byte-equal."""
    regs = {"jax": jcore.Telemetry(), "port": tcore.Telemetry()}
    for side, (core, dev) in {"jax": (jcore, jdev), "port": (tcore, tdev)}.items():
        reg = dev.get_registry()
        reg.register("t_prom", flops_hint=100.0)
        reg.note_capture("t_prom", device_kind="", flops_xla=None, bytes_accessed=None,
                         memory=None, aot=False)
        reg.note_hbm("cuda:0", {"bytes_in_use": 7.0, "peak_bytes_in_use": 9.0,
                                "bytes_limit": 10.0})
        out = dev.get_registry().fold("t_prom", 0.5, 2, None)
        regs[side].counter("program.steps.t_prom").add(2)
        regs[side].counter("program.flops.t_prom").add(float(out[0]))
    jtext = jprom.render(regs["jax"], gauges=jdev.prom_gauges())
    ttext = tprom.render(regs["port"], gauges=tdev.prom_gauges())
    jf, tf = _families(jtext), _families(ttext)
    assert tf == jf
    assert any(line.startswith('fedml_device_mfu{program="t_prom"}') for line in tf)
    assert any(line.startswith('fedml_device_hbm_high_water_bytes{device="cuda:0"}') for line in tf)
    assert any(line.startswith('fedml_program_flops_total{program="t_prom"}') for line in tf)


def test_devperf_rides_along_on_metrics_and_statusz():
    """Once a program folded, /metrics carries its gauges and /statusz a
    devperf section, with no per-process wiring."""
    tdev.instrument(lambda: None, "t_ride", flops_hint=1e9, device="cpu")
    tdev.observe_step("t_ride", 0.5)
    text = tprom.render(tcore.get_telemetry())
    assert 'fedml_device_mfu{program="t_ride"} 0.001' in text
    doc = tstatusz.render(service="t")
    sec = doc["sections"]["devperf"]
    assert sec["programs"]["t_ride"]["mfu"] == pytest.approx(1e-3)
    assert sec["enabled"] is True and sec["sampler"]["running"] is False


def test_sampler_starts_and_stops_without_a_thread_leak():
    stats = [("cuda:0", {"bytes_in_use": 10.0, "peak_bytes_in_use": 12.0, "bytes_limit": 100.0})]
    sampler = tdev.HbmSampler(interval_s=0.01, stats_fn=lambda: stats)
    sampler.start()
    sampler.start()  # idempotent
    assert sampler.running
    deadline = time.monotonic() + 5.0
    while sampler.samples < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sampler.samples >= 2
    sampler.stop()
    sampler.stop()  # idempotent
    assert not sampler.running
    assert all(t.name != "devperf-hbm" for t in threading.enumerate())
    hbm = tdev.get_registry().snapshot()["hbm"]
    assert hbm["cuda:0"]["peak_bytes_in_use"] == 12.0


def test_process_sampler_on_the_cpu_samples_nothing():
    """The default source reads no device on the CPU; start/stop joins."""
    sampler = tdev.start_hbm_sampler(0.01)
    assert tdev.start_hbm_sampler(0.01) is sampler
    assert sampler.sample_once() == 0
    tdev.stop_hbm_sampler()
    assert not sampler.running and tdev.snapshot()["hbm"] == {}
    assert all(t.name != "devperf-hbm" for t in threading.enumerate())


def test_sample_records_the_worst_high_water_fraction():
    store = ttsdb.install()
    stats = [("cuda:0", {"bytes_in_use": 10.0, "peak_bytes_in_use": 30.0, "bytes_limit": 100.0}),
             ("cuda:1", {"bytes_in_use": 50.0, "peak_bytes_in_use": 80.0, "bytes_limit": 100.0})]
    sampler = tdev.HbmSampler(interval_s=60.0, stats_fn=lambda: stats)
    assert sampler.sample_once() == 2
    assert store.last("devperf.hbm_high_water_frac") == pytest.approx(0.8)


def test_mfu_collapse_fires_through_the_port_s_slo_engine(tmp_path, monkeypatch):
    """A throttled step sits far under the pack's 1e-5 floor: ok -> pending
    -> firing, with exactly one flight-recorder snapshot."""
    monkeypatch.setenv("FEDML_FR_DIR", str(tmp_path / "fr"))
    store = ttsdb.install()
    row = next(r for r in tslo.DEFAULT_PACKS["engine"] if r["name"] == "mfu_collapse")
    eng = tslo.SLOEngine([tslo.SLOSpec(**row)], store=store, front="test")
    tdev.instrument(lambda: None, "t_chaos", flops_hint=1e4, device="cpu")
    with tfr.installed(role="test"):
        for _ in range(4):
            mfu = tdev.observe_step("t_chaos", 0.05)
            assert mfu is not None and mfu < 1e-6
            eng.tick()
        assert eng.statusz()["slos"]["mfu_collapse"]["state"] == tslo.STATE_FIRING
        trans = [(t["from"], t["to"]) for t in eng.history]
        assert ("ok", "pending") in trans and ("pending", "firing") in trans
        assert len(sorted((tmp_path / "fr").glob("fr_*.jsonl"))) == 1


def test_hbm_high_water_breach_trips_the_serving_row():
    store = ttsdb.install()
    row = next(r for r in tslo.DEFAULT_PACKS["serving"] if r["name"] == "hbm_high_water")
    eng = tslo.SLOEngine([tslo.SLOSpec(**row)], store=store, front="test")
    stats = [("cuda:0", {"bytes_in_use": 97.0, "peak_bytes_in_use": 99.0, "bytes_limit": 100.0})]
    sampler = tdev.HbmSampler(interval_s=60.0, stats_fn=lambda: stats)
    for _ in range(2):
        sampler.sample_once()
        eng.tick()
    assert eng.statusz()["slos"]["hbm_high_water"]["state"] == tslo.STATE_FIRING


# --- the instrumented steps ---------------------------------------------------

MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
             seq_len=32, lora_rank=4, remat=False, attention_impl="xla")


def test_llm_train_mfu_is_its_tokens_per_sec_times_jax_s_flops(tmp_path):
    """``llm_train``: JAX's FLOPs a token for the same model, and the fold's
    MFU equal to tokens/s x FLOPs a token / peak."""
    import jax

    from fedml_tpu.train.llm import configurations as jc
    from fedml_tpu.train.llm import llm_trainer as jlt
    from fedml_tpu_torch.train.llm import configurations as tc
    from fedml_tpu_torch.train.llm import llm_trainer as tlt

    exp = dict(max_steps=2, per_device_batch_size=2, learning_rate=1e-2, warmup_steps=1)
    jtr = jlt.LLMTrainer(jc.ModelArguments(**MODEL), jc.DatasetArguments(),
                         jc.ExperimentArguments(output_dir=str(tmp_path / "jax"), **exp))
    ttr = tlt.LLMTrainer(tc.ModelArguments(**MODEL), tc.DatasetArguments(),
                         tc.ExperimentArguments(output_dir=str(tmp_path / "torch"), **exp),
                         device="cpu")
    p0 = jax.device_get(jtr.init_params())
    ttr._build(ttr.init_params(from_jax=p0))
    hint = ttr._flops_per_token_hint(ttr.model)
    assert hint == jtr._flops_per_token_hint(p0)
    metrics = ttr.train()
    rec = tdev.snapshot()["programs"]["llm_train"]
    assert rec["flops_per_token_hint"] == hint and rec["device_kind"] == "cpu"
    assert rec["steps"] == 2 and rec["tokens"] == 2 * 2 * 32 and rec["calls"] == 1
    peak = tspecs.peak_flops_per_sec("cpu", torch.bfloat16)
    assert rec["peak_flops_per_sec"] == peak
    assert rec["mfu"] == pytest.approx(metrics["tokens_per_sec"] * hint / peak, rel=1e-9)
    assert 0 < rec["mfu"] < 1


def _count_chunk_flops(cfg, n_matmul, lengths, active, C):
    total = 0
    for b in range(len(lengths)):
        if not active[b]:
            continue
        for c in range(C):
            ctx = int(lengths[b]) + c + 1
            total += 2 * n_matmul + cfg.n_layers * 4 * cfg.d_model * ctx
    return float(total)


def test_decode_flops_counts_each_token_s_context():
    from fedml_tpu_torch.models.transformer import TransformerConfig
    from fedml_tpu_torch.serving.continuous_batching import decode_flops

    cfg = TransformerConfig(vocab_size=97, d_model=48, n_layers=3, n_heads=4, n_kv_heads=2,
                            d_ff=64, max_seq_len=64)
    lengths = np.array([5, 0, 17, 30, 2])
    active = np.array([True, False, True, True, False])
    for C in (1, 4, 8):
        assert decode_flops(cfg, 12345, lengths, active, C) == \
            _count_chunk_flops(cfg, 12345, lengths, active, C)


@pytest.mark.parametrize("paged", [False, True])
def test_engines_fold_their_chunks(paged):
    """cb_step / paged_step: a fold per chunk at its token sync, with the
    chunk's analytic FLOPs; the matmul params are every weight but the
    embedding table."""
    from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from fedml_tpu_torch.serving import continuous_batching as cb

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=64, max_seq_len=64, dtype=torch.float32)
    model = TransformerLM(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    kw = dict(num_slots=2, chunk=4, device="cpu")
    eng = (cb.PagedContinuousBatchingEngine(params, cfg, page_size=8, **kw) if paged
           else cb.ContinuousBatchingEngine(params, cfg, **kw))
    label = "paged_step" if paged else "cb_step"
    try:
        n_matmul = cb.matmul_params(eng._model)
        assert n_matmul == sum(p.numel() for p in eng._model.parameters()) - 64 * 32
        folds = []
        real = tdev.observe_step

        def spy(lbl, wall_s, **kw):
            folds.append((lbl, kw))
            return real(lbl, wall_s, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cb.devperf, "observe_step", spy)
            handles = [eng.submit(p, 6) for p in ([1, 2, 3], [4, 5, 6, 7, 8])]
            for h in handles:
                assert len(h.result(timeout=60)) == 6
    finally:
        eng.shutdown()
    assert folds and all(lbl == label for lbl, _ in folds)
    rec = tdev.snapshot()["programs"][label]
    assert rec["steps"] == len(folds) and rec["device_kind"] == "cpu"
    assert rec["tokens"] == sum(kw["tokens"] for _, kw in folds) > 0
    flops = sum(kw["flops"] for _, kw in folds)
    assert rec["flops_source"] == tdev.FLOPS_SOURCE_ANALYTIC
    assert rec["achieved_flops_per_sec"] > 0 and flops > 2 * n_matmul * rec["tokens"]


def test_round_engine_runs_the_sampler_and_ticks_the_slo_engine(monkeypatch):
    """RoundEngine.run: the SLO engine activated on the engine front and
    ticked once a round, devperf's sampler started and stopped around the
    rounds, nothing left running after."""
    from fedml_tpu_torch.core.engine import round_engine as re_mod

    events = []
    real_activate = tslo.activate

    def activate(args=None, front="engine"):
        eng = real_activate(args, front=front)
        events.append(("activate", front))
        real_tick = eng.maybe_tick
        monkeypatch.setattr(eng, "maybe_tick", lambda *a: (events.append("tick"), real_tick(*a)))
        return eng

    monkeypatch.setattr(tslo, "activate", activate)
    monkeypatch.setattr(tdev, "start_hbm_sampler",
                        lambda *a: events.append("sampler_on"))
    monkeypatch.setattr(tdev, "stop_hbm_sampler", lambda: events.append("sampler_off"))

    class Strategy(re_mod.ClientExecutionStrategy):
        def run_round(self, round_idx, w_global, cohort):
            return re_mod.RoundResult(pairs=[(1.0, w_global)])

    class Sink(re_mod.AggregationSink):
        def fold(self, round_idx, w_global, result):
            return w_global

    args = type("A", (), dict(comm_round=3, frequency_of_the_test=100))()
    engine = re_mod.RoundEngine(args, Strategy(), Sink(), sample_fn=lambda r: [0],
                                install_fn=lambda w: None, eval_fn=lambda r: None)
    engine.run({"w": torch.zeros(2)})
    assert events == [("activate", "engine"), "sampler_on", "tick", "tick", "tick",
                      "sampler_off"]
    assert tslo.get_engine() is None


def test_flight_recorded_installs_the_recorder_for_its_scope(tmp_path, monkeypatch):
    from fedml_tpu_torch.core.engine import flight_recorded

    monkeypatch.setenv("FEDML_FR_DIR", str(tmp_path))
    assert tfr.active() is None
    with pytest.raises(RuntimeError, match="boom"):
        with flight_recorded(role="t_role") as rec:
            assert tfr.active() is rec and rec.role == "t_role"
            raise RuntimeError("boom")
    assert tfr.active() is None
    assert len(list(tmp_path.glob("fr_*.jsonl"))) == 1
