"""fedml_tpu_torch continuous batching (the slot engine) against the JAX
package and the port's own ``generate``.

f32 on both sides, JAX params carried over by ``models/convert.py``: the
engine's greedy tokens equal the port's ``generate`` and JAX's engine.
Sampled tokens come from one generator per slot seeded from the request's
seed, so they depend neither on the slot nor on the neighbours.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import transformer as jt
from fedml_tpu.serving.continuous_batching import ContinuousBatchingEngine as JEngine
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.models import transformer as tt
from fedml_tpu_torch.serving import continuous_batching as cb
from fedml_tpu_torch.serving.continuous_batching import ContinuousBatchingEngine
from fedml_tpu_torch.train.llm import generation as tg

GEOM = dict(vocab_size=89, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            max_seq_len=64, remat=False)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **GEOM)
TCFG = tt.TransformerConfig(dtype=torch.float32, **GEOM)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jt.TransformerLM(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])


@pytest.fixture(scope="module")
def model(jparams):
    return tg.decode_model(TCFG, jparams, device="cpu")


@pytest.fixture()
def engine(model):
    eng = ContinuousBatchingEngine(model, TCFG, num_slots=2, chunk=4, device="cpu")
    yield eng
    eng.shutdown()


def _prompt(length, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(1, GEOM["vocab_size"], length)]


def _ref(model, prompt, max_new):
    return tg.generate(model, TCFG, [prompt], max_new, device="cpu")[0].tolist()


def test_engine_greedy_equals_generate_and_jax_engine(engine, model, jparams):
    """The keystone: 4 requests interleaved across 2 slots (per-row
    cache_idx decode) emit exactly the port's generate tokens and the JAX
    engine's."""
    prompts = [_prompt(n, i) for i, n in enumerate((5, 9, 3, 17))]
    handles = [engine.submit(p, 12) for p in prompts]
    got = [h.result(timeout=120) for h in handles]
    jeng = JEngine(jparams, JCFG, num_slots=2, chunk=4)
    try:
        want = [h.result(timeout=300) for h in [jeng.submit(p, 12) for p in prompts]]
    finally:
        jeng.shutdown()
    assert got == want
    assert got == [_ref(model, p, 12) for p in prompts]


def test_engine_join_leave_more_requests_than_slots(engine, model):
    """6 requests through 2 slots: freed slots re-admit from the FIFO at
    token boundaries, every future completes with its own stream."""
    prompts = [_prompt(4 + i, 100 + i) for i in range(6)]
    handles = [engine.submit(p, 6 + i) for i, p in enumerate(prompts)]
    outs = [h.result(timeout=120) for h in handles]
    assert outs == [_ref(model, p, 6 + i) for i, p in enumerate(prompts)]
    st = engine.stats()
    assert st["requests_done"] == 6
    assert st["slots_active"] == 0 and st["queue_depth"] == 0
    assert st["tokens_out"] == sum(len(o) for o in outs)


def test_engine_eos_truncates_like_generate(engine, model):
    """Output stops AT the first EOS (inclusive); any id of a tuple stops."""
    prompt = _prompt(5, 7)
    ref = _ref(model, prompt, 16)
    eos = ref[3]
    assert engine.generate(prompt, 16, eos_id=eos) == ref[: ref.index(eos) + 1]
    got2 = engine.generate(prompt, 16, eos_id=(eos, GEOM["vocab_size"] - 1))
    assert got2[-1] in (eos, GEOM["vocab_size"] - 1)
    assert got2 == ref[: len(got2)]


def test_sampled_request_depends_only_on_its_seed(model):
    """A seeded sampled request gives the same tokens alone in slot 0 and
    beside greedy and sampled neighbours in another slot; another seed gives
    others."""
    prompt = _prompt(6, 11)
    eng = ContinuousBatchingEngine(model, TCFG, num_slots=3, chunk=4, device="cpu")
    try:
        alone = eng.generate(prompt, 10, temperature=0.8, seed=42)
        busy = [eng.submit(_prompt(9, 1), 20), eng.submit(_prompt(4, 2), 20, temperature=1.0,
                                                         seed=7)]
        again = eng.submit(prompt, 10, temperature=0.8, seed=42)
        assert again.result(timeout=60) == alone
        for h in busy:
            h.result(timeout=60)
        other = eng.generate(prompt, 10, temperature=0.8, seed=43)
    finally:
        eng.shutdown()
    assert len(other) == 10 and other != alone


def test_engine_rejects_bad_requests_fast(engine):
    with pytest.raises(ValueError, match="at least one token"):
        engine.generate([], 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.generate([1, 2], 0)
    with pytest.raises(ValueError, match="no decode room"):
        engine.generate(list(range(1, TCFG.max_seq_len + 1)), 4)
    with pytest.raises(ValueError, match="token ids"):
        engine.generate([1, GEOM["vocab_size"]], 4)


def test_engine_budget_clamped_to_cache_capacity(engine, model):
    """A near-capacity prompt's stream is clamped to the room left (S - P)."""
    prompt = _prompt(TCFG.max_seq_len - 3, 21)
    out = engine.generate(prompt, 50)
    assert out == _ref(model, prompt, 3)


def test_engine_queue_cap_and_shutdown_fail_fast(model):
    eng = ContinuousBatchingEngine(model, TCFG, num_slots=1, chunk=2, max_queue=0,
                                   device="cpu")
    h = eng.submit([1, 2, 3], 4)
    with pytest.raises(RuntimeError, match="admission queue full"):
        h.result(timeout=5)
    eng.shutdown()
    assert not eng._worker.is_alive()
    h2 = eng.submit([1, 2, 3], 4)
    with pytest.raises(RuntimeError, match="shutting down"):
        h2.result(timeout=5)


def test_worker_error_fails_every_pending_request_and_stops(model, monkeypatch):
    """A device error in the decode step reaches every pending handle —
    decoding and queued — and the engine refuses later work."""
    err = RuntimeError("CUDA error: an illegal memory access was encountered")
    eng = ContinuousBatchingEngine(model, TCFG, num_slots=1, chunk=2, device="cpu")
    try:
        gate = __import__("threading").Event()

        def broken(*a, **k):
            gate.wait(5)
            raise err

        monkeypatch.setattr(cb, "_cb_step", broken)
        hs = [eng.submit(_prompt(5, i), 8) for i in range(3)]
        gate.set()
        for h in hs:
            with pytest.raises(RuntimeError, match="illegal memory access"):
                h.result(timeout=30)
        eng._worker.join(timeout=10)
        assert not eng._worker.is_alive()
        with pytest.raises(RuntimeError, match="stopped after a worker error"):
            eng.submit([1, 2], 2).result(timeout=5)
    finally:
        eng.shutdown()


def test_latency_percentiles_and_counters(engine):
    before = tel.counter("serving.cb.admissions").value
    engine.generate(_prompt(4, 31), 6)
    pct = engine.latency_percentiles()
    assert pct["ttft_s"]["p50"] is not None and pct["ttft_s"]["p50"] > 0
    assert pct["tpot_s"]["p50"] is not None and pct["tpot_s"]["p50"] > 0
    assert tel.counter("serving.cb.admissions").value == before + 1
    assert tel.histogram("serving.cb.ttft_seconds").count >= 1


def test_engine_refuses_cuda_without_a_card(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(model, TCFG, num_slots=1)
