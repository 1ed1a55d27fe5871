"""fedml_tpu_torch serving front: tokenizer, predictors, admission control,
the pipeline executor and telemetry against the JAX package.

The tokenizer, admission controller, executor and telemetry registry are
copies of framework-free JAX modules: the same inputs give the same ids,
decisions and outputs. ``LLMPredictor`` (f32, JAX params carried over by
``models/convert.py``) returns JAX's text in every engine mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import transformer as jt
from fedml_tpu.serving.fedml_predictor import LLMPredictor as JPredictor
from fedml_tpu.train.llm import tokenizer as jtok
from fedml_tpu_torch.models import transformer as tt
from fedml_tpu_torch.serving import LLMPredictor, TorchPredictor
from fedml_tpu_torch.train.llm import data as tdata
from fedml_tpu_torch.train.llm import tokenizer as ttok

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "federated silos fine tune adapters and send only the adapters",
    "serving answers requests one token at a time from a key value cache",
    "naïve café ünïcode survives the byte level round trip",
]
TEXTS = CORPUS + ["unseen words: zebra quartz jinx", "  leading and  double spaces ", ""]


@pytest.fixture(scope="module")
def toks():
    return ttok.train_bpe(CORPUS * 3, vocab_size=300), jtok.train_bpe(CORPUS * 3, vocab_size=300)


def test_bpe_training_and_encoding_match_jax(toks):
    mine, ref = toks
    assert mine.vocab == ref.vocab and mine.merge_ranks == ref.merge_ranks
    assert mine.special_tokens == ref.special_tokens and mine.vocab_size == ref.vocab_size
    for text in TEXTS:
        ids = mine.encode(text)
        assert ids == ref.encode(text), text
        assert mine.decode(ids) == ref.decode(ids) == text
    assert mine.encode("hi", add_special=True) == ref.encode("hi", add_special=True)
    assert mine.decode([10 ** 6]) == ""  # unknown ids decode to ""


def test_tokenizer_json_round_trips_between_packages(toks, tmp_path):
    """A tokenizer.json saved by either package loads in the other."""
    mine, ref = toks
    ref.save(str(tmp_path / "jax.json"))
    mine.save(str(tmp_path / "port.json"))
    a = ttok.BPETokenizer.load(str(tmp_path / "jax.json"))
    b = jtok.BPETokenizer.load(str(tmp_path / "port.json"))
    for text in TEXTS:
        assert a.encode(text) == b.encode(text) == ref.encode(text)


def test_load_or_train_tokenizer(toks, tmp_path):
    from fedml_tpu.train.llm.data import load_or_train_tokenizer as j_load

    (tmp_path / "a.txt").write_text("\n".join(CORPUS) + "\n")
    (tmp_path / "b.jsonl").write_text('{"text": "json line one"}\nnot json\n{"text": "two"}\n')
    assert tdata.read_text_files(str(tmp_path)) == CORPUS + ["json line one", "two"]
    mine = tdata.load_or_train_tokenizer(str(tmp_path), None, vocab_size=280)
    ref = j_load(str(tmp_path), None, vocab_size=280)
    assert mine.vocab == ref.vocab and mine.encode(TEXTS[0]) == ref.encode(TEXTS[0])
    toks[1].save(str(tmp_path / "tok.json"))
    loaded = tdata.load_or_train_tokenizer(None, str(tmp_path / "tok.json"))
    assert loaded.encode(TEXTS[1]) == toks[1].encode(TEXTS[1])
    with pytest.raises(ValueError, match="no tokenizer_path and no corpus"):
        tdata.load_or_train_tokenizer(None, None)


# --- LLMPredictor --------------------------------------------------------------


@pytest.fixture(scope="module")
def served(toks):
    geom = dict(vocab_size=toks[0].vocab_size, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=128, max_seq_len=64, remat=False)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **geom)
    jparams = jax.device_get(jt.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    return jparams, jcfg, tt.TransformerConfig(dtype=torch.float32, **geom)


REQUESTS = [{"prompt": "the quick brown", "max_new_tokens": 8},
            {"prompt": "serving answers requests", "max_new_tokens": 8},
            {"prompt": "fox", "max_new_tokens": 5},
            {"prompt": "adapters and send", "max_new_tokens": 8}]


@pytest.mark.parametrize("mode", ["direct", "continuous", "paged"])
def test_llm_predictor_text_equals_jax(toks, served, mode):
    """predict and predict_many return JAX's text (greedy), whichever engine
    serves them; JAX's predictor runs without an engine."""
    jparams, jcfg, tcfg = served
    kw = {"continuous": mode == "continuous", "paged": mode == "paged",
          "num_slots": 2, "decode_chunk": 4}
    ref = JPredictor(jparams, jcfg, toks[1], default_max_new_tokens=8)
    pred = LLMPredictor(jparams, tcfg, toks[0], default_max_new_tokens=8, device="cpu", **kw)
    try:
        assert (pred.engine is None) == (mode == "direct")
        for r in REQUESTS:
            assert pred.predict(r) == ref.predict(r), r
        assert pred.predict_many(REQUESTS) == ref.predict_many(REQUESTS)
        assert pred.predict({"prompt": "fox"}) == ref.predict({"prompt": "fox"})
        pred.warmup()
        assert pred.ready()
    finally:
        if pred.engine is not None:
            pred.engine.shutdown()


def test_llm_predictor_sampled_requests_are_reproducible(toks, served):
    jparams, _, tcfg = served
    pred = LLMPredictor(jparams, tcfg, toks[0], default_max_new_tokens=12, device="cpu")
    r = {"prompt": "the lazy dog", "temperature": 0.9, "seed": 3}
    a = pred.predict(r)
    assert pred.predict(r) == a
    assert pred.predict_many([r, {"prompt": "fox"}])[0] == a


def test_llm_predictor_environment_seams(toks, served, monkeypatch):
    """FEDML_SERVE_* pick the engine and its sizes when the arguments do not."""
    from fedml_tpu_torch.serving import ContinuousBatchingEngine, PagedContinuousBatchingEngine

    jparams, _, tcfg = served
    monkeypatch.setenv("FEDML_SERVE_CONTINUOUS", "1")
    monkeypatch.setenv("FEDML_SERVE_SLOTS", "3")
    monkeypatch.setenv("FEDML_SERVE_CHUNK", "2")
    pred = LLMPredictor(jparams, tcfg, toks[0], device="cpu")
    assert type(pred.engine) is ContinuousBatchingEngine
    assert pred.engine.stats()["slots_total"] == 3 and pred.engine.stats()["chunk"] == 2
    pred.engine.shutdown()
    monkeypatch.setenv("FEDML_SERVE_PAGED", "1")
    monkeypatch.setenv("FEDML_SERVE_PAGE_SIZE", "8")
    monkeypatch.setenv("FEDML_SERVE_KV_PAGES", "20")
    pred = LLMPredictor(jparams, tcfg, toks[0], device="cpu")
    assert type(pred.engine) is PagedContinuousBatchingEngine
    st = pred.engine.stats()
    assert st["kv_page_size"] == 8 and st["kv_pages_total"] == 19
    out = pred.predict({"prompt": "the quick brown fox", "prefill_only": True})
    assert out == {"warmed": True, "prompt_tokens": len(toks[0].encode("the quick brown fox"))}
    pred.engine.shutdown()


def test_from_checkpoint_and_int8_raise_not_implemented(toks, served, tmp_path):
    """from_checkpoint and int8 weights are ported (tests/test_torch_llm_files.py,
    tests/test_torch_serving_quant.py): on a dir with no checkpoint both
    modes raise JAX's FileNotFoundError; an int8 config beside float
    weights is refused at load, and with the weights quantized it serves."""
    with pytest.raises(FileNotFoundError, match="config.json"):
        LLMPredictor.from_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="config.json"):
        JPredictor.from_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="config.json"):
        LLMPredictor.from_checkpoint(str(tmp_path), quantize="int8", device="cpu")
    jparams, _, tcfg = served
    with pytest.raises(RuntimeError, match="kernel_q"):
        LLMPredictor(jparams, dataclasses.replace(tcfg, weight_quant="int8"), toks[0],
                     device="cpu")
    from fedml_tpu_torch.models.convert import params_from_jax
    from fedml_tpu_torch.serving.quant import quantize_model_int8

    qcfg, qstate = quantize_model_int8(tcfg, params_from_jax(jparams))
    pred = LLMPredictor(qstate, qcfg, toks[0], default_max_new_tokens=4, device="cpu")
    assert isinstance(pred.predict({"prompt": "the quick"})["text"], str)


def test_torch_predictor_serves_like_jax_predictor():
    from fedml_tpu.serving.fedml_predictor import JaxPredictor

    w = np.random.default_rng(0).normal(size=(3, 2)).astype(np.float32)
    jp = JaxPredictor(lambda p, x: x @ p, jnp.asarray(w))
    tp = TorchPredictor(lambda p, x: x @ p, torch.from_numpy(w), device="cpu")
    assert not tp.ready()
    tp.warmup([[0.0, 0.0, 0.0]])
    assert tp.ready()
    req = {"inputs": [[1.0, 2.0, 3.0], [0.5, -1.0, 2.0]]}
    np.testing.assert_allclose(tp.predict(req)["outputs"], jp.predict(req)["outputs"],
                               rtol=1e-6)
    post = TorchPredictor(lambda p, x: x.sum(), None, postprocess=lambda y: {"sum": float(y)},
                          device="cpu")
    assert post.predict({"inputs": [1, 2]}) == {"sum": 3.0}


# --- framework-free copies ----------------------------------------------------


def test_admission_controller_decisions_match_jax():
    """A scripted sequence of submits, stamps and dequeues under a fake
    clock and an active time-series store gives the same sheds, tags,
    eligibility and stats on both sides."""
    from fedml_tpu.core.telemetry import tsdb as jtsdb
    from fedml_tpu.serving import admission as ja
    from fedml_tpu_torch.core import telemetry as ttel
    from fedml_tpu_torch.core.telemetry import tsdb as ttsdb
    from fedml_tpu_torch.serving import admission as ta

    def run(mod, tsdb_mod, tel_counter):
        now = [0.0]
        policies = {"a": mod.TenantPolicy(tokens_per_s=10.0, burst_tokens=50.0),
                    "b": mod.TenantPolicy()}
        ctl = mod.AdmissionController(policies, clock=lambda: now[0], burn_ttl_s=0.0,
                                      ttft_target_s=1.0)
        store = tsdb_mod.TimeSeriesStore()
        tsdb_mod._ACTIVE = store
        out = []
        try:
            for step in range(60):
                now[0] = step * 0.5
                if step == 30:  # the TTFT p99 crosses the defer/shed burns
                    for _ in range(20):
                        store.record_observation("serving.cb.ttft_seconds", 0.95)
                tenant = "a" if step % 3 else "b"
                cost = (40 if tenant == "b" else 8) + step % 7
                reason = ctl.check(tenant, cost)
                tag = ctl.stamp(tenant, cost) if reason is None else None
                if tag is not None and step % 2:
                    ctl.on_dequeue(tag)
                out.append((reason, tag, ctl.eligible("a"), ctl.eligible("b")))
            out.append(ctl.stats())
            out.append(tel_counter("serving.admission.rejected.a.budget").value)
        finally:
            tsdb_mod._ACTIVE = None
        return out

    from fedml_tpu.core import telemetry as jtel

    j = run(ja, jtsdb, jtel.counter)
    jtel.counter("serving.admission.rejected.a.budget")  # same registry reads below
    t = run(ta, ttsdb, ttel.counter)
    assert t[:-1] == j[:-1]
    assert any(r[0] == "budget" for r in t[:-2]) and any(r[0] == "slo_pressure" for r in t[:-2])
    assert t[-1] >= 1


def test_pipelined_executor_matches_jax():
    from fedml_tpu.core.pipeline import executor as je
    from fedml_tpu_torch.core.pipeline import executor as te

    def stages(mod):
        return [mod.StageSpec("double", lambda x: 2 * x), mod.StageSpec("inc", lambda x: x + 1)]

    items = list(range(20))
    want = je.PipelinedExecutor(stages(je)).run(items)
    got = te.PipelinedExecutor(stages(te)).run(items)
    assert got.outputs == want.outputs == [2 * i + 1 for i in items]
    assert [s.items for s in got.stages] == [20, 20]

    def bad(x):
        if x == 3:
            raise KeyError("item 3")
        return x

    with pytest.raises(te.PipelineError, match="'boom'") as err:
        te.PipelinedExecutor([te.StageSpec("boom", bad)]).run(items)
    assert isinstance(err.value.cause, KeyError)


def test_telemetry_copy_counts_and_times_like_jax():
    from fedml_tpu.core.telemetry import core as jcore
    from fedml_tpu_torch.core.telemetry import core as tcore

    def run(mod):
        reg = mod.Telemetry(enabled=True)
        reg.counter("c").add(3)
        reg.counter("c").add(4)
        for v in (0.002, 0.2, 7.0):
            reg.histogram("h").observe(v)
        with reg.timed("t", a=1) as sp:
            pass
        with reg.span("outer"):
            with reg.span("inner"):
                pass
        snap = reg.snapshot()
        return (snap["counters"], snap["histograms"], reg.histogram("h").cumulative_buckets(),
                [(s["name"], s["depth"], s.get("attrs")) for s in snap["spans"]],
                sp.duration_s is not None)

    assert run(tcore) == run(jcore)
