"""fedml_tpu_torch KV-cache decode and generation against the JAX package.

The JAX model's init is carried into the port's decode model through
``models/convert.py``; the same numpy tokens go through both. f32 on both
sides: logits and cache leaves agree within rtol/atol 2e-4 (the JAX
package's own keystone tolerance, tests/test_generation.py), greedy tokens
are equal. Sampling cannot reproduce JAX's draws and is held by statistics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from fedml_tpu.models import transformer as jt
from fedml_tpu.train.llm import generation as jg
from fedml_tpu_torch.models import transformer as tt
from fedml_tpu_torch.train.llm import generation as tg

GEOM = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            max_seq_len=64, remat=False)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **GEOM)
TCFG = tt.TransformerConfig(dtype=torch.float32, **GEOM)
TOL = dict(rtol=2e-4, atol=2e-4)


def _jax_params(cfg=JCFG, lora_b_std=0.0):
    params = jax.device_get(jt.TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    rng = np.random.default_rng(0)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.normal(0, lora_b_std, v.shape).astype(np.float32)
                 if k == "lora_b" and lora_b_std else np.array(v)) for k, v in node.items()}

    return walk(params)


@pytest.fixture(scope="module")
def jparams():
    return _jax_params()


@pytest.fixture(scope="module")
def model(jparams):
    return tg.decode_model(TCFG, jparams, device="cpu")


def _toks(shape, seed, vocab=GEOM["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _leaves(cache):
    """(layer, leaf) -> numpy, for a JAX cache collection or the port's cache."""
    return {(layer, name): np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for layer, sub in cache.items() for name, v in sub["attn"].items()}


def _assert_caches_close(port_cache, jax_cache):
    got, want = _leaves(port_cache), _leaves(jax_cache)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], err_msg=str(key), **TOL)


def _jax_prefill_and_steps(jparams, toks, P, cfg=JCFG):
    """JAX decode: prefill toks[:, :P], then one step per later token;
    returns ([logits per call], cache after prefill, final cache)."""
    dm = jg.decode_model(cfg)
    B = toks.shape[0]
    logits, state = dm.apply({"params": jparams}, jnp.asarray(toks[:, :P]),
                             positions=jnp.broadcast_to(jnp.arange(P), (B, P)),
                             mutable=["cache"])
    out, after_prefill, cache = [np.asarray(logits)], state["cache"], state["cache"]
    for t in range(P, toks.shape[1]):
        lg, state = dm.apply({"params": jparams, "cache": cache}, jnp.asarray(toks[:, t:t + 1]),
                             positions=jnp.full((B, 1), t, jnp.int32), mutable=["cache"])
        cache = state["cache"]
        out.append(np.asarray(lg))
    return out, after_prefill, cache


def test_keystone_cached_decode_matches_jax_and_full_forward(jparams, model):
    """Per-step cached logits equal the port's full non-cached forward and
    JAX's cached decode at every position (GQA config, prefill of 4 then 6
    single-token steps); the cache leaves equal JAX's after prefill and
    after the steps."""
    toks = _toks((2, 10), 0)
    want, jax_after_prefill, jax_final = _jax_prefill_and_steps(jparams, toks, 4)
    t = torch.from_numpy(toks).long()
    with torch.inference_mode():
        full = model(t).numpy()
        cache = tt.init_cache(model.cfg, 2)
        pre = model(t[:, :4], torch.arange(4).expand(2, 4), cache=cache).numpy()
        _assert_caches_close(cache, jax_after_prefill)
        steps = [model(t[:, s:s + 1], torch.full((2, 1), s), cache=cache).numpy()
                 for s in range(4, 10)]
    got = [pre] + steps
    np.testing.assert_allclose(pre, full[:, :4], **TOL)
    for s, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"call {s}", **TOL)
    for s in range(4, 10):
        np.testing.assert_allclose(got[s - 3][:, 0], full[:, s], err_msg=f"position {s}", **TOL)
    _assert_caches_close(cache, jax_final)
    assert int(cache["layer_0"]["attn"]["idx"]) == 10


def test_decode_with_lora_adapters_matches_jax():
    """Adapters ride the decode path too (non-zero lora_b)."""
    geom = {**GEOM, "lora_rank": 4}
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **geom)
    jparams = _jax_params(jcfg, lora_b_std=0.05)
    model = tg.decode_model(tt.TransformerConfig(dtype=torch.float32, **geom), jparams,
                            device="cpu")
    prompt = _toks((2, 7), 3)
    want = np.asarray(jg.generate(jparams, jcfg, jnp.asarray(prompt), 9))
    got = tg.generate(model, model.cfg, prompt, 9, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_left_pad_attn_start_prefill_matches_jax(jparams, model):
    """Left-padded batched prefill: per-row pad prefixes masked by
    ``attn_start``; logits and cache leaves equal JAX's, then one step."""
    toks = _toks((2, 12), 1)
    start = np.asarray([0, 5], np.int32)
    toks[1, :5] = 0
    positions = np.clip(np.arange(12)[None, :] - start[:, None], 0, None)
    dm = jg.decode_model(JCFG)
    want, state = dm.apply({"params": jparams}, jnp.asarray(toks), positions=jnp.asarray(positions),
                           attn_start=jnp.asarray(start), mutable=["cache"])
    want_step, state2 = dm.apply({"params": jparams, "cache": state["cache"]},
                                 jnp.asarray([[3], [4]]), positions=jnp.asarray([[12], [7]]),
                                 attn_start=jnp.asarray(start), mutable=["cache"])
    with torch.inference_mode():
        cache = tt.init_cache(model.cfg, 2)
        st = torch.from_numpy(start).long()
        got = model(torch.from_numpy(toks).long(), torch.from_numpy(positions), st, cache=cache)
        _assert_caches_close(cache, state["cache"])
        got_step = model(torch.tensor([[3], [4]]), torch.tensor([[12], [7]]), st, cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step), **TOL)
    _assert_caches_close(cache, state2["cache"])


def test_cache_idx_slot_mode_matches_jax(jparams, model):
    """The slot engine's mode: rows at different lengths, one token each,
    written at their own index and masked to their own prefix."""
    B = 3
    rng = np.random.default_rng(2)
    k = rng.normal(size=(B, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(B, 64, 2, 16)).astype(np.float32)
    jcache = {f"layer_{i}": {"attn": {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                      "idx": jnp.asarray(0, jnp.int32)}} for i in range(2)}
    idx = np.asarray([5, 0, 63], np.int32)  # 63: the last slot (the step's clamp)
    tok = _toks((B, 1), 3)
    dm = jg.decode_model(JCFG)
    want, state = dm.apply({"params": jparams, "cache": jcache}, jnp.asarray(tok),
                           positions=jnp.asarray(idx)[:, None], cache_idx=jnp.asarray(idx),
                           mutable=["cache"])
    cache = {f"layer_{i}": {"attn": {"k": torch.tensor(k), "v": torch.tensor(v),
                                     "idx": torch.tensor(0, dtype=torch.int32)}}
             for i in range(2)}
    with torch.inference_mode():
        i_t = torch.from_numpy(idx).long()
        got = model(torch.from_numpy(tok).long(), i_t[:, None], cache_idx=i_t, cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches_close(cache, state["cache"])
    with pytest.raises(ValueError, match="T=1"):
        model(torch.zeros((B, 2), dtype=torch.long), torch.zeros((B, 2), dtype=torch.long),
              cache_idx=i_t, cache=cache)


def test_paged_mode_matches_jax(jparams, model):
    """The paged engine's mode: a page pool addressed through block tables
    (unowned entries on the trash page 0), one token per row."""
    from fedml_tpu.serving.paged_kv import paged_config as j_paged_config

    ps, n_pages, B = 8, 12, 2
    rng = np.random.default_rng(4)
    k = rng.normal(size=(n_pages, ps, 2, 16)).astype(np.float32)
    v = rng.normal(size=(n_pages, ps, 2, 16)).astype(np.float32)
    tables = np.zeros((B, 64 // ps), np.int32)
    tables[0, :3] = [4, 9, 2]
    tables[1, :2] = [7, 11]
    idx = np.asarray([19, 8], np.int32)  # row 1 writes the first slot of its 2nd page
    tok = _toks((B, 1), 5)
    jcfg = j_paged_config(JCFG, page_size=ps, num_pages=n_pages)
    jcache = {f"layer_{i}": {"attn": {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                      "idx": jnp.asarray(0, jnp.int32)}} for i in range(2)}
    want, state = jg.decode_model(jcfg).apply(
        {"params": jparams, "cache": jcache}, jnp.asarray(tok), positions=jnp.asarray(idx)[:, None],
        cache_idx=jnp.asarray(idx), block_tables=jnp.asarray(tables), mutable=["cache"])
    cache = {f"layer_{i}": {"attn": {"k": torch.tensor(k), "v": torch.tensor(v),
                                     "idx": torch.tensor(0, dtype=torch.int32)}}
             for i in range(2)}
    with torch.inference_mode():
        i_t = torch.from_numpy(idx).long()
        got = model(torch.from_numpy(tok).long(), i_t[:, None], cache_idx=i_t,
                    block_tables=torch.from_numpy(tables), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches_close(cache, state["cache"])


@pytest.mark.parametrize("B,P,max_new", [(2, 3, 8), (1, 16, 17), (3, 20, 5), (1, 30, 34)])
def test_generate_greedy_equals_jax(jparams, model, B, P, max_new):
    """Greedy tokens equal JAX's across prompt buckets (P=16 on a bucket
    edge, P=30 + 34 filling the cache to max_seq_len) and max_new buckets."""
    prompt = _toks((B, P), 10 + P)
    want = np.asarray(jg.generate(jparams, JCFG, jnp.asarray(prompt), max_new))
    got = tg.generate(model, TCFG, prompt, max_new, device="cpu")
    assert got.shape == (B, max_new) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


def test_bucketed_prefill_is_exact(model):
    """A P=13 prompt (padded to 16, index rewound) generates what a greedy
    loop of full non-cached forwards over the growing sequence picks."""
    prompt = torch.from_numpy(_toks((2, 13), 4)).long()
    out = tg.generate(model, TCFG, prompt, 6, device="cpu")
    seq = prompt
    with torch.inference_mode():
        for _ in range(6):
            nxt = model(seq)[:, -1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    assert torch.equal(out, seq[:, 13:])


def test_generate_batch_equals_jax_and_per_prompt(jparams, model):
    """Left-padded mixed-length batched generation (3 rows padded to 4) is
    token-equal to JAX's generate_batch and to per-prompt generate."""
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(0, 97, n)) for n in (3, 9, 5)]
    want = jg.generate_batch(jparams, JCFG, prompts, 6)
    got = tg.generate_batch(model, TCFG, prompts, 6, device="cpu")
    assert len(got) == 3
    for p, g, w in zip(prompts, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), tg.generate(model, TCFG, [p], 6,
                                                              device="cpu")[0].numpy())
    assert tg.generate_batch(model, TCFG, [], 4, device="cpu") == []


def test_generate_batch_boundary_drops_the_bucket_like_jax(jparams, model):
    """P=49 pads to 64 == max_seq_len with 15 new tokens: the batch path
    drops the bucket padding (an exact-length prefill) instead of writing
    past the cache, and equals JAX and per-prompt generate."""
    rng = np.random.default_rng(21)
    prompts = [list(rng.integers(0, 97, 49)), list(rng.integers(0, 97, 33))]
    want = jg.generate_batch(jparams, JCFG, prompts, 15)
    got = tg.generate_batch(model, TCFG, prompts, 15, device="cpu")
    for p, g, w in zip(prompts, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), tg.generate(model, TCFG, [p], 15,
                                                              device="cpu")[0].numpy())


def test_eos_fill_and_multi_eos_equal_jax(jparams, model):
    prompt = np.asarray([[5, 6]], np.int32)
    ref = tg.generate(model, TCFG, prompt, 16, device="cpu")[0].tolist()
    eos = ref[3]
    want = np.asarray(jg.generate(jparams, JCFG, jnp.asarray(prompt), 16, eos_id=eos))
    got = tg.generate(model, TCFG, prompt, 16, eos_id=eos, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    cut = ref.index(eos)
    assert got[0, :cut + 1].tolist() == ref[:cut + 1] and (got[0, cut:] == eos).all()
    two = (ref[0], ref[1])
    multi = tg.generate(model, TCFG, prompt, 12, eos_id=two, device="cpu").numpy()
    np.testing.assert_array_equal(
        multi, np.asarray(jg.generate(jparams, JCFG, jnp.asarray(prompt), 12, eos_id=two)))
    assert (multi[0] == two[0]).all()
    batch = tg.generate_batch(model, TCFG, [[5, 6], [1, 2, 3]], 16, eos_id=eos, device="cpu")
    jbatch = jg.generate_batch(jparams, JCFG, [[5, 6], [1, 2, 3]], 16, eos_id=eos)
    for g, w in zip(batch, jbatch):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("prompt,max_new,match", [
    (np.zeros((1, 0), np.int32), 4, "at least one token"),
    (np.zeros((1, 4), np.int32), 0, "max_new_tokens"),
    (np.zeros((1, 30), np.int32), 40, "max_seq_len"),
])
def test_generate_raises_the_jax_value_errors(jparams, model, prompt, max_new, match):
    with pytest.raises(ValueError, match=match):
        jg.generate(jparams, JCFG, jnp.asarray(prompt), max_new)
    with pytest.raises(ValueError, match=match):
        tg.generate(model, TCFG, prompt, max_new, device="cpu")


@pytest.mark.parametrize("prompts,max_new,match", [
    ([[1, 2], []], 4, "at least one token"),
    ([[1, 2]], 0, "max_new_tokens"),
    ([[1] * 60, [2]], 8, "max_seq_len"),
])
def test_generate_batch_raises_the_jax_value_errors(jparams, model, prompts, max_new, match):
    with pytest.raises(ValueError, match=match):
        jg.generate_batch(jparams, JCFG, prompts, max_new)
    with pytest.raises(ValueError, match=match):
        tg.generate_batch(model, TCFG, prompts, max_new, device="cpu")


def test_out_of_vocab_ids_are_refused_on_the_host(model):
    """An id past the embedding would read out of bounds on the card."""
    with pytest.raises(ValueError, match="token ids"):
        tg.generate(model, TCFG, [[1, 97]], 4, device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        tg.generate_batch(model, TCFG, [[1], [-1]], 4, device="cpu")


def test_sampled_generation_is_reproducible_from_its_seed(model):
    prompt = [[3, 14, 15]]
    a = tg.generate(model, TCFG, prompt, 12, temperature=1.0, seed=1, device="cpu")
    b = tg.generate(model, TCFG, prompt, 12, temperature=1.0, seed=1, device="cpu")
    c = tg.generate(model, TCFG, prompt, 12, temperature=1.0, seed=2, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((a >= 0) & (a < 97)).all()


@pytest.mark.parametrize("temperature", [0.7, 1.5])
def test_sampled_first_tokens_follow_softmax(model, temperature):
    """Chi-square of 20,000 draws from one row of logits (fixed seed)
    against softmax(logits / T): the Gumbel-max draw is a categorical draw.
    Bins with expected count < 5 are pooled."""
    with torch.inference_mode():
        logits = model(torch.tensor([[3, 14, 15]]))[0, -1]
    n = 20000
    gen = torch.Generator().manual_seed(1234)
    draws = tg._sample(logits.expand(n, -1), gen, temperature)
    counts = np.bincount(draws.numpy(), minlength=97).astype(np.float64)
    expected = torch.softmax(logits.double() / temperature, -1).numpy() * n
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    _, p = stats.chisquare(obs, exp)
    assert p > 1e-3, p
    # greedy is argmax
    assert torch.equal(tg._sample(logits[None], None, 0.0), logits.argmax(-1)[None])


def test_decode_never_runs_the_flash_kernels(jparams, monkeypatch):
    """decode_model forces the plain masked attention whatever the config
    asked for (the JAX package forces attention_impl='xla' the same way)."""
    from fedml_tpu_torch.ops import flash_attention as fa

    def boom(*a, **k):
        raise AssertionError("decode reached a flash kernel")

    monkeypatch.setattr(fa, "flash_attention", boom)
    cfg = dataclasses.replace(TCFG, attention_impl="pallas")
    model = tg.decode_model(cfg, jparams, device="cpu")
    assert model.cfg.attention_impl == "xla" and model.cfg.decode and not model.cfg.remat
    out = tg.generate(model, cfg, [[1, 2, 3]], 5, device="cpu")
    want = np.asarray(jg.generate(jparams, JCFG, jnp.asarray([[1, 2, 3]]), 5))
    np.testing.assert_array_equal(out.numpy(), want)


def test_decode_model_reuses_itself_and_loads_every_params_form(jparams, model):
    """A decode model passed back in is used as it is; the JAX nested dict,
    a port state dict and a training model all load the same weights."""
    assert tg.decode_model(TCFG, model, device="cpu") is model
    train = tt.TransformerLM(TCFG)
    train.load_state_dict(model.state_dict())
    for params in (model.state_dict(), train):
        other = tg.decode_model(TCFG, params, device="cpu")
        assert other is not model
        for (n, a), (_, b) in zip(model.state_dict().items(), other.state_dict().items()):
            assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="decode model"):
        train(torch.zeros((1, 2), dtype=torch.long), cache=tt.init_cache(model.cfg, 1))


def test_generate_text_round_trips_the_tokenizer(jparams, model):
    from fedml_tpu.train.llm.tokenizer import train_bpe as j_train_bpe
    from fedml_tpu_torch.train.llm.tokenizer import train_bpe

    corpus = ["the quick brown fox jumps over the lazy dog"] * 4
    tok, jtok = train_bpe(corpus, vocab_size=260), j_train_bpe(corpus, vocab_size=260)
    geom = {**GEOM, "vocab_size": tok.vocab_size}
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **geom)
    jp = _jax_params(jcfg)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **geom)
    want = jg.generate_text(jp, jcfg, jtok, "the quick", 8)
    assert tg.generate_text(jp, tcfg, tok, "the quick", 8, device="cpu") == want
