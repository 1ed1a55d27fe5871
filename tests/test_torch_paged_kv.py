"""fedml_tpu_torch paged KV cache (allocator + paged engine) against the JAX
package and the port's own ``generate``.

The allocator is host bookkeeping copied from the JAX package: a randomised
sequence of operations gives the same page ids and stats on both sides. The
paged engine's greedy tokens equal ``generate``'s (f32, JAX params carried
over by ``models/convert.py``), through prefix sharing's suffix prefill too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import transformer as jt
from fedml_tpu.serving.continuous_batching import PagedContinuousBatchingEngine as JPaged
from fedml_tpu.serving.paged_kv import PagedKVAllocator as JAlloc
from fedml_tpu_torch.core import telemetry as tel
from fedml_tpu_torch.models import transformer as tt
from fedml_tpu_torch.serving.continuous_batching import PagedContinuousBatchingEngine
from fedml_tpu_torch.serving.paged_kv import TRASH_PAGE, PagedKVAllocator, paged_config
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
    eng = PagedContinuousBatchingEngine(model, TCFG, num_slots=2, chunk=4, device="cpu")
    yield eng
    eng.shutdown()


def _prompt(length, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(1, GEOM["vocab_size"], length)]


def _ref(model, prompt, max_new):
    return tg.generate(model, TCFG, [prompt], max_new, device="cpu")[0].tolist()


def _no_leaks(alloc):
    leaks = alloc.check_leaks()
    assert leaks["leaked"] == [] and leaks["bad_free"] == [] and leaks["accounted"], leaks


# --- allocator ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_randomised_sequence_matches_jax(seed):
    """alloc / incref / free / match_prefix / register_prefix in a random
    order: every returned page id, every stats() snapshot and the final
    leak report equal the JAX allocator's."""
    rng = np.random.default_rng(seed)
    ps = 4
    a = PagedKVAllocator(num_pages=33, page_size=ps, watermark_frac=0.05)
    j = JAlloc(num_pages=33, page_size=ps, watermark_frac=0.05)
    live = []
    for _ in range(400):
        op = int(rng.integers(0, 4))
        if op == 0 and len(live) < 8:
            toks = [int(t) for t in rng.integers(1, 50, int(rng.integers(1, 4)) * ps)]
            shared = a.match_prefix(toks)
            assert shared == j.match_prefix(toks)
            n_more = len(toks) // ps - len(shared)
            fresh = a.alloc(n_more)
            assert fresh == j.alloc(n_more)
            if fresh is None:
                a.free(shared)
                j.free(shared)
                continue
            table = list(shared) + fresh
            a.register_prefix(toks, table)
            j.register_prefix(toks, table)
            live.append(table)
        elif op == 1 and live:
            pages = live.pop(int(rng.integers(0, len(live))))
            a.free(pages)
            j.free(pages)
        elif op == 2 and live:
            pages = live[int(rng.integers(0, len(live)))]
            a.incref(pages)
            j.incref(pages)
            live.append(list(pages))
        elif op == 3:
            n = int(rng.integers(1, 4))
            extra = a.alloc(n)
            assert extra == j.alloc(n)
            if extra is not None:
                a.free(extra)
                j.free(extra)
        assert a.stats() == j.stats()
    for pages in live:
        a.free(pages)
        j.free(pages)
    assert a.check_leaks() == j.check_leaks()
    _no_leaks(a)


def test_allocator_watermark_double_free_and_dead_incref():
    a = PagedKVAllocator(num_pages=9, page_size=16, watermark_frac=0.25)
    assert a.watermark == 2
    pages = a.alloc(6)
    assert pages is not None and TRASH_PAGE not in pages and len(set(pages)) == 6
    assert a.alloc(1) is None  # 2 free == watermark: defer
    assert a.stats()["kv_alloc_deferred"] == 1
    a.free(pages)
    with pytest.raises(RuntimeError, match="double-free"):
        a.free(pages[:1])
    with pytest.raises(RuntimeError, match="dead page"):
        a.incref(pages[:1])
    _no_leaks(a)


def test_paged_config_validation():
    with pytest.raises(ValueError, match="multiple of"):
        paged_config(TCFG, page_size=7, num_pages=8)
    with pytest.raises(ValueError, match="num_pages must be >= 2"):
        paged_config(TCFG, page_size=16, num_pages=1)


# --- engine ------------------------------------------------------------------


def test_paged_engine_greedy_equals_generate_and_jax_ragged(engine, model, jparams):
    """Block-table scatter/gather decode is token-exact against the
    contiguous generate path and JAX's paged engine, across ragged prompt
    lengths on and across page boundaries."""
    prompts = [_prompt(n, i) for i, n in enumerate((3, 15, 16, 17, 31, 40))]
    got = [h.result(timeout=120) for h in [engine.submit(p, 12) for p in prompts]]
    assert got == [_ref(model, p, 12) for p in prompts]
    jeng = JPaged(jparams, JCFG, num_slots=2, chunk=4)
    try:
        want = [h.result(timeout=300) for h in [jeng.submit(p, 12) for p in prompts[:3]]]
    finally:
        jeng.shutdown()
    assert got[:3] == want
    _no_leaks(engine._alloc)


def test_prefix_sharing_is_token_exact_and_skips_the_prefix(engine, model):
    """Two prompts sharing a 32-token system prefix: the second maps the
    shared pages (one prefix hit) and its prefill runs over the suffix only,
    yet decodes exactly what generate does."""
    system = _prompt(32, 777)
    a = system + _prompt(9, 1)
    b = system + _prompt(5, 2)
    assert engine.generate(a, 10) == _ref(model, a, 10)
    hits0 = engine._alloc.stats()["kv_prefix_hits"]
    counter0 = tel.counter("serving.kv.prefix_hits").value
    assert engine.generate(b, 10) == _ref(model, b, 10)
    st = engine.stats()
    assert st["kv_prefix_hits"] == hits0 + 1
    assert tel.counter("serving.kv.prefix_hits").value == counter0 + 1
    assert st["kv_prefix_nodes"] >= 2
    prefills = [r for r in tel.snapshot()["spans"] if r["name"] == "serving.cb.prefill"]
    assert prefills[-1]["attrs"] == {"prompt_len": len(b), "shared": 32}
    _no_leaks(engine._alloc)


def test_eos_releases_pages_and_counts_waste(engine, model):
    prompt = _prompt(5, 7)
    ref = _ref(model, prompt, 16)
    eos = ref[3]
    wasted0 = tel.counter("serving.wasted_tokens").value
    assert engine.generate(prompt, 16, eos_id=eos) == ref[: ref.index(eos) + 1]
    assert tel.counter("serving.wasted_tokens").value > wasted0
    st = engine.stats()
    assert st["slots_active"] == 0 and st["kv_tokens_live"] == 0
    assert st["kv_pages_per_token"] == 0.0
    _no_leaks(engine._alloc)


def test_stale_table_rows_cannot_corrupt_reused_pages(engine, model):
    """After a request finishes its slot's table row points at the trash
    page, so the next occupant of the same pages decodes exactly."""
    outs = []
    for i in range(6):
        p = _prompt(10 + i, 50 + i)
        outs.append((p, engine.generate(p, 8)))
    for p, got in outs:
        assert got == _ref(model, p, 8)
    assert np.all(engine._tables == TRASH_PAGE)


def test_pool_exhaustion_defers_then_completes(model):
    """A pool sized for about one request still completes a burst:
    admission defers on alloc failure and resumes as decode frees pages."""
    eng = PagedContinuousBatchingEngine(model, TCFG, num_slots=2, chunk=4, num_pages=4,
                                        watermark_frac=0.0, device="cpu")
    try:
        prompts = [_prompt(17, 70 + i) for i in range(4)]
        outs = [h.result(timeout=120) for h in [eng.submit(p, 12) for p in prompts]]
        assert outs == [_ref(model, p, 12) for p in prompts]
        assert eng.stats()["kv_alloc_deferred"] >= 1
        # a request that can never fit fails alone
        with pytest.raises(RuntimeError, match="KV pages"):
            eng.generate(_prompt(60, 1), 4)
    finally:
        eng.shutdown()


def test_sampled_paged_request_depends_only_on_its_seed(engine):
    prompt = _prompt(20, 3)
    alone = engine.generate(prompt, 9, temperature=0.9, seed=5)
    busy = engine.submit(_prompt(30, 4), 20)
    assert engine.generate(prompt, 9, temperature=0.9, seed=5) == alone
    busy.result(timeout=60)


def test_engine_stats_and_gauges_have_kv_series(engine):
    engine.generate(_prompt(33, 90), 6)
    st = engine.stats()
    for k in ("kv_pages_total", "kv_pages_free", "kv_page_size", "kv_pages_in_use",
              "kv_pages_per_token", "kv_watermark_pages", "kv_prefix_nodes"):
        assert k in st, k
    names = {g[0] for g in engine.prom_gauges()}
    assert {"serving_kv_pages", "serving_kv_prefix_nodes",
            "serving_tenant_ttft_p99_seconds"} <= names


def test_admission_controller_sheds_over_budget_tenant(model):
    from fedml_tpu_torch.serving import AdmissionController, AdmissionError, TenantPolicy

    ctl = AdmissionController({"small": TenantPolicy(tokens_per_s=0.0, burst_tokens=20.0)})
    eng = PagedContinuousBatchingEngine(model, TCFG, num_slots=2, chunk=4, admission=ctl,
                                        device="cpu")
    try:
        assert len(eng.generate(_prompt(5, 1), 4, tenant="small")) == 4
        with pytest.raises(AdmissionError, match="budget"):
            eng.generate(_prompt(30, 2), 4, tenant="small")
        assert eng.generate(_prompt(5, 1), 4, tenant="big") == _ref(model, _prompt(5, 1), 4)
        assert eng.stats()["admission"]["sheds"] == 1
        assert tel.counter("serving.admission.rejected.small.budget").value >= 1
    finally:
        eng.shutdown()
