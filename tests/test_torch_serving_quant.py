"""Weight-only int8 decode in the port against the JAX package, on the CPU.

The same float weights (JAX's init of a tiny llama, carried across by
``models/convert.py``) go through both packages' ``quantize_params_int8``;
the port's int8 model runs the int8 GEMM's plain version here (the CUDA
kernel is held to it on the card: tests/test_torch_cuda.py, chip_smoke.py
phase 21). Tolerances:

- ``kernel_q`` and ``kernel_scale``: bit-equal (the same f32 division and
  round half to even on both sides);
- the round trip: within ``absmax/127 * 0.51`` per entry, as
  tests/test_serving_quant.py holds JAX's;
- logits of the f32 int8 model: within rtol 1e-5 of JAX's int8 logits
  (int8 times f32 products are exact on both sides; only the order of the
  f32 sums differs);
- greedy tokens and texts: equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import transformer as jt
from fedml_tpu.serving import quant as jq
from fedml_tpu.serving.fedml_predictor import LLMPredictor as JPredictor
from fedml_tpu.train.llm import checkpoint_import as jci
from fedml_tpu.train.llm import generation as jg
from fedml_tpu.train.llm import tokenizer as jtok
from fedml_tpu_torch.models import transformer as tt
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference
from fedml_tpu_torch.serving import LLMPredictor
from fedml_tpu_torch.serving import quant as tq
from fedml_tpu_torch.train.llm import checkpoint_import as tci
from fedml_tpu_torch.train.llm import generation as tg

GEOM = dict(vocab_size=300, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            max_seq_len=32, remat=False)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **GEOM)
TCFG = tt.TransformerConfig(dtype=torch.float32, **GEOM)
LOGITS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jt.TransformerLM(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _port_int8(jparams):
    return tq.quantize_params_int8(params_from_jax(jparams))


def test_quantized_layout_is_bit_equal_to_jax(jparams):
    want = _leaves(jax.device_get(jq.quantize_params_int8(jparams)))
    state = _port_int8(jparams)
    assert not any(k.endswith(".weight") for k in state)
    assert state["lm_head.kernel_q"].shape == (GEOM["vocab_size"], GEOM["d_model"])  # [out, in]
    got = _leaves(params_to_jax(state))
    assert got.keys() == want.keys()
    for path, v in want.items():
        g = got[path]
        assert g.dtype == np.asarray(v).dtype and np.array_equal(g, np.asarray(v)), path
    assert any(p[-1] == "kernel_q" and p[0] == "lm_head" for p in got)


def test_round_trip_within_half_a_step(jparams):
    state = params_from_jax(jparams)
    deq = tq.dequantize_params_int8(tq.quantize_params_int8(state))
    n = 0
    for name, w in state.items():
        if name.endswith(".weight"):
            absmax = w.abs().amax(dim=1)
            tol = absmax / 127.0 * 0.51 + 1e-8
            assert ((deq[name] - w).abs() <= tol[:, None]).all(), name
            n += 1
        else:
            assert torch.equal(deq[name], w), name
    assert n == 7 * GEOM["n_layers"] + 1  # q, k, v, o, gate, up, down a layer, and lm_head


def test_a_tree_with_nothing_to_quantize_is_refused():
    with pytest.raises(ValueError, match="no 2D 'kernel' leaf"):
        tq.quantize_params_int8({"embed.embedding": torch.zeros(4, 4, 1)})
    with pytest.raises(ValueError, match="no 2D 'kernel' leaf"):
        jq.quantize_params_int8({"embed": {"embedding": jnp.zeros((4, 4, 1))}})
    with pytest.raises(TypeError, match="params_from_jax"):
        tq.quantize_params_int8({"lm_head": {"kernel": torch.zeros(4, 4)}})


def test_quantize_model_sets_the_flag_with_the_layout(jparams):
    model = tg.decode_model(TCFG, jparams, device="cpu")
    cfg, state = tq.quantize_model_int8(TCFG, model)
    assert cfg.weight_quant == "int8" and TCFG.weight_quant == "none"
    assert state["layer_0.attn.q_proj.kernel_q"].dtype == torch.int8
    assert state["layer_0.attn.q_proj.kernel_scale"].dtype == torch.float32


def test_int8_logits_match_jax(jparams):
    toks = np.random.default_rng(1).integers(0, GEOM["vocab_size"], (4, 16)).astype(np.int32)
    jqcfg = dataclasses.replace(JCFG, weight_quant="int8")
    want = np.asarray(jt.TransformerLM(jqcfg).apply(
        {"params": jq.quantize_params_int8(jparams)}, jnp.asarray(toks)))
    model = tt.TransformerLM(dataclasses.replace(TCFG, weight_quant="int8"))
    model.load_state_dict(_port_int8(jparams))
    model.requires_grad_(False)
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGITS_RTOL, atol=LOGITS_RTOL * np.abs(want).max())


def test_int8_greedy_tokens_equal_jax(jparams):
    jqcfg = dataclasses.replace(JCFG, weight_quant="int8")
    tqcfg = dataclasses.replace(TCFG, weight_quant="int8")
    prompts = np.random.default_rng(2).integers(0, GEOM["vocab_size"], (2, 6)).astype(np.int32)
    want = np.asarray(jg.generate(jq.quantize_params_int8(jparams), jqcfg,
                                  jnp.asarray(prompts), 10))
    model = tg.decode_model(tqcfg, _port_int8(jparams), device="cpu")
    assert model.layer_0.attn.q_proj.kernel_q.dtype == torch.int8
    assert model.layer_0.attn.q_proj.kernel_scale.dtype == torch.float32
    got = tg.generate(model, tqcfg, prompts, 10, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_from_checkpoint_int8_serves_as_jax_does(jparams, tmp_path, monkeypatch):
    """An HF checkpoint (JAX's export) served with quantize="int8" by both
    packages, f32 compute on both sides: the same texts."""
    model_dir = str(tmp_path / "hf")
    jci.export_hf_checkpoint(jparams, JCFG, model_dir)
    corpus = ["federated silos serve int8 weights", "the quick brown fox jumps"] * 4
    jtok.train_bpe(corpus, vocab_size=GEOM["vocab_size"]).save(
        os.path.join(model_dir, "tokenizer.json"))
    for mod, dt in ((jci, jnp.float32), (tci, torch.float32)):
        orig = mod.config_from_hf
        monkeypatch.setattr(mod, "config_from_hf",
                            lambda d, _o=orig, _dt=dt, **kw: _o(d, dtype=_dt, **kw))
    ref = JPredictor.from_checkpoint(model_dir, quantize="int8", default_max_new_tokens=8)
    got = LLMPredictor.from_checkpoint(model_dir, quantize="int8", default_max_new_tokens=8,
                                       device="cpu")
    assert got._cfg.weight_quant == "int8" == ref._cfg.weight_quant
    for prompt in ("federated silos", "the quick", "int8"):
        assert got.predict({"prompt": prompt}) == ref.predict({"prompt": prompt}), prompt


@pytest.mark.parametrize("m", [1, 8, 33])
def test_plain_int8_matmul_equals_the_dequantized_f32_product(m):
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.normal(size=(m, 48)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (40, 48)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 2e-2, 40).astype(np.float32))
    want = x.double() @ (wq.double() * scale.double()[:, None]).T
    got = int8_matmul(x, wq, scale)
    assert got.dtype == torch.float32 and got.shape == (m, 40)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(got, int8_matmul_reference(x, wq, scale))
    # leading dims pass through; bf16 in, bf16 out (one rounding of the f32 result)
    xb = x.reshape(1, m, 48).bfloat16()
    yb = int8_matmul(xb, wq, scale)
    assert yb.dtype == torch.bfloat16 and yb.shape == (1, m, 40)
    assert torch.equal(yb[0], ((xb[0].float() @ wq.float().T) * scale).bfloat16())


def test_an_int8_forward_that_needs_a_gradient_raises(jparams):
    model = tt.TransformerLM(dataclasses.replace(TCFG, weight_quant="int8"))
    model.load_state_dict(_port_int8(jparams))
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="backward"):
        model(toks)  # the embedding is trainable: x needs a gradient
    with torch.no_grad():
        assert model(toks).shape == (1, 4, GEOM["vocab_size"])
