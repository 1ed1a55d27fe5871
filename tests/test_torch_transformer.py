"""fedml_tpu_torch transformer, LoRA plumbing and weight converter against the
JAX package.

The JAX model's init is carried into the port through
``params_from_jax``; the same numpy tokens go through both. f32 compares at
atol 1e-4 (summation order only); bf16 at the stated looser tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fedml_tpu.models import transformer as jt
from fedml_tpu.models.lora import count_lora_params as j_count
from fedml_tpu.models.lora import split_lora as j_split
from fedml_tpu_torch.models import transformer as tt
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.models.lora import count_lora_params, lora_mask, merge_lora, split_lora

GEOM = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            max_seq_len=32, remat=False, lora_rank=4)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def jax_params():
    """JAX init as numpy, with lora_b drawn non-zero so adapters contribute."""
    cfg = jt.TransformerConfig(dtype=jnp.float32, attention_impl="xla", **GEOM)
    params = jax.device_get(jt.TransformerLM(cfg).init(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(0)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.normal(0, 0.05, v.shape).astype(np.float32) if k == "lora_b"
                 else np.array(v)) for k, v in node.items()}

    return walk(params)


def _port_model(params, dtype=torch.float32, **over):
    model = tt.TransformerLM(tt.TransformerConfig(dtype=dtype, **{**GEOM, **over}))
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_logits_match_jax_f32(jax_params, impl):
    toks = np.random.default_rng(1).integers(0, 256, (2, 32)).astype(np.int32)
    cfg = jt.TransformerConfig(dtype=jnp.float32, attention_impl=impl, **GEOM)
    want = np.asarray(jt.TransformerLM(cfg).apply({"params": jax_params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = _port_model(jax_params, attention_impl=impl)(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_logits_match_jax_bf16(jax_params):
    """bf16 compute: both round activations to bf16 at the same ops but
    accumulate in their own order. Logits reach |4|, where a bf16 ulp is
    2^-6; the tolerance is five such ulps."""
    toks = np.random.default_rng(2).integers(0, 256, (2, 32)).astype(np.int32)
    cfg = jt.TransformerConfig(dtype=jnp.bfloat16, attention_impl="xla", **GEOM)
    want = np.asarray(jt.TransformerLM(cfg).apply({"params": jax_params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = _port_model(jax_params, torch.bfloat16, attention_impl="xla")(torch.from_numpy(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5 * 2.0 ** -6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary_embedding_matches_jax(dtype):
    """Interleaved-pair RoPE, f32 math, back to the input dtype."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16) + 5, (2, 16)).astype(np.int32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jt.rotary_embedding(jx, jnp.asarray(pos), 10000.0), np.float32)
    got = tt.rotary_embedding(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(pos), 10000.0)
    assert got.dtype == getattr(torch, dtype)
    # f32: cos/sin of the two libraries; bf16: one ulp of |x| < 4 after the cast
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5 if dtype == "float32" else 2 ** -6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jt.RMSNorm().apply({"params": {"scale": jnp.asarray(scale)}}, jx), np.float32)
    norm = tt.RMSNorm(64)
    norm.load_state_dict({"scale": torch.from_numpy(scale)})
    with torch.no_grad():
        got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert norm.eps == 1e-5 and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6 if dtype == "float32" else 2 ** -6)


def test_lora_linear_matches_jax():
    """x.W + (alpha/r)((x.A).B), A [in, r], B [r, out], Dense kernel transposed."""
    rng = np.random.default_rng(5)
    cfg_j = jt.TransformerConfig(dtype=jnp.float32, lora_rank=4, lora_alpha=8.0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = {"kernel": rng.standard_normal((32, 48)).astype(np.float32) * 0.2,
         "lora_a": rng.standard_normal((32, 4)).astype(np.float32) * 0.1,
         "lora_b": rng.standard_normal((4, 48)).astype(np.float32) * 0.1}
    want = np.asarray(jt.LoRALinear(48, cfg_j, name="q_proj").apply({"params": p}, jnp.asarray(x)))
    lin = tt.LoRALinear(32, 48, tt.TransformerConfig(dtype=torch.float32, lora_rank=4,
                                                     lora_alpha=8.0), "q_proj")
    lin.load_state_dict(params_from_jax(p))
    assert lin.weight.shape == (48, 32) and lin.lora_a.shape == (32, 4)
    with torch.no_grad():
        got = lin(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # no adapter where the name matches no target
    assert not tt.LoRALinear(32, 48, lin.cfg, "up_proj").has_lora


def test_causality(jax_params):
    model = _port_model(jax_params)
    t1 = torch.zeros(1, 16, dtype=torch.int32)
    t2 = t1.clone()
    t2[0, 10] = 7
    with torch.no_grad():
        l1, l2 = model(t1), model(t2)
    np.testing.assert_allclose(l1[0, :10].numpy(), l2[0, :10].numpy(), atol=1e-5)
    assert not np.allclose(l1[0, 10:].numpy(), l2[0, 10:].numpy(), atol=1e-4)


def test_remat_policies_agree(jax_params):
    """remat is a memory/compute trade, never a numerics change: loss and
    adapter grads identical across none / full / dots."""
    from fedml_tpu_torch.parallel.fsdp import causal_lm_loss

    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 16)).astype(np.int32))
    results = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        model = _port_model(jax_params, remat=remat, remat_policy=policy)
        for name, p in model.named_parameters():
            p.requires_grad_("lora_" in name)
        loss = causal_lm_loss(model(toks), toks)
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                                      if p.grad is not None}))
    for loss, grads in results[1:]:
        assert loss == results[0][0]
        assert grads.keys() == results[0][1].keys()
        for n, g in grads.items():
            assert torch.equal(g, results[0][1][n]), n


@pytest.mark.parametrize("over,exc", [
    (dict(attention_impl="ring"), NotImplementedError),
    (dict(moe_experts=4), NotImplementedError),
    # int8 weights build (serving/quant.py); the int8 GEMM's backward is not
    # ported, so a forward whose input needs a gradient raises
    (dict(weight_quant="int8"), NotImplementedError),
    (dict(decode=True, weight_quant="int8"), NotImplementedError),
    (dict(attention_impl="bogus"), ValueError),
    (dict(remat_policy="bogus"), ValueError),
])
def test_unported_config_raises(over, exc):
    with pytest.raises(exc):
        model = tt.TransformerLM(tt.TransformerConfig(**{**GEOM, **over}))
        model(torch.zeros((1, 4), dtype=torch.long))  # the embedding is trainable


def test_config_surface_matches_jax():
    """One args namespace drives both packages: same fields and defaults
    (dtype aside), same llama2_7b geometry."""
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(jt.TransformerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tt.TransformerConfig)}
    assert jf.keys() == tf.keys()
    assert {k: v for k, v in jf.items() if k != "dtype"} == {k: v for k, v in tf.items() if k != "dtype"}
    j7, t7 = jt.TransformerConfig.llama2_7b(n_layers=4), tt.TransformerConfig.llama2_7b(n_layers=4)
    for k in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff", "max_seq_len"):
        assert getattr(j7, k) == getattr(t7, k)
    assert t7.head_dim == 128


def test_converter_roundtrip_bit_exact(jax_params):
    back = params_to_jax(params_from_jax(jax_params))
    got, want = dict(_leaves(back)), dict(_leaves(jax_params))
    assert got.keys() == want.keys()
    for path, v in want.items():
        assert got[path].dtype == v.dtype and np.array_equal(got[path], v), path
    # and through a model: load, then read back
    via_model = dict(_leaves(params_to_jax(_port_model(jax_params))))
    for path, v in want.items():
        assert np.array_equal(via_model[path], v), path


def test_lora_split_matches_jax(jax_params):
    """The adapter subtree's paths are JAX split_lora's (the WAN layout)."""
    port_tree = params_to_jax(_port_model(jax_params))
    adapters, base = split_lora(port_tree)
    j_adapters, j_base = j_split(jax_params)
    assert sorted(p for p, _ in _leaves(adapters)) == sorted(p for p, _ in _leaves(j_adapters))
    assert sorted(p for p, _ in _leaves(base)) == sorted(p for p, _ in _leaves(j_base))
    assert count_lora_params(port_tree) == j_count(jax_params)
    merged = merge_lora(base, adapters)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(sorted(_leaves(merged)),
                                                              sorted(_leaves(port_tree))))
    marked = [p for p, m in _leaves(lora_mask(port_tree)) if m]
    assert marked == [p for p, _ in _leaves(adapters)]


@pytest.mark.parametrize("b,hq,d,dtype,takes", [
    (2, 32, 128, torch.bfloat16, True), (2, 4, 64, torch.float32, True),
    (2, 4, 100, torch.float32, False), (2, 4, 264, torch.bfloat16, False),
    (2, 4, 4, torch.bfloat16, False), (2, 4, 64, torch.float64, False),
    (1, 65535, 64, torch.float32, True), (2, 4, 60, torch.float16, False)])
def test_attention_dispatch_takes_the_kernels_only_where_they_take_the_shape(b, hq, d, dtype,
                                                                             takes):
    """The rule on the shape beside check_kernel_inputs: "auto" picks the
    flash kernels on CUDA exactly where check_kernel_inputs accepts the
    inputs (a head dim that is a multiple of 8 from 8 to 256, a dtype of
    bf16, f16, f32; any B*Hq) and raises NotImplementedError naming
    ROADMAP.md elsewhere (no kernel instance, and the plain attention is
    never swapped in unasked); on the CPU always the plain one; an explicit
    choice stands."""
    from fedml_tpu_torch.ops import flash_attention as fa

    assert fa.kernels_take(d, dtype) is takes
    q = torch.zeros(b * hq, 1, d, dtype=dtype)
    try:
        fa.check_kernel_inputs(q, q, q, hq=hq, hkv=hq)
        accepted = True
    except ValueError:
        accepted = False
    assert accepted is takes
    if takes:
        assert tt.pick_attention("auto", True, d, dtype) == "pallas"
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tt.pick_attention("auto", True, d, dtype)
    assert tt.pick_attention("auto", False, d, dtype) == "xla"
    assert tt.pick_attention("xla", True, d, dtype) == "xla"
    assert tt.pick_attention("pallas", False, d, dtype) == "pallas"
