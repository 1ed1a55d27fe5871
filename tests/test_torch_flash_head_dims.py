"""fedml_tpu_torch flash attention at the head dims and dtypes beyond 64/128
and bf16/f32, against the JAX package's Pallas kernels.

JAX's kernels take any head dim and float16; the port's kernels take every
head dim that is a multiple of 8 from 8 to 256 in bf16, float16 and f32, at
any B*Hq, by padding a tile to 64, 128 or 256 columns. On the CPU the port's
wrappers run their plain versions (which do not depend on the head dim); the
same numpy inputs go through JAX's ``flash_attention`` (Pallas in interpret
mode, as tests/test_llm.py runs it) and through the port's, forward and the
three gradients, at JAX's own test head dim 16, Phi-3-mini's 96, Gemma-2B's
256 with one KV head, and 8 and 80. The CUDA kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py phase 3).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fedml_tpu.models import transformer as jt
from fedml_tpu.models.lora import split_lora as j_split
from fedml_tpu.ops import flash_attention as jfa
from fedml_tpu.parallel.fsdp import causal_lm_loss as j_loss
from fedml_tpu_torch.models import transformer as tt
from fedml_tpu_torch.models.convert import params_from_jax
from fedml_tpu_torch.ops import flash_attention as tfa
from fedml_tpu_torch.parallel.fsdp import causal_lm_loss
from fedml_tpu_torch.train.llm.llm_trainer import is_lora_name

B, T, HQ = 2, 64, 8
BLOCK_Q, BLOCK_K = 16, 32
HEAD_DIMS = (8, 16, 80, 96, 256)
GROUPS = {"gqa_8_2": 2, "mqa_8_1": 1}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkvg(d: int, hkv: int, seed: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, HQ, d)).astype(np.float32)
    k = rng.standard_normal((B, T, hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, T, hkv, d)).astype(np.float32)
    g = rng.standard_normal((B, T, HQ, d)).astype(np.float32)
    return q, k, v, g


def _both(d: int, hkv: int, causal: bool, jdtype, tdtype, seed: int):
    """(JAX's O, dq, dk, dv; the port's) as f32 numpy, from the same inputs
    in the given dtypes: JAX's flash_attention and jax.grad through its
    Pallas custom VJP, the port's flash_attention and its autograd.Function
    (on the CPU: the plain K1, K2 and K3)."""
    q, k, v, g = _qkvg(d, hkv, seed)

    def f_jax(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, block_q=BLOCK_Q, block_k=BLOCK_K)
        return (out.astype(jnp.float32) * g).sum()

    jargs = [jnp.asarray(x, jdtype) for x in (q, k, v)]
    want = [jfa.flash_attention(*jargs, causal=causal, block_q=BLOCK_Q, block_k=BLOCK_K)]
    want += list(jax.grad(f_jax, (0, 1, 2))(*jargs))
    tq, tk, tv = (torch.from_numpy(x).to(tdtype).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=BLOCK_Q, block_k=BLOCK_K)
    assert out.dtype == tdtype and out.shape == (B, T, HQ, d)
    (out.float() * torch.from_numpy(g)).sum().backward()
    got = [out.detach()] + [x.grad for x in (tq, tk, tv)]
    assert all(x.dtype == tdtype for x in got)
    return ([np.asarray(x, np.float32) for x in want], [x.float().numpy() for x in got])


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f32_matches_pallas_at_head_dim(d, causal, group):
    """f32 at tests/test_llm.py's tolerances: 2e-5 forward, 5e-5 gradients
    (summation order only)."""
    want, got = _both(d, GROUPS[group], causal, jnp.float32, torch.float32, seed=d + causal)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, err_msg="o")
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=5e-5, err_msg=f"{name} d={d} causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f16_matches_pallas_at_head_dim(d, causal):
    """float16, MQA 8/1: both cast p and ds to f16 before their second
    product and round each output to f16, summing in f32 in their own
    order, so an element may round the other way: each output within two
    f16 ulps of its largest element (an ulp is at most 2^-10 of a value,
    2^-11 relative precision)."""
    want, got = _both(d, 1, causal, jnp.float16, torch.float16, seed=100 + d + causal)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=2.0 ** -9 * np.abs(b).max(),
                                   err_msg=f"{name} d={d} causal={causal}")


# A tiny TransformerLM whose head dim is Phi-3-mini's (96) and one whose is
# Gemma-2B's (256, one KV head); JAX runs its Pallas kernels (interpret mode).
TINY = {
    "d96": dict(vocab_size=256, d_model=192, n_layers=2, n_heads=2, n_kv_heads=2, d_ff=128),
    "d256_mqa": dict(vocab_size=256, d_model=512, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=128),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_lora_step_matches_jax_at_head_dim(name):
    """Loss and the LoRA gradients of the whole model, JAX with
    attention_impl="pallas" against the port on the CPU (its flash path's
    plain versions), the params carried across by convert.py; f32 at the
    1e-5 of tests/test_torch_llm_trainer.py."""
    geom = dict(TINY[name], max_seq_len=32, remat=False, lora_rank=4)
    cfg = jt.TransformerConfig(dtype=jnp.float32, attention_impl="pallas", **geom)
    assert cfg.head_dim == {"d96": 96, "d256_mqa": 256}[name]
    jmodel = jt.TransformerLM(cfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.normal(0, 0.05, v.shape).astype(np.float32)
        if p[-1].key == "lora_b" else np.array(v), params)
    toks = np.random.default_rng(1).integers(0, 256, (2, 32)).astype(np.int32)

    def loss_fn(p):
        return j_loss(jmodel.apply({"params": p}, jnp.asarray(toks)), jnp.asarray(toks))

    j_l, j_g = jax.value_and_grad(loss_fn)(params)
    j_adapters, _ = j_split(jax.device_get(j_g))
    model = tt.TransformerLM(tt.TransformerConfig(dtype=torch.float32, attention_impl="pallas",
                                                  **geom))
    model.load_state_dict(params_from_jax(params))
    for n, p in model.named_parameters():
        p.requires_grad_(is_lora_name(n))
    tfa.reset_launch_counts()
    tokens = torch.from_numpy(toks)
    loss = causal_lm_loss(model(tokens), tokens)
    loss.backward()
    assert tfa.launch_counts == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert abs(loss.item() - float(j_l)) < 1e-5
    grads = params_from_jax(j_adapters)
    own = dict(model.named_parameters())
    assert grads.keys() == {n for n, p in own.items() if p.requires_grad}
    for n, g in grads.items():
        np.testing.assert_allclose(own[n].grad.numpy(), g.numpy(), atol=1e-5, err_msg=n)


@pytest.mark.parametrize("d,dtype,rows", [
    (8, torch.float32, 4), (16, torch.bfloat16, 4), (56, torch.float16, 4),
    (80, torch.bfloat16, 4), (96, torch.float16, 4), (136, torch.float32, 4),
    (256, torch.bfloat16, 4), (64, torch.float32, 65536), (64, torch.float16, 65536)])
def test_kernels_take_every_head_dim_dtype_and_head_count(d, dtype, rows):
    """What the PR's rule accepts: a head dim that is a multiple of 8 from 8
    to 256, bf16, f16 or f32, any B*Hq (65,536 passes CUDA's grid.y limit,
    which no kernel puts heads on): check_kernel_inputs takes the tensors,
    "auto" picks the kernels on CUDA, and every kernel resolves a tile pair
    of the head dim's padded width."""
    assert tfa.kernels_take(d, dtype)
    q = torch.zeros(rows, 1, d, dtype=dtype)
    tfa.check_kernel_inputs(q, q, q, hq=rows // 2, hkv=rows // 2)
    assert tt.pick_attention("auto", True, d, dtype) == "pallas"
    width = tfa.padded_width(d)
    assert width == min(w for w in (64, 128, 256) if w >= d)
    for kernel in tfa.TILES:
        assert tfa.resolve_blocks(kernel, dtype, head_dim=d) == tfa.TILES[kernel][dtype][width][0]


@pytest.mark.parametrize("d,dtype", [(100, torch.bfloat16), (264, torch.float32),
                                     (4, torch.float16), (64, torch.float64)])
def test_auto_refuses_what_no_kernel_takes(d, dtype):
    """On the card "auto" raises NotImplementedError naming ROADMAP.md for a
    head dim off the rule or another dtype (never the plain attention
    unasked); check_kernel_inputs refuses the same tensors."""
    assert not tfa.kernels_take(d, dtype)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tt.pick_attention("auto", True, d, dtype)
    q = torch.zeros(4, 8, d, dtype=dtype)
    with pytest.raises(ValueError, match="multiples of 8 from 8 to 256"):
        tfa.check_kernel_inputs(q, q, q, hq=2, hkv=2)
