"""fedml_tpu_torch flash attention against the JAX package's Pallas kernels.

The same numpy inputs go through the JAX kernels (Pallas in interpret mode on
the CPU, as tests/test_llm.py runs them) and through the port, whose wrappers
take the plain PyTorch versions for CPU tensors. f32 throughout, at the
tolerances of tests/test_llm.py: 2e-5 forward, 5e-5 gradients. The CUDA
kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fedml_tpu.ops import flash_attention as jfa
from fedml_tpu_torch.ops import flash_attention as tfa
from fedml_tpu_torch.models.transformer import repeat_kv, xla_attention

B, T, HQ, HKV, D = 2, 64, 8, 2, 16
BLOCKS = [(16, 16), (16, 32), (32, 16)]


def _qkvg(seed=0, t=T, hq=HQ, hkv=HKV, d=D, b=B):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    g = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    return q, k, v, g


def _rows(x):
    """[B, T, H, D] numpy -> [B*H, T, D]."""
    b, t, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, d))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_q,block_k", BLOCKS)
def test_fwd_plain_matches_pallas_fwd(causal, block_q, block_k):
    """flash_fwd's plain version (O and lse) against JAX _fwd_impl."""
    q, k, v, _ = _qkvg()
    qr, kr, vr = _rows(q), _rows(k), _rows(v)
    o_j, lse_j = jfa._fwd_impl(jnp.asarray(qr), jnp.asarray(kr), jnp.asarray(vr), causal=causal,
                               block_q=block_q, block_k=block_k, Hq=HQ, Hkv=HKV, lanes=1)
    o_t, lse_t = tfa.flash_fwd(torch.from_numpy(qr), torch.from_numpy(kr), torch.from_numpy(vr),
                               causal=causal, hq=HQ, hkv=HKV)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_pallas_bwd(causal):
    """flash_bwd_dq / flash_bwd_dkv plain versions against JAX _bwd_impl on
    the same saved (o, lse)."""
    q, k, v, g = _qkvg(seed=1)
    qr, kr, vr, dor = (_rows(x) for x in (q, k, v, g))
    o_j, lse_j = jfa._fwd_impl(jnp.asarray(qr), jnp.asarray(kr), jnp.asarray(vr), causal=causal,
                               block_q=16, block_k=16, Hq=HQ, Hkv=HKV, lanes=1)
    dq_j, dk_j, dv_j = jfa._bwd_impl(jnp.asarray(qr), jnp.asarray(kr), jnp.asarray(vr),
                                     jnp.asarray(dor), o_j, lse_j, causal=causal, block_q=16,
                                     block_k=16, Hq=HQ, Hkv=HKV)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (qr, kr, vr, dor))
    o = torch.from_numpy(np.array(o_j))
    lse = torch.from_numpy(np.asarray(lse_j)[..., 0].copy())
    delta = (tdo * o).sum(-1)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, causal=causal, hq=HQ, hkv=HKV)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal=causal, hq=HQ, hkv=HKV)
    for name, got, want in (("dq", dq, dq_j), ("dk", dk, dk_j), ("dv", dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_q,block_k", BLOCKS)
def test_flash_attention_grads_match_pallas_vjp(causal, block_q, block_k):
    """The public [B, T, H, D] op, GQA 8/2: forward and dq/dk/dv through the
    autograd.Function against jax.grad through the Pallas custom VJP."""
    q, k, v, g = _qkvg(seed=2)

    def f_jax(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
        return (out * g).sum()

    want = jax.grad(f_jax, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out_j = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                block_q=block_q, block_k=block_k)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out_t = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=block_q, block_k=block_k)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=2e-5)
    (out_t * torch.from_numpy(g)).sum().backward()
    for name, got, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-5,
                                   err_msg=f"{name} causal={causal} blocks=({block_q},{block_k})")


def test_fwd_plain_bf16_matches_pallas_fwd():
    """bf16 inputs: both cast p to bf16 before P.V and return O in bf16, so
    they agree to about one bf16 ulp of |O| <= 4 (2^-7 * 4 = 0.03)."""
    q, k, v, _ = _qkvg(seed=3)
    qr, kr, vr = _rows(q), _rows(k), _rows(v)
    o_j, lse_j = jfa._fwd_impl(*(jnp.asarray(x, jnp.bfloat16) for x in (qr, kr, vr)),
                               causal=True, block_q=16, block_k=16, Hq=HQ, Hkv=HKV, lanes=1)
    o_t, lse_t = tfa.flash_fwd(*(torch.from_numpy(x).to(torch.bfloat16) for x in (qr, kr, vr)),
                               causal=True, hq=HQ, hkv=HKV)
    assert o_t.dtype == torch.bfloat16 and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j, np.float32), atol=3e-2)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], atol=1e-4)


@pytest.mark.parametrize("t", [50, 64])
def test_ragged_and_tiled_T_match_plain_attention(t):
    """Any T runs through flash_attention (no T % block fallback): GQA
    forward and grads against the port's einsum path on repeated K/V."""
    q, k, v, g = _qkvg(seed=4, t=t)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    (out * torch.from_numpy(g)).sum().backward()
    rq, rk, rv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    kr, vr = repeat_kv(rk, rv, HQ)
    ref = xla_attention(rq, kr, vr, causal=True)
    (ref * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=2e-5)
    for a, b in ((tq, rq), (tk, rk), (tv, rv)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=5e-5)


def test_plain_path_works_in_f64_for_f64_inputs():
    """f64 inputs keep f64 through the plain versions (the card tests'
    reference for the f32 kernels) and agree with the f32 path at this
    file's f32 tolerances."""
    q, k, v, g = _qkvg(seed=6)
    res = {}
    for dtype in (torch.float64, torch.float32):
        tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
        out = tfa.flash_attention(tq, tk, tv, causal=True)
        (out * torch.from_numpy(g).to(dtype)).sum().backward()
        res[dtype] = [out.detach()] + [x.grad for x in (tq, tk, tv)]
    assert all(x.dtype == torch.float64 for x in res[torch.float64])
    for i, (a, b) in enumerate(zip(res[torch.float64], res[torch.float32])):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=2e-5 if i == 0 else 5e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_dq_rounding_floor_holds_only_cancelling_rows(causal):
    """flash_bwd_dq_rounding_floor, what the card's row gate allows the bf16
    dQ kernel for the order in which it sums dP: a dQ summed in another
    order (the head dim permuted) lies within the gate on every row, and the
    floor exceeds 1e-2 of a row's size only on causal row 0, whose ds
    cancels exactly (p = 1, delta = its one dp)."""
    q, k, v, g = _qkvg(seed=7, d=64)
    qr, kr, vr, dor = (torch.from_numpy(_rows(x)).to(torch.bfloat16) for x in (q, k, v, g))
    kw = dict(causal=causal, hq=HQ, hkv=HKV)
    o, lse = tfa.flash_fwd_reference(qr, kr, vr, **kw)
    delta = (dor.float() * o.float()).sum(-1)
    ref = tfa.flash_bwd_dq_reference(qr, kr, vr, dor, lse, delta, **kw).float()
    perm = torch.from_numpy(np.random.default_rng(0).permutation(64))
    other = tfa.flash_bwd_dq_reference(*(x[..., perm] for x in (qr, kr, vr, dor)), lse, delta,
                                       **kw).float()[..., torch.argsort(perm)]
    floor = tfa.flash_bwd_dq_rounding_floor(qr, kr, vr, dor, lse, **kw)
    assert floor.shape == lse.shape and torch.isfinite(floor).all() and (floor > 0).all()
    size = ref.norm(dim=-1)
    assert ((other - ref).norm(dim=-1) <= 1e-2 * size + 1e-6 + floor).all()
    held = floor > 1e-2 * size
    want = torch.zeros_like(held)
    want[:, 0] = causal
    assert torch.equal(held, want)


def test_cpu_path_counts_no_launches():
    tfa.reset_launch_counts()
    q, k, v, g = _qkvg(seed=5)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tfa.flash_attention(tq, tk, tv).sum().backward()
    assert tfa.launch_counts == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_block_env_override(monkeypatch):
    """FEDML_FLASH_BLOCK_Q/K choose among each kernel's compiled tiles for
    callers that pass none; a choice that names no pair of a kernel (one of
    the two alone included) warns and keeps that kernel's default; explicit
    caller values win. The f32 kernels have four pairs each, the bf16 ones
    one."""
    bf16, f32 = torch.bfloat16, torch.float32
    monkeypatch.setenv("FEDML_FLASH_BLOCK_Q", "32")
    monkeypatch.setenv("FEDML_FLASH_BLOCK_K", "64")
    assert tfa.resolve_blocks("flash_bwd_dq", f32) == (32, 64)
    assert tfa.resolve_blocks("flash_fwd", f32) == (32, 64)
    assert tfa.resolve_blocks("flash_bwd_dq", f32, 64, 32) == (64, 32)
    with pytest.warns(UserWarning, match="FEDML_FLASH_BLOCK_Q"):
        assert tfa.resolve_blocks("flash_fwd", bf16) == tfa.TILES["flash_fwd"][bf16][0]
    with pytest.warns(UserWarning, match="names no flash_bwd_dq tile"):
        assert tfa.resolve_blocks("flash_bwd_dq", bf16) == tfa.TILES["flash_bwd_dq"][bf16][0]
    monkeypatch.setenv("FEDML_FLASH_BLOCK_K", "100")
    with pytest.warns(UserWarning, match="names no flash_bwd_dq tile"):
        assert tfa.resolve_blocks("flash_bwd_dq", f32) == tfa.TILES["flash_bwd_dq"][f32][0]
    monkeypatch.delenv("FEDML_FLASH_BLOCK_Q")
    monkeypatch.setenv("FEDML_FLASH_BLOCK_K", "32")
    with pytest.warns(UserWarning, match=r"\(None, 32\) names no flash_bwd_dq tile"):
        assert tfa.resolve_blocks("flash_bwd_dq", f32) == tfa.TILES["flash_bwd_dq"][f32][0]
    monkeypatch.setenv("FEDML_FLASH_BLOCK_Q", "64")
    assert tfa.resolve_blocks("flash_bwd_dq", f32) == (64, 32)
    with pytest.raises(ValueError, match="block_q=16"):
        tfa.resolve_blocks("flash_bwd_dq", f32, 16, 64)


@pytest.mark.parametrize("kernel", sorted(tfa.TILES))
def test_tile_table_defaults(kernel, monkeypatch):
    """Each kernel and dtype has its own compiled tiles, the first the
    default; in bf16 each kernel is its wgmma kernel's one pair (128-row
    tiles of the rows it owns), in f32 the SIMT kernels' four pairs."""
    monkeypatch.delenv("FEDML_FLASH_BLOCK_Q", raising=False)
    monkeypatch.delenv("FEDML_FLASH_BLOCK_K", raising=False)
    for dtype in tfa.KERNEL_DTYPES:
        pairs = tfa.TILES[kernel][dtype]
        assert pairs and len(set(pairs)) == len(pairs)
        assert tfa.resolve_blocks(kernel, dtype) == pairs[0]
        for bq, bk in pairs:
            assert tfa.resolve_blocks(kernel, dtype, bq, bk) == (bq, bk)
            with pytest.raises(ValueError, match="names no compiled"):
                tfa.resolve_blocks(kernel, dtype, bq)  # a pair or nothing
    assert tfa.TILES[kernel][torch.float32] == ((64, 64), (64, 32), (32, 64), (32, 32))
    wgmma = {"flash_fwd": ((128, 128),), "flash_bwd_dq": ((128, 128),),
             "flash_bwd_dkv": ((64, 128),)}
    assert tfa.TILES[kernel][torch.bfloat16] == wgmma[kernel]


@pytest.mark.parametrize("kernel,dtype,tiles", [
    ("flash_fwd", torch.bfloat16, (64, 64)),
    ("flash_fwd", torch.bfloat16, (None, 32)),
    ("flash_fwd", torch.bfloat16, (None, 128)),
    ("flash_bwd_dq", torch.float32, (64, None)),
    ("flash_bwd_dkv", torch.bfloat16, (64, 64)),
    ("flash_bwd_dkv", torch.float32, (128, 128)),
    ("flash_bwd_dq", torch.bfloat16, (128, 64)),
])
def test_tile_pair_without_instance_is_refused(kernel, dtype, tiles):
    """An explicit pair with no compiled instance raises, naming the pairs
    there are, and so does one value alone, even one a compiled pair has;
    nothing is silently replaced."""
    with pytest.raises(ValueError, match="names no compiled"):
        tfa.resolve_blocks(kernel, dtype, *tiles)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "mixed_dtype", "gqa", "shape",
                                  "contiguous", "grid"])
def test_kernel_input_checks(case):
    """What the CUDA kernels do not take is refused before any launch."""
    q = torch.zeros(4, 32, 64)
    k = torch.zeros(2, 32, 64)
    v = torch.zeros(2, 32, 64)
    hq, hkv = 2, 1
    if case == "head_dim":
        q, k, v = q[..., :16].contiguous(), k[..., :16].contiguous(), v[..., :16].contiguous()
    elif case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtype":
        k = k.bfloat16()
    elif case == "gqa":
        hq, hkv = 3, 2
    elif case == "shape":
        k = torch.zeros(3, 32, 64)
    elif case == "contiguous":
        q = torch.zeros(4, 64, 32).transpose(1, 2)
    elif case == "grid":
        q = k = v = torch.zeros(tfa.MAX_HEAD_ROWS + 1, 1, 64)
        hq = hkv = 1
    with pytest.raises(ValueError):
        tfa.check_kernel_inputs(q, k, v, hq=hq, hkv=hkv)
    tfa.check_kernel_inputs(torch.zeros(4, 32, 64), torch.zeros(2, 32, 64),
                            torch.zeros(2, 32, 64), hq=2, hkv=1)


def test_non_cpu_non_cuda_tensor_raises():
    """A tensor that is neither on the CPU nor on CUDA gets no plain-version
    fallback."""
    q = torch.zeros(2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_fwd(q, q, q, causal=True, hq=1, hkv=1)
