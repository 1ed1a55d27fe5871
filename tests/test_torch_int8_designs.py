"""The int8 GEMM's designs and plain version against the JAX package, on the CPU.

``int8_matmul.design_for`` states which of the kernel's four designs a call
launches (int8_gemm.cu's ``design_for`` picks the same; the card compares the
wrapper's tally with the C entry point's counters, tests/test_torch_cuda.py and
chip_smoke.py phase 21). Here:

- the rule, for every M from 1 to 1024 and both dtypes;
- ``int8_matmul_reference`` at the tile edges of both tensor-core designs (M
  around the decode limit of 8 and the prefill's token tiles of 16, 32, 64 and
  128; N 1000, not a multiple of the 64- and 128-channel tiles; K 48 and 1040,
  multiples of 16 but not of the 128-column stage) against JAX's expression
  at ``fedml_tpu/models/transformer.py:149-155``: ``lax.dot_general`` on the
  int8 ``[in, out]`` kernel with f32 accumulation, the f32 scale, then the
  one cast. Tolerance: rtol 1e-5 in f32, relative over the output as
  ``INT8_RTOL`` measures it (int8 x f32 products are exact, only the order of
  the f32 sums differs, and an element near zero after cancellation carries
  the error of its large terms), one bf16 ulp an element in bf16 (the one
  cast of an f32 sum may round the other way after another order) plus rtol
  1e-5 of the element's sum of absolute terms, the f32 summation-order
  allowance near cancellation;
- the wrapper's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.ops import int8_matmul as im

TILE_EDGE_MS = (1, 2, 7, 8, 9, 16, 63, 64, 65, 77, 130, 512, 1000)
TILE_EDGE_NK = ((1000, 48), (1000, 1040), (1000, 4096), (4096, 48), (4096, 1040), (4096, 4096))
F32_RTOL = 1e-5


def _jax_int8_linear(x, kq, kscale):
    """LoRALinear's int8 branch (fedml_tpu/models/transformer.py:149-155)."""
    y = jax.lax.dot_general(x, kq, (((x.ndim - 1,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    return (y * kscale).astype(x.dtype)


_jax_int8_linear_jit = jax.jit(_jax_int8_linear)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits); the smallest normal's below."""
    a = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_design_for_every_m_up_to_1024(dtype):
    for m in range(1, 1025):
        got = im.design_for(m, dtype)
        if dtype == torch.float32:
            want = "gemv_warp" if m <= 8 else "tiled_simt"
        else:
            want = "sm90_wgmma_tma" if m > 8 else (
                "gemv_mma" if m >= im.MMA_MIN_M else "gemv_warp")
        assert got == want, (m, got)
        assert got in _build.INT8_DESIGNS


def test_designs_are_named_in_the_enum_order():
    # int8_gemm.cu: kGemvWarp 0, kTiledSimt 1, kGemvMma 2, kSm90WgmmaTma 3
    assert _build.INT8_DESIGNS == ("gemv_warp", "tiled_simt", "gemv_mma", "sm90_wgmma_tma")
    assert set(im.design_counts) == set(_build.INT8_DESIGNS)
    # the bf16 path never picks a SIMT design past the decode rows
    assert {im.design_for(m, torch.bfloat16) for m in range(9, 4097)} == {"sm90_wgmma_tma"}


def test_design_for_refuses_what_no_design_takes():
    with pytest.raises(ValueError, match="takes x in"):
        im.design_for(4, torch.float16)
    with pytest.raises(ValueError, match="no design"):
        im.design_for(0, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", TILE_EDGE_MS)
def test_plain_version_matches_jax_at_the_tile_edges(m, dtype):
    for n, k in TILE_EDGE_NK:
        rng = np.random.default_rng(m * 7 + n + k)
        x = rng.standard_normal((m, k)).astype(np.float32)
        wq = rng.integers(-127, 128, (n, k)).astype(np.int8)
        scale = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        want = np.asarray(_jax_int8_linear_jit(jnp.asarray(x).astype(jdt), jnp.asarray(wq.T),
                                               jnp.asarray(scale)).astype(jnp.float32))
        got = im.int8_matmul_reference(torch.from_numpy(x).to(dtype), torch.from_numpy(wq),
                                       torch.from_numpy(scale))
        assert got.dtype == dtype and got.shape == (m, n)
        got = got.float().numpy()
        if dtype == torch.float32:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= F32_RTOL, (m, n, k, rel)
        else:
            # one bf16 ulp of the element, plus the f32 sums' order: an
            # element near zero after cancellation carries the error of its
            # large terms (against an exact float64 product, JAX's own
            # result is up to 1.9 ulps off there)
            terms = (np.abs(x.astype(jnp.bfloat16).astype(np.float64))
                     @ np.abs(wq.T.astype(np.float64))) * scale
            limit = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + F32_RTOL * terms
            over = np.abs(got - want) > limit
            assert not over.any(), (m, n, k, int(over.sum()))


def test_the_wrapper_counts_no_design_on_the_cpu():
    im.reset_launch_counts()
    x = torch.ones(9, 32, dtype=torch.bfloat16)
    y = im.int8_matmul(x, torch.ones(16, 32, dtype=torch.int8), torch.ones(16))
    assert y.shape == (9, 16) and y.dtype == torch.bfloat16
    assert im.launch_counts == {"int8_gemm": 0}
    assert set(im.design_counts.values()) == {0}


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    wq = torch.zeros(8, 24, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 16"):
        im.check_weights(wq, torch.ones(8))
    wq16 = torch.zeros(8, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        im.check_weights(wq16.float(), torch.ones(8))
    with pytest.raises(ValueError, match="scale must be f32"):
        im.check_weights(wq16, torch.ones(8, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        im.check_weights(torch.zeros(16, 8, dtype=torch.int8).T, torch.ones(8))
    with pytest.raises(ValueError, match="takes x in"):
        im.check_x(torch.zeros(1, 16, dtype=torch.float16), wq16)
    with pytest.raises(ValueError, match="does not match"):
        im.check_x(torch.zeros(1, 32), wq16)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        im.int8_matmul(torch.zeros(1, 16, device="meta"), wq16, torch.ones(8))
