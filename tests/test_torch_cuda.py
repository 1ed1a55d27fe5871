"""fedml_tpu_torch on the card: the CUDA kernels against their plain versions.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor fedml_tpu, so it runs where JAX is not installed; run it
there without tests/conftest.py (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.ops import flash_attention as fa

# kernel vs plain version, row by row (one position of one head):
# ||got_r - ref_r|| <= rtol * ||ref_r|| + 1e-6. bf16 outputs differ by one
# bf16 ulp (2^-8 relative) an element where a cast rounds the other way, f32
# by summation order only; the limits are those of chip_smoke.py
RTOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(rng, rows, t, d, dtype):
    x = rng.standard_normal((rows, t, d)).astype(np.float32)
    return torch.from_numpy(x).to("cuda", dtype)


def _close(got, ref, dtype):
    d = got.shape[-1]
    err = (got.float() - ref.float()).reshape(-1, d).norm(dim=-1)
    size = ref.float().reshape(-1, d).norm(dim=-1)
    bad = err > RTOL[dtype] * size + 1e-6
    assert not bad.any(), (err / size.clamp_min(1e-30)).max().item()


def _check_kernels(b, t, hq, hkv, d, causal, dtype, **tiles):
    rng = np.random.default_rng(t + d)
    q, k, v, do = (_rows(rng, b * h, t, d, dtype) for h in (hq, hkv, hkv, hq))
    kw = dict(causal=causal, hq=hq, hkv=hkv)
    o, lse = fa.flash_fwd(q, k, v, **kw, **tiles)
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
    delta = (do.float() * o_r.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_r, delta, **kw, **tiles)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_r, delta, **kw, **tiles)
    torch.cuda.synchronize()
    _close(o, o_r, dtype)
    assert (lse - lse_r).abs().max().item() <= 1e-4
    _close(dq, fa.flash_bwd_dq_reference(q, k, v, do, lse_r, delta, **kw), dtype)
    dk_r, dv_r = fa.flash_bwd_dkv_reference(q, k, v, do, lse_r, delta, **kw)
    _close(dk, dk_r, dtype)
    _close(dv, dv_r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tiles", [(64, 64), (32, 64), (64, 32), (32, 32)])
def test_kernels_match_plain_versions(cuda, dtype, causal, tiles):
    """GQA 8/2, ragged T, both head dims, every compiled tile pair."""
    for d in fa.HEAD_DIMS:
        _check_kernels(2, 200, 8, 2, d, causal, dtype, block_q=tiles[0], block_k=tiles[1])


@pytest.mark.cuda
def test_autograd_on_cuda_matches_cpu_plain_path(cuda):
    """The public op end to end: CUDA kernels vs the CPU plain versions, and
    each wrapper counts one launch per call."""
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((2, 96, h, 64)).astype(np.float32) for h in (4, 2, 2, 4))
    grads = {}
    fa.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        tq, tk, tv = (torch.from_numpy(x).to(dev).requires_grad_() for x in (q, k, v))
        out = fa.flash_attention(tq, tk, tv, causal=True)
        (out * torch.from_numpy(g).to(dev)).sum().backward()
        grads[dev] = [out.detach().cpu()] + [x.grad.cpu() for x in (tq, tk, tv)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5)
    assert fa.launch_counts == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.cuda
def test_nvcc_route_builds_and_matches(cuda):
    """The build route taken without ninja: one nvcc per source, C ABI via
    ctypes, same results as the plain versions."""
    libs = _build._load_ctypes()
    rng = np.random.default_rng(1)
    q, k, v = (_rows(rng, 2 * h, 130, 128, torch.bfloat16) for h in (4, 2, 2))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device="cuda")
    libs.fwd(q, k, v, o, lse, True, 4, 2, 64, 64)
    torch.cuda.synchronize()
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, causal=True, hq=4, hkv=2)
    _close(o, o_r, torch.bfloat16)
    assert (lse - lse_r).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_wrappers_refuse_what_kernels_do_not_take(cuda):
    x = torch.zeros(2, 16, 96, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(x, x, x, causal=True, hq=1, hkv=1)
    y = torch.zeros(2, 16, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(y, y, y, causal=True, hq=1, hkv=1)
    z = torch.zeros(2, 16, 64, device="cuda")
    with pytest.raises(ValueError, match="tile size"):
        fa.flash_fwd(z, z, z, causal=True, hq=1, hkv=1, block_q=128)


@pytest.mark.cuda
def test_llm_trainer_steps_on_cuda(cuda, tmp_path):
    """A small LoRA trainer on the card runs the kernels and moves only the
    adapters."""
    from fedml_tpu_torch.train.llm.configurations import (DatasetArguments,
                                                          ExperimentArguments, ModelArguments)
    from fedml_tpu_torch.train.llm.llm_trainer import LLMTrainer, is_lora_name

    ma = ModelArguments(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                        d_ff=512, seq_len=128, lora_rank=4)
    # no warmup: step 0 moves lora_b off zero, so step 1 moves lora_a too
    ea = ExperimentArguments(max_steps=2, per_device_batch_size=2, learning_rate=1e-2,
                             warmup_steps=0, output_dir=str(tmp_path))
    trainer = LLMTrainer(ma, DatasetArguments(), ea)
    trainer._build(trainer.init_params())
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    fa.reset_launch_counts()
    metrics = trainer.train()
    assert np.isfinite(metrics["final_loss"]) and metrics["steps"] == 2
    # per step and layer: forward + its remat recompute, one dQ, one dK/dV
    assert fa.launch_counts == {"flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, before[n]) != is_lora_name(n), n
