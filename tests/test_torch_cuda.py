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
# ||got_r - ref_r|| <= rtol * ||ref_r|| + 1e-6 (+ floor_r). bf16 outputs
# differ by one bf16 ulp (2^-8 relative) an element where a cast rounds the
# other way, f32 by summation order only; bf16 dQ rows are also allowed the
# f32 rounding of dP, which the tensor cores sum in another order
# (flash_bwd_dq_rounding_floor); the limits are those of chip_smoke.py
RTOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(rng, rows, t, d, dtype):
    x = rng.standard_normal((rows, t, d)).astype(np.float32)
    return torch.from_numpy(x).to("cuda", dtype)


def _close(got, ref, dtype, floor=0.0):
    d = got.shape[-1]
    err = (got.float() - ref.float()).reshape(-1, d).norm(dim=-1)
    size = ref.float().reshape(-1, d).norm(dim=-1)
    limit = RTOL[dtype] * size + 1e-6 + (floor.reshape(-1) if torch.is_tensor(floor) else floor)
    assert not (err > limit).any(), (err / limit).max().item()


def _dq_floor(q, k, v, do, lse, dtype, **kw):
    """The bf16 dQ kernel's allowance for the order of its f32 dP sums."""
    if dtype != torch.bfloat16:
        return 0.0
    return fa.flash_bwd_dq_rounding_floor(q, k, v, do, lse, **kw)


def _check_kernels(b, t, hq, hkv, d, causal, dtype, tiles=None):
    """Each kernel against its plain version; ``tiles`` maps a kernel's name
    to its (block_q, block_k), the kernel's default where absent."""
    rng = np.random.default_rng(t + d)
    q, k, v, do = (_rows(rng, b * h, t, d, dtype) for h in (hq, hkv, hkv, hq))
    kw = dict(causal=causal, hq=hq, hkv=hkv)
    blocks = {name: dict(zip(("block_q", "block_k"), (tiles or {}).get(name, (None, None))))
              for name in fa.TILES}
    o, lse = fa.flash_fwd(q, k, v, **kw, **blocks["flash_fwd"])
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, **kw)
    delta = (do.float() * o_r.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_r, delta, **kw, **blocks["flash_bwd_dq"])
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_r, delta, **kw, **blocks["flash_bwd_dkv"])
    torch.cuda.synchronize()
    _close(o, o_r, dtype)
    assert (lse - lse_r).abs().max().item() <= 1e-4
    _close(dq, fa.flash_bwd_dq_reference(q, k, v, do, lse_r, delta, **kw), dtype,
           _dq_floor(q, k, v, do, lse_r, dtype, **kw))
    dk_r, dv_r = fa.flash_bwd_dkv_reference(q, k, v, do, lse_r, delta, **kw)
    _close(dk, dk_r, dtype)
    _close(dv, dv_r, dtype)


def _instances():
    """Every compiled instance: per dtype and head dim, each kernel's tile
    pairs (ops/flash_attention.py TILES) cycled so that each runs once."""
    out = []
    for dtype in fa.KERNEL_DTYPES:
        n = max(len(pairs[dtype]) for pairs in fa.TILES.values())
        for d in fa.HEAD_DIMS:
            for i in range(n):
                tiles = {name: pairs[dtype][i % len(pairs[dtype])]
                         for name, pairs in fa.TILES.items()}
                out.append(pytest.param(dtype, d, tiles, id=f"{str(dtype)[6:]}-d{d}-{i}"))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,d,tiles", _instances())
def test_kernels_match_plain_versions(cuda, dtype, d, tiles, causal):
    """GQA 8/2 at a ragged T=200 and at T=96, below one tile: the bf16
    wgmma kernels and the f32 SIMT kernels' tiles."""
    for t in (96, 200):
        _check_kernels(2, t, 8, 2, d, causal, dtype, tiles)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_kernels_at_long_ragged_t(cuda, d, causal):
    """The bf16 kernels at the default tiles over many tiles, GQA 8/2,
    T=2000 (not a multiple of any tile)."""
    _check_kernels(1, 2000, 8, 2, d, causal, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [2000, 130, 96])
def test_bf16_dq_matches_plain_version(cuda, t, d, causal):
    """The bf16 dQ kernel (wgmma/TMA) alone against its plain version: GQA
    32/8 at B=1, a ragged T over many 128-row tiles, one q tile and a
    partial one, and T=96, below one tile."""
    rng = np.random.default_rng(t + d + causal)
    q, k, v, do = (_rows(rng, h, t, d, torch.bfloat16) for h in (32, 8, 8, 32))
    kw = dict(causal=causal, hq=32, hkv=8)
    o, lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(dq).all()
    _close(dq, fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw), torch.bfloat16,
           _dq_floor(q, k, v, do, lse, torch.bfloat16, **kw))


@pytest.mark.cuda
def test_autograd_on_cuda_matches_cpu_plain_path(cuda):
    """The public op end to end: the f32 CUDA kernels vs the CPU plain
    versions, and each wrapper counts one launch per call. The CPU side runs
    in f64: PyTorch's f32 CPU kernels on the H100's machine gave one of two
    results from process to process, up to 7e-5 apart on O, while the CUDA
    kernels' results were bitwise the same in every process."""
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((2, 96, h, 64)).astype(np.float32) for h in (4, 2, 2, 4))
    grads = {}
    fa.reset_launch_counts()
    for dev, dtype in (("cpu", torch.float64), ("cuda", torch.float32)):
        tq, tk, tv = (torch.from_numpy(x).to(dev, dtype).requires_grad_() for x in (q, k, v))
        out = fa.flash_attention(tq, tk, tv, causal=True)
        (out * torch.from_numpy(g).to(dev, dtype)).sum().backward()
        grads[dev] = [out.detach().cpu().float()] + [x.grad.cpu().float() for x in (tq, tk, tv)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5)
    assert fa.launch_counts == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.cuda
def test_nvcc_route_builds_and_matches(cuda):
    """The one build route: one nvcc per source, C ABI via ctypes; ptxas
    reports every kernel, the wgmma kernels without spills and the build
    without a performance advisory (C7515 "wgmma serialized" and the like);
    the built library gives the plain version's results."""
    libs = _build.kernels()
    report = _build.ptxas_report()
    for name in ("flash_fwd_kernel_sm90<", "flash_bwd_dq_kernel_sm90<",
                 "flash_bwd_dkv_kernel_sm90<", "flash_bwd_dq_kernel<float"):
        assert any(line.startswith(name) for line in report), name
    sm90 = [line for line in report if "_sm90<" in line]
    assert len(sm90) == 6 and all("spill stores 0 B, loads 0 B" in line for line in sm90), sm90
    assert _build.ptxas_notes() == []
    rng = np.random.default_rng(1)
    q, k, v = (_rows(rng, 2 * h, 130, 128, torch.bfloat16) for h in (4, 2, 2))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device="cuda")
    libs.fwd(q, k, v, o, lse, True, 4, 2, *fa.TILES["flash_fwd"][torch.bfloat16][0])
    torch.cuda.synchronize()
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, causal=True, hq=4, hkv=2)
    _close(o, o_r, torch.bfloat16)
    assert (lse - lse_r).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_launches_run_the_design_of_their_dtype(cuda):
    """The public op in bf16 runs all three kernels on their wgmma/TMA
    designs, as the C entry points count them by design; in f32 all three
    run the SIMT kernels. At B=1, whose [B*H, T, D] reshape is a strided
    view the op makes contiguous."""
    libs = _build.kernels()
    rng = np.random.default_rng(2)
    for dtype, want in ((torch.bfloat16, dict.fromkeys(fa.TILES, "sm90_wgmma_tma")),
                        (torch.float32, dict.fromkeys(fa.TILES, "simt_f32_fma"))):
        before = {name: libs.design_launches(name) for name in fa.TILES}
        q, k, v = (torch.from_numpy(rng.standard_normal((1, 130, h, 64)).astype(np.float32))
                   .to("cuda", dtype).requires_grad_() for h in (4, 2, 2))
        fa.flash_attention(q, k, v).float().sum().backward()
        torch.cuda.synchronize()
        for name in fa.TILES:
            after = libs.design_launches(name)
            ran = {d: n - before[name][d] for d, n in after.items() if n != before[name][d]}
            assert ran == {want[name]: 1}, (name, dtype, ran)


@pytest.mark.cuda
def test_wrappers_refuse_what_kernels_do_not_take(cuda):
    x = torch.zeros(2, 16, 96, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(x, x, x, causal=True, hq=1, hkv=1)
    y = torch.zeros(2, 16, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(y, y, y, causal=True, hq=1, hkv=1)
    z = torch.zeros(2, 16, 64, device="cuda")
    with pytest.raises(ValueError, match="names no compiled"):
        fa.flash_fwd(z, z, z, causal=True, hq=1, hkv=1, block_q=128)
    zb = z.bfloat16()
    with pytest.raises(ValueError, match="names no compiled"):
        fa.flash_fwd(zb, zb, zb, causal=True, hq=1, hkv=1, block_q=64, block_k=64)
    stats = z[..., 0].contiguous()
    with pytest.raises(ValueError, match="names no compiled"):
        fa.flash_bwd_dkv(zb, zb, zb, zb, stats, stats, causal=True, hq=1, hkv=1,
                         block_q=64, block_k=64)
    with pytest.raises(ValueError, match="names no compiled"):
        fa.flash_bwd_dq(zb, zb, zb, zb, stats, stats, causal=True, hq=1, hkv=1,
                        block_q=128, block_k=64)
    # below the wrapper, the C entry point refuses a pair it has no instance of
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.kernels().bwd_dq(zb, zb, zb, zb, stats, stats, torch.empty_like(zb), True, 1, 1,
                                128, 64)


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
