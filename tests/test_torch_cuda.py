"""fedml_tpu_torch on the card: the CUDA kernels against their plain versions.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor fedml_tpu, so it runs where JAX is not installed; run it
there without tests/conftest.py (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.ops import flash_attention as fa

# kernel vs plain version, row by row (one position of one head):
# ||got_r - ref_r|| <= rtol * ||ref_r|| + 1e-6 (+ floor_r). bf16 outputs
# differ by one bf16 ulp (2^-8 relative) an element where a cast rounds the
# other way, f16 by one f16 ulp (2^-11: bf16's limit times 2^-3), f32 by
# summation order only; 16-bit dQ rows are also allowed the f32 rounding of
# dP, which the tensor cores sum in another order
# (flash_bwd_dq_rounding_floor); the limits are those of chip_smoke.py
RTOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2 * 2.0 ** -3, torch.float32: 1e-5}
# a row of the gate holds at least this many elements: below d = 64,
# ceil(64 / d) consecutive positions (chip_smoke.py GATE_ROW: the limits were
# set on rows of 64 and more elements, over which the roundings average)
GATE_ROW = 64
# head dims: below a 64-column sub-tile, inside a 128-column tile, a 256-wide
# tile whose last sub-tile lies wholly past d, and each padded width
HEAD_DIMS = (8, 16, 64, 80, 96, 128, 136, 256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rows(rng, rows, t, d, dtype):
    x = rng.standard_normal((rows, t, d)).astype(np.float32)
    return torch.from_numpy(x).to("cuda", dtype)


def _gate_rows(x, d, width):
    """``width`` values a position (d, or 1 for a floor), ceil(GATE_ROW / d)
    consecutive positions a row, zero positions filling the last."""
    group = -(-GATE_ROW // d)
    flat = x.reshape(-1, width)
    pad = (-flat.shape[0]) % group
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad, width)])
    return flat.reshape(-1, group * width)


def _close(got, ref, dtype, floor=0.0):
    d = got.shape[-1]
    err = _gate_rows(got.float() - ref.float(), d, d).norm(dim=-1)
    size = _gate_rows(ref.float(), d, d).norm(dim=-1)
    if torch.is_tensor(floor):
        floor = _gate_rows(floor, d, 1).norm(dim=-1)
    limit = RTOL[dtype] * size + 1e-6 + floor
    assert not (err > limit).any(), (err / limit).max().item()


def _dq_floor(q, k, v, do, lse, dtype, **kw):
    """The 16-bit dQ kernel's allowance for the order of its f32 dP sums."""
    if dtype == torch.float32:
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
    assert fa.kernels_take(d, dtype)
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
    """Every compiled instance at every head dim of HEAD_DIMS: per dtype and
    head dim, each kernel's tile pairs at its padded width (ops/
    flash_attention.py TILES) cycled so that each runs once."""
    out = []
    for dtype in fa.KERNEL_DTYPES:
        for d in HEAD_DIMS:
            width = fa.padded_width(d)
            n = max(len(pairs[dtype][width]) for pairs in fa.TILES.values())
            for i in range(n):
                tiles = {name: pairs[dtype][width][i % len(pairs[dtype][width])]
                         for name, pairs in fa.TILES.items()}
                out.append(pytest.param(dtype, d, tiles, id=f"{str(dtype)[6:]}-d{d}-{i}"))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,d,tiles", _instances())
def test_kernels_match_plain_versions(cuda, dtype, d, tiles, causal):
    """GQA 8/2 and MQA 8/1 at a ragged T=200 and at T=96, below one tile:
    the bf16 and f16 wgmma kernels and the f32 SIMT kernels' tiles at each
    padded width."""
    for hkv in (2, 1):
        for t in (96, 200):
            _check_kernels(2, t, 8, hkv, d, causal, dtype, tiles)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", fa.KERNEL_DTYPES, ids=lambda x: str(x)[6:])
def test_kernels_take_more_head_rows_than_grid_y(cuda, dtype):
    """B*Hq = 65,536, one past CUDA's grid.y limit: every kernel of each
    dtype puts heads on grid.x (or walks them in a persistent grid)."""
    _check_kernels(4096, 24, 16, 4, 64, True, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_kernels_at_long_ragged_t(cuda, d, causal):
    """The bf16 kernels at the default tiles over many tiles, GQA 8/2,
    T=2000 (not a multiple of any tile)."""
    _check_kernels(1, 2000, 8, 2, d, causal, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,hkv,dtype", [(96, 8, torch.bfloat16), (256, 1, torch.bfloat16),
                                         (96, 8, torch.float16), (16, 2, torch.float16),
                                         (256, 1, torch.float32)], ids=str)
def test_new_instances_at_long_ragged_t(cuda, d, hkv, dtype, causal):
    """The padded instances over many tiles at T=2000: Phi-3-mini's head dim
    96, Gemma-2B's 256 over one KV head, JAX's test head dim 16 in f16, and
    the f32 SIMT kernels at width 256."""
    _check_kernels(1, 2000, 8, hkv, d, causal, dtype)


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
    # bf16 and f16 at the padded widths 64, 128 and 256, for each of the three kernels
    assert len(sm90) == 18 and all("spill stores 0 B, loads 0 B" in line for line in sm90), sm90
    assert _build.ptxas_notes() == []
    rng = np.random.default_rng(1)
    q, k, v = (_rows(rng, 2 * h, 130, 128, torch.bfloat16) for h in (4, 2, 2))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device="cuda")
    libs.fwd(q, k, v, o, lse, True, 4, 2, *fa.TILES["flash_fwd"][torch.bfloat16][128][0])
    torch.cuda.synchronize()
    o_r, lse_r = fa.flash_fwd_reference(q, k, v, causal=True, hq=4, hkv=2)
    _close(o, o_r, torch.bfloat16)
    assert (lse - lse_r).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_launches_run_the_design_of_their_dtype(cuda):
    """The public op in bf16 and f16 runs all three kernels on their
    wgmma/TMA designs, as the C entry points count them by design; in f32
    all three run the SIMT kernels. At B=1, whose [B*H, T, D] reshape is a
    strided view the op makes contiguous."""
    libs = _build.kernels()
    rng = np.random.default_rng(2)
    for dtype, want in ((torch.bfloat16, dict.fromkeys(fa.TILES, "sm90_wgmma_tma")),
                        (torch.float16, dict.fromkeys(fa.TILES, "sm90_wgmma_tma")),
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
    x = torch.zeros(2, 16, 100, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(x, x, x, causal=True, hq=1, hkv=1)
    y = torch.zeros(2, 16, 64, device="cuda", dtype=torch.float64)
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
    # below the wrapper, the C entry point refuses a pair it has no instance of,
    # and a head dim off the rule
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.kernels().bwd_dq(zb, zb, zb, zb, stats, stats, torch.empty_like(zb), True, 1, 1,
                                128, 64)
    w = torch.zeros(2, 16, 100, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.kernels().fwd(w, w, w, torch.empty_like(w), stats, True, 1, 1, 128, 128)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=str)
def test_transformer_with_head_dim_16_trains_on_cuda_through_the_kernels(cuda, dtype):
    """JAX's own test model (tests/test_llm.py: head dim 16) trains on the
    card through "auto": one forward and backward launches each kernel once
    a layer, and its logits and gradients match the same weights through
    attention_impl="xla" on the card (f32: summation order, TF32 off; f16:
    the plain path rounds its scores to f16 before the softmax, chip_smoke.py
    TINY_TOL). The loss is a sum, not a mean: a mean's activation gradients
    (about 1e-6 here) would be f16 subnormals, rounded to a few per cent."""
    import dataclasses

    from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    auto = TransformerConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                             d_ff=128, max_seq_len=32, remat=False, dtype=dtype)
    assert auto.attention_impl == "auto" and auto.head_dim == 16
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32))).to("cuda")
    torch.manual_seed(0)
    model = TransformerLM(auto).to("cuda")
    for p in model.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
    plain = TransformerLM(dataclasses.replace(auto, attention_impl="xla")).to("cuda")
    plain.load_state_dict(model.state_dict())
    outs = {}
    fa.reset_launch_counts()
    for name, m in (("auto", model), ("xla", plain)):
        logits = m(toks)
        logits.float().square().sum().backward()
        outs[name] = [logits.detach().float()] + [p.grad.float() for p in m.parameters()]
        if name == "auto":
            assert fa.launch_counts == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert fa.launch_counts == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(outs["auto"], outs["xla"]):
        assert torch.isfinite(a).all()
        assert ((a - b).norm() / b.norm().clamp_min(1e-30)).item() <= tol


# --- serving (the decode modes, the predictor) on the card ----------------------

SERVE_GEOM = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
                  max_seq_len=128, remat=False)


def _serving_pair(dtype=torch.float32):
    """The same random weights as a decode model on the CPU and on the card."""
    from fedml_tpu_torch.models.transformer import TransformerConfig
    from fedml_tpu_torch.train.llm.generation import decode_model

    cfg = TransformerConfig(dtype=dtype, **SERVE_GEOM)
    cpu = decode_model(cfg, None, device="cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    return cfg, cpu, decode_model(cfg, cpu, device="cuda")


@pytest.mark.cuda
def test_decode_modes_on_cuda_match_the_cpu(cuda):
    """Contiguous prefill + steps, the slot mode and the paged mode on the
    card against the same modules on the CPU (f32; TF32 off)."""
    from fedml_tpu_torch.models.transformer import init_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, gpu = _serving_pair()
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 24)))
    outs = {}
    with torch.inference_mode():
        for name, m, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, "cuda")):
            t = toks.to(dev)
            cache = init_cache(m.cfg, 2, dev)
            pre = m(t[:, :16], torch.arange(16, device=dev).expand(2, 16), cache=cache)
            steps = [m(t[:, s:s + 1], torch.full((2, 1), s, device=dev), cache=cache)
                     for s in range(16, 24)]
            idx = torch.tensor([23, 5], device=dev)
            slot = m(t[:, :1], idx[:, None], cache_idx=idx, cache=cache)
            pool = init_cache(dataclasses.replace(m.cfg, kv_page_size=16, kv_num_pages=6),
                              0, dev)
            tables = torch.tensor([[3, 1, 0, 0, 0, 0, 0, 0], [5, 0, 0, 0, 0, 0, 0, 0]],
                                  device=dev)
            paged = m(t[:, :1], idx[:, None], cache_idx=idx, block_tables=tables, cache=pool)
            outs[name] = [x.cpu() for x in [pre, *steps, slot, paged]]
    for a, b in zip(outs["gpu"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_llm_predictor_serves_on_cuda(cuda):
    from fedml_tpu_torch.serving import LLMPredictor
    from fedml_tpu_torch.train.llm.generation import generate
    from fedml_tpu_torch.train.llm.tokenizer import train_bpe

    tok = train_bpe(["the quick brown fox jumps over the lazy dog"] * 4, vocab_size=300)
    cfg, _, gpu = _serving_pair(torch.bfloat16)
    fa.reset_launch_counts()
    for kw in ({}, {"continuous": True, "num_slots": 2}, {"paged": True, "num_slots": 2}):
        pred = LLMPredictor(gpu, cfg, tok, default_max_new_tokens=8, **kw)
        try:
            out = pred.predict({"prompt": "the quick"})
            assert isinstance(out["text"], str)
            assert pred.predict({"prompt": "the quick"}) == out
            many = pred.predict_many([{"prompt": "the quick"}, {"prompt": "lazy dog"}])
            assert len(many) == 2
        finally:
            if pred.engine is not None:
                pred.engine.shutdown()
    assert generate(gpu, cfg, [[1, 2, 3]], 4).is_cuda
    assert fa.launch_counts == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


@pytest.mark.cuda
def test_serving_weights_are_cast_once_and_never_per_call(cuda):
    """The decode model's dense weights are bf16 on the card (norm scales
    f32), and a profiled decode step casts no weight-sized tensor."""
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.models.transformer import init_cache

    cfg, _, gpu = _serving_pair(torch.bfloat16)
    weights = {tuple(p.shape) for n, p in gpu.named_parameters() if not n.endswith("scale")}
    for n, p in gpu.named_parameters():
        assert p.is_cuda and p.dtype == (torch.float32 if n.endswith("scale") else torch.bfloat16)
    with torch.inference_mode():
        cache = init_cache(gpu.cfg, 2, "cuda")
        gpu(torch.zeros((2, 4), dtype=torch.long, device="cuda"),
            torch.arange(4, device="cuda").expand(2, 4), cache=cache)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            gpu(torch.ones((2, 1), dtype=torch.long, device="cuda"),
                torch.full((2, 1), 4, device="cuda"), cache=cache)
            torch.cuda.synchronize()
    casts = [e for e in prof.events() if e.name in ("aten::_to_copy", "aten::copy_")
             and any(tuple(s) in weights for s in e.input_shapes if s)]
    assert not casts, [(e.name, e.input_shapes) for e in casts[:5]]


def _resnet56_step(device, x, y, args):
    """One local step of a ResNet-56 client (a shard of one batch) from the
    seeded params: (params before, params after, mean loss), on the CPU."""
    from fedml_tpu_torch.data.dataset import ArrayDataset
    from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer
    from fedml_tpu_torch.models.model_hub import create

    model = create(args, 10, seed=0, device=device)
    before = {k: v.cpu() for k, v in model.params.items()}
    trainer = ClassificationTrainer(model, args)
    trainer.train(ArrayDataset(x, y))
    assert trainer.last_steps == 1
    assert all(p.device.type == torch.device(device).type for p in model.module.parameters())
    return before, {k: v.cpu() for k, v in trainer.get_model_params().items()}, trainer.last_loss


@pytest.mark.cuda
def test_resnet56_client_step_on_the_card_matches_cpu(cuda):
    """One ResNet-56 (full width) client step, batch 128, SGD with momentum
    and weight decay, on the card with cuDNN's TF32 off against the CPU:
    the loss within rtol 1e-4 and the update (one step: lr times the
    gradient plus decay) within 1e-3 relative L2 of the CPU's; the params
    stay on the card."""
    from types import SimpleNamespace

    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 128).astype(np.int64)
    args = SimpleNamespace(model="resnet56", dataset="cifar10", batch_size=128, epochs=1,
                           client_optimizer="sgd", learning_rate=0.05, momentum=0.9,
                           weight_decay=5e-4, random_seed=0)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        p0, gpu, gpu_loss = _resnet56_step("cuda", x, y, args)
    p0_cpu, cpu, cpu_loss = _resnet56_step("cpu", x, y, args)
    assert all(torch.equal(p0[k], p0_cpu[k]) for k in p0)
    assert np.isfinite(gpu_loss) and abs(gpu_loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    num = sum(((gpu[k] - cpu[k]).double() ** 2).sum() for k in cpu)
    den = sum(((cpu[k] - p0[k]).double() ** 2).sum() for k in cpu)
    assert (num / den).sqrt().item() <= 1e-3


@pytest.mark.cuda
def test_cross_silo_lr_federation_on_the_card(cuda):
    """A 2-client LR federation over INMEMORY, every party a thread on the
    card through FedMLRunner: the global params stay on cuda and the result
    is finite."""
    import threading

    import fedml_tpu_torch as fedml
    from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker

    run_id = "test_torch_cuda_cross_silo"
    InMemoryBroker.reset(run_id)
    runners, results = {}, {}
    for rank in range(3):
        args = fedml.init(fedml.default_config(
            "cross_silo", run_id=run_id, rank=rank, role="server" if rank == 0 else "client",
            backend="INMEMORY", client_num_in_total=2, client_num_per_round=2, comm_round=2,
            batch_size=16, frequency_of_the_test=1, dataset="synthetic", model="lr",
            data_cache_dir=""))
        dev = fedml.get_device(args)
        dataset, output_dim = fedml.data.load(args)
        model = fedml.model.create(args, output_dim)
        assert dev.type == "cuda" and model.device.type == "cuda"
        runners[rank] = fedml.FedMLRunner(args, dev, dataset, model)
    threads = [threading.Thread(target=lambda r=r: results.__setitem__(r, runners[r].run()),
                                daemon=True) for r in runners]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    InMemoryBroker.reset(run_id)
    metrics = results[0]
    assert metrics["round"] == 1 and np.isfinite(metrics["test_loss"])
    w = runners[0].runner.server_manager.aggregator.get_global_model_params()
    assert all(v.device.type == "cuda" and torch.isfinite(v).all() for v in w.values())


@pytest.mark.cuda
def test_ingest_moves_host_leaves_in_one_copy_per_dtype_group(cuda):
    """utils.pytree.tree_to_device: CPU leaves go up with one host-to-device
    copy per dtype group (counted), card leaves pass through untouched."""
    from fedml_tpu_torch.core import telemetry as tel
    from fedml_tpu_torch.utils.pytree import H2D_TRANSFERS, tree_to_device

    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 4, generator=gen), "b": torch.randn(5, generator=gen).bfloat16(),
            "c": torch.randn(2, 2, generator=gen), "d": torch.randn(7, generator=gen).bfloat16()}
    on_card = torch.ones(3, device="cuda")
    tree["e"] = on_card
    before = tel.get_telemetry().counter(H2D_TRANSFERS).value
    out = tree_to_device(tree, "cuda")
    assert tel.get_telemetry().counter(H2D_TRANSFERS).value - before == 2
    assert out["e"] is on_card and list(out) == list(tree)
    for k, v in tree.items():
        assert out[k].device.type == "cuda" and out[k].dtype == v.dtype
        assert torch.equal(out[k].cpu(), v.cpu())



@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 3])
@pytest.mark.parametrize("secure", ["secagg", "lightsecagg"])
def test_secure_front_round_on_the_card_equals_the_plain_quantized_mean(cuda, secure, n):
    """One round of an n-silo LR federation under ``secure_aggregation``,
    every party a thread on the card through FedMLRunner: the global, on
    cuda, bit-equal to the plain mean of the n uploads the clients
    quantized before masking (their int64 sum mod p, centred, float64 over
    2^16, float32, over n in float32: the JAX fronts' order, on the host).
    At n = 3 the division must be a true one: CUDA multiplies by the
    reciprocal of a Python scalar divisor, exact only for a power of 2."""
    import threading

    import fedml_tpu_torch as fedml
    from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker
    from fedml_tpu_torch.models.convert import wire_vector

    run_id, p = f"test_torch_cuda_{secure}_{n}", 2**31 - 1
    InMemoryBroker.reset(run_id)
    runners, uploads = {}, {}
    for rank in range(n + 1):
        args = fedml.init(fedml.default_config(
            "cross_silo", run_id=run_id, rank=rank, role="server" if rank == 0 else "client",
            backend="INMEMORY", client_num_in_total=n, client_num_per_round=n, comm_round=1,
            batch_size=16, frequency_of_the_test=1, dataset="synthetic", model="lr",
            data_cache_dir="", secure_aggregation=secure, quantize_bits=16, mpc_prime=p))
        dev = fedml.get_device(args)
        dataset, output_dim = fedml.data.load(args)
        model = fedml.model.create(args, output_dim)
        assert dev.type == "cuda" and model.device.type == "cuda"
        runners[rank] = fedml.FedMLRunner(args, dev, dataset, model)
        if rank:
            cm = runners[rank].runner.client_manager
            cm.quantize = lambda w, _q=cm.quantize, _r=rank: uploads.setdefault(_r, _q(w))
    threads = [threading.Thread(target=runners[r].run, daemon=True) for r in runners]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    InMemoryBroker.reset(run_id)
    assert sorted(uploads) == list(range(1, n + 1))
    total = np.zeros_like(uploads[1])
    for r in range(1, n + 1):
        total = (total + uploads[r]) % p
    centred = np.where(total > (p - 1) // 2, total - p, total)
    want = (centred.astype(np.float64) / 2**16).astype(np.float32) / np.float32(n)
    w = runners[0].runner.server_manager.aggregator.get_global_model_params()
    assert all(v.device.type == "cuda" for v in w.values())
    assert np.array_equal(wire_vector(w).cpu().numpy(), want)


def _hier_batch(model, client_ids, version):
    """A numpy delta pure in (client, version), on the model's device."""
    out = {}
    for name, leaf in model.items():
        base = leaf.detach().cpu().numpy()
        rows = [base + np.float32(0.01) * np.random.default_rng([7, int(c), int(version)])
                .standard_normal(base.shape).astype(np.float32) for c in client_ids]
        out[name] = torch.from_numpy(np.stack(rows)).to(leaf.device)
    return out


@pytest.mark.cuda
def test_hierarchy_tree_on_the_card_matches_its_cpu_run(cuda):
    """A 2-edge tree (exponent 0.5) under AsyncEventSim on the card and on
    the CPU: the same event trace and versions, every root publish within
    1e-6 of each leaf's scale of the CPU's (f32 folds, TF32 off), and every
    published leaf on the card."""
    from fedml_tpu_torch.core.aggregation.async_buffer import StalenessPolicy
    from fedml_tpu_torch.core.distributed.hierarchy import HierarchyTree
    from fedml_tpu_torch.simulation.vmapped.async_driver import AsyncEventSim, DelayModel

    rng = np.random.default_rng(3)
    init = {"w": rng.standard_normal((64, 32)).astype(np.float32),
            "b": rng.standard_normal(32).astype(np.float32)}
    runs = {}
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            model = {k: torch.from_numpy(v).to(dev) for k, v in init.items()}
            tree = HierarchyTree.build(2, regional_fanout=2, publish_k=4,
                                       policy=StalenessPolicy(0.5), device=dev,
                                       initial_model=model)
            pubs = []
            sim = AsyncEventSim(tree, _hier_batch, 24, initial_model=model,
                                delay=DelayModel(24, seed=2), gen_batch=8,
                                on_publish=lambda v, m, _p=pubs: _p.append((v, m)))
            stats = sim.run(3)
            runs[dev] = (stats, sim.staleness_samples, pubs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    (cs, cst, cp), (ps, pst, pp) = runs["cuda"], runs["cpu"]
    assert cst == pst and [v for v, _ in cp] == [v for v, _ in pp] == [1, 2, 3]
    for key in ("merges", "publishes", "stale_rejected", "staleness_mean"):
        assert cs[key] == ps[key], key
    for (_, got), (_, ref) in zip(cp, pp):
        for k in ref:
            assert got[k].device.type == "cuda"
            err = (got[k].cpu().double() - ref[k].double()).abs().max() / ref[k].abs().max()
            assert err.item() <= 1e-6, (k, err.item())


@pytest.mark.cuda
def test_masked_hierarchy_on_the_card_equals_the_honest_quantized_mean(cuda):
    """HierarchyPrivacy over a 2-edge tree on the card (2 members an edge):
    every tier folds masked ring vectors on the card (TF32 off), and the root
    publish is bit-equal to the honest quantized mean of the 4 deltas."""
    from fedml_tpu_torch.core.aggregation.async_buffer import StalenessPolicy
    from fedml_tpu_torch.core.distributed.hierarchy import HierarchyTree
    from fedml_tpu_torch.core.privacy import HierarchyPrivacy
    from fedml_tpu_torch.core.privacy import masking as m
    from fedml_tpu_torch.core.privacy.secagg_window import MASKED_LEAF
    from fedml_tpu_torch.models.convert import wire_vector

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        template = {"w": torch.zeros(40, 25, device="cuda"), "b": torch.zeros(25, device="cuda")}
        rng = np.random.default_rng(9)
        deltas = [rng.normal(0, 1, 1025).astype(np.float32) for _ in range(4)]
        tree = HierarchyTree.build(2, regional_fanout=2, publish_k=2,
                                   policy=StalenessPolicy(exponent=0.0), device="cuda")
        hp = HierarchyPrivacy(tree, template, rng=np.random.default_rng(1))
        ups = []
        orig = tree.regionals[0]._submit_from_child
        tree.regionals[0]._submit_from_child = \
            lambda c, w, mdl: (ups.append(mdl[MASKED_LEAF].device), orig(c, w, mdl))[1]
        opened = hp.open_edge_windows({"edge-0": [0, 1], "edge-1": [2, 3]})
        for e in tree.edges:
            members = opened[e.name][1]
            for r in members:
                assert e.privacy.submit(r, members[r].mask(deltas[r]),
                                        client_version=e.buffer.version) == "accept"
            e._maybe_publish()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    out = tree.latest_model()
    assert tree.version == 1 and len(hp.ledger) == 0
    assert [d.type for d in ups] == ["cuda", "cuda"]
    assert all(v.device.type == "cuda" for v in out.values())
    q = sum(m.quantize_vector(d, hp.spec) for d in deltas)
    honest = m.dequantize_sum(m.center_ring(np.mod(q, hp.spec.ring), hp.spec), 4, hp.spec)
    assert np.array_equal(wire_vector(out).cpu().numpy(), honest)


@pytest.mark.cuda
def test_resnet56_state_dict_on_the_card_through_trpc_and_back(cuda):
    """A ResNet-56 state dict on the card, sent by a port TRPC manager in
    the wire layout, arrives on the CPU bit-equal: the layout converter and
    the frame codec take it to the host, and the receiver's state dict is
    made of CPU tensors."""
    import threading
    import time
    from types import SimpleNamespace

    from fedml_tpu_torch.core.distributed.communication.ip_config import free_port_block
    from fedml_tpu_torch.core.distributed.communication.message import Message
    from fedml_tpu_torch.core.distributed.communication.trpc.trpc_comm_manager import (
        TRPCCommManager)
    from fedml_tpu_torch.core.distributed.fedml_comm_manager import (from_wire_layout,
                                                                     to_wire_layout)
    from fedml_tpu_torch.models.model_hub import create

    args = SimpleNamespace(model="resnet56", dataset="cifar10")
    state = {k: v.detach().clone() for k, v in
             create(args, 10, seed=0, device="cuda").module.state_dict().items()}
    assert all(torch.isfinite(v).all() for v in state.values())
    assert sum(v.numel() * v.element_size() for v in state.values()) == 3_423_080
    base = free_port_block(2)
    m0 = TRPCCommManager(client_id=0, client_num=1, base_port=base)
    m1 = TRPCCommManager(client_id=1, client_num=1, base_port=base)
    got = []

    class Inbox:
        def receive_message(self, msg_type, msg):
            got.append(msg)

    m1.add_observer(Inbox())
    t1 = threading.Thread(target=m1.handle_receive_message, daemon=True)
    t1.start()
    try:
        msg = Message(3, 0, 1)
        msg.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, to_wire_layout(state))
        m0.send_message(msg)
        deadline = time.monotonic() + 60
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
        assert got
        back = from_wire_layout(got[0].get(Message.MSG_ARG_KEY_MODEL_PARAMS))
    finally:
        m0.stop_receive_message()
        m1.stop_receive_message()
        t1.join(10)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert back[k].device.type == "cpu" and back[k].dtype == v.dtype, k
        assert torch.equal(back[k], v.cpu()), k


# --- the trust middleware (core/dp, core/security) ------------------------------

TRUST_DEFENSES = ("krum", "multi_krum", "coordinate_wise_median", "coordinate_wise_trimmed_mean",
                  "rfa", "norm_diff_clipping", "foolsgold", "3sigma", "slsgd", "bulyan", "cclip",
                  "residual_reweight", "robust_learning_rate", "3sigma_geomedian")


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRUST_DEFENSES)
def test_defense_fold_on_the_card_matches_the_cpu_in_float64(cuda, name):
    """Each defense's three hooks on 16 LR-sized state dicts (the first 4
    Byzantine random) on the card, against the same functions on the CPU in
    float64: the same kept clients and the fold within 1e-5 of its scale."""
    from types import SimpleNamespace

    from fedml_tpu_torch.core.aggregation.agg_operator import FedMLAggOperator
    from fedml_tpu_torch.core.security.fedml_defender import FedMLDefender

    rng = np.random.default_rng(0)
    base = {"linear.weight": rng.normal(size=(10, 784)), "linear.bias": rng.normal(size=(10,))}
    lst = []
    for i in range(16):
        scale = 1.0 if i < 4 else 0.05
        centre = 0.0 if i < 4 else 1.0
        lst.append((100.0 + i, {k: centre * v + scale * rng.normal(size=v.shape)
                                for k, v in base.items()}))
    cfg = dict(random_seed=0, client_num_per_round=16, byzantine_client_num=3,
               federated_optimizer="FedAvg", enable_defense=True, defense_type=name,
               norm_bound=2.0, tau=1.0, bucket_size=2, robust_threshold=12)
    outs = {}
    for dev, dtype in ((cuda, torch.float32), (torch.device("cpu"), torch.float64)):
        d = FedMLDefender()
        d.init(SimpleNamespace(**cfg))
        g = {k: torch.tensor(v, dtype=dtype, device=dev) for k, v in base.items()}
        pairs = [(n, {k: torch.tensor(v, dtype=dtype, device=dev) for k, v in t.items()})
                 for n, t in lst]
        kept = d.defend_before_aggregation(pairs, g)
        ids = [next(i for i, p in enumerate(pairs) if p[1] is t) if any(p[1] is t for p in pairs)
               else None for _, t in kept]
        fold = d.defend_after_aggregation(d.defend_on_aggregation(kept, FedMLAggOperator.agg, g))
        outs[dev.type] = (ids, {k: v.double().cpu() for k, v in fold.items()},
                          getattr(d.defender, "selected", None))
    (ids_c, fold_c, sel_c), (ids_h, fold_h, sel_h) = outs["cuda"], outs["cpu"]
    assert ids_c == ids_h and sel_c == sel_h
    for k in fold_h:
        assert (fold_c[k] - fold_h[k]).abs().max() <= 1e-5 * max(1.0, fold_h[k].abs().max()), k
    if name in ("multi_krum", "bulyan"):
        assert min(sel_c) >= 4


@pytest.mark.cuda
def test_dp_noise_draws_on_the_tensors_device(cuda):
    """The DP facade noises a CUDA state dict with a generator on the card
    (a CPU generator cannot draw there), at the frame's sigma."""
    from types import SimpleNamespace

    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy

    dp = FedMLDifferentialPrivacy()
    dp.init(SimpleNamespace(enable_dp=True, dp_solution_type="cdp", epsilon=1.0, delta=1e-5,
                            random_seed=0, client_num_per_round=2, client_num_in_total=4))
    g = {"w": torch.zeros(1000, 1000, device=cuda)}
    out = dp.add_global_noise(g)
    assert out["w"].device.type == "cuda"
    assert [d.type for d in dp.generators._gens] == ["cuda"]
    sigma = dp.frame.cdp.sigma
    n = out["w"].numel()
    assert abs(float(out["w"].double().std()) / sigma - 1) <= 4 / np.sqrt(2 * n)
    assert dp.get_epsilon(1e-5) > 0


def test_rlwe_on_the_card_equals_the_plain_version(cuda):
    """The card's float64 negacyclic matrices against np.convolve at the
    default ring (N 4096, 4 primes): keys, ciphertexts of several leaves
    under one seeded generator, their fold and the decryption residues,
    integer for integer."""
    from fedml_tpu_torch.core.fhe.rlwe import RLWEContext, RLWEParams

    card = RLWEContext(RLWEParams(), seed=5, device=cuda)
    plain = RLWEContext(RLWEParams(), seed=5, device="cpu")
    assert card.route == "matrix" and plain.route == "plain"
    assert torch.equal(card.s.cpu(), plain.s)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card.pk, plain.pk))
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(0, 0.5, s).astype(np.float32)) for s in ((5000,), (3, 7))]
    card._rng, plain._rng = np.random.default_rng(1), np.random.default_rng(1)
    cc, cp = card.encrypt_many([x.to(cuda) for x in xs]), plain.encrypt_many(xs)
    for a, b in zip(cc, cp):
        assert torch.equal(a.c0.cpu(), b.c0) and torch.equal(a.c1.cpu(), b.c1)
    fc = [c * 0.3 + c * 0.7 for c in cc]
    fp = [c * 0.3 + c * 0.7 for c in cp]
    assert torch.equal(card.decrypt_residues(fc).cpu(), plain.decrypt_residues(fp))
    for got, x in zip(card.decrypt_many(fc), xs):
        assert got.device.type == "cuda" and torch.allclose(got.cpu(), x, atol=1e-5)


def test_rlwe_sp_round_on_the_card(cuda):
    """rlwe through init and FedMLRunner on the sp front, LR, 2 clients, 2
    rounds on the card: the model trains as the plain run does."""
    import fedml_tpu_torch

    from fedml_tpu_torch.core.fhe.fhe_agg import FedMLFHE

    kw = dict(model="lr", dataset="mnist", comm_round=2, epochs=1, client_num_in_total=2,
              client_num_per_round=2, frequency_of_the_test=1, data_cache_dir="")

    def run(**over):
        args = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", **kw, **over))
        if over:  # the encryption generator seeded: no draw from OS entropy
            FedMLFHE.get_instance().scheme.ctx._rng = np.random.default_rng(0)
        dataset, dim = fedml_tpu_torch.data.load(args)
        model = fedml_tpu_torch.model.create(args, dim)
        return fedml_tpu_torch.FedMLRunner(args, fedml_tpu_torch.get_device(args), dataset,
                                           model).run()

    try:
        out = run(enable_fhe=True, fhe_scheme="rlwe")
        plain = run()
    finally:
        fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False))
    assert abs(out["test_loss"] - plain["test_loss"]) <= 1e-3 * plain["test_loss"]


@pytest.mark.parametrize("opt", ["TA", "FedAvg_seq", "split_nn", "FedGKT"])
def test_sp_apis_run_on_the_card(cuda, opt):
    """The ported sp APIs through run_simulation on the card, 2 rounds."""
    import math

    import fedml_tpu_torch

    kw = dict(model="lr", dataset="mnist", comm_round=2, epochs=1, client_num_in_total=4,
              client_num_per_round=4, frequency_of_the_test=1, data_cache_dir="",
              federated_optimizer=opt, batch_size=64)
    out = fedml_tpu_torch.run_simulation(args=fedml_tpu_torch.default_config("simulation", **kw))
    assert math.isfinite(out["test_acc"]) and out["test_acc"] > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride", [(4, 2), (3, 2)])
def test_conv_transpose_on_the_card_matches_the_cpu(cuda, kernel, stride):
    """Both SAME paddings of flax's transposed convolution: (2, 2), torch's
    padding=1 (the GAN), and (2, 1), cropped (SegNetLite's decoder); the
    forward and the gradients, TF32 off, against the same module on the CPU."""
    from fedml_tpu_torch.models import layers

    gen = torch.Generator().manual_seed(0)
    cpu = layers.flax_init_(layers.ConvTranspose(16, 8, (kernel, kernel), (stride, stride)), gen)
    card = layers.ConvTranspose(16, 8, (kernel, kernel), (stride, stride)).to(cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(4, 16, 9, 9, generator=gen)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        outs = []
        for mod, dev in ((cpu, "cpu"), (card, cuda)):
            xi = x.to(dev).detach().requires_grad_(True)
            y = mod(xi)
            (y * torch.linspace(-1, 1, y.numel(), device=dev).reshape(y.shape)).sum().backward()
            outs.append([y.detach(), xi.grad, mod.weight.grad, mod.bias.grad])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert outs[0][0].shape == (4, 8, 18, 18)
    for a, b in zip(*outs):
        assert torch.allclose(b.cpu(), a, rtol=1e-4, atol=1e-4 * float(a.abs().max())), \
            float((a - b.cpu()).abs().max())


@pytest.mark.cuda
def test_lstm_on_the_card_matches_the_cpu(cuda):
    """The flax LSTM leaves through torch.lstm (cuDNN on the card): the
    hidden states and every leaf's gradient, TF32 off, against the CPU."""
    from fedml_tpu_torch.models import layers, rnn

    cpu = layers.flax_init_(rnn.RNNOriginalFedAvg(hidden_size=64), torch.Generator().manual_seed(0))
    card = rnn.RNNOriginalFedAvg(hidden_size=64).to(cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randint(0, 90, (8, 40), generator=torch.Generator().manual_seed(1))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        grads = []
        for mod, dev in ((cpu, "cpu"), (card, cuda)):
            y = mod(x.to(dev))
            (y * torch.linspace(-1, 1, y.numel(), device=dev).reshape(y.shape)).mean().backward()
            grads.append([y.detach()] + [p.grad for p in mod.parameters()])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for a, b in zip(*grads):
        assert torch.allclose(b.cpu(), a, rtol=1e-4, atol=1e-4 * float(a.abs().max())), \
            float((a - b.cpu()).abs().max())


@pytest.mark.cuda
def test_data_plane_builds_on_the_cards_machine(cuda, tmp_path):
    """The C++ prefetcher builds from native/dataplane/src into the port's
    own build dir; its batches are the shard's samples in the order its
    shuffle's Python re-derivation gives, and move to the card whole."""
    from fedml_tpu_torch.data import native_loader as nl
    from fedml_tpu_torch.data.dataset import ArrayDataset

    assert nl.NativeBatchLoader.available(), nl.build_error()
    assert "/ops/_build/dataplane/" in nl.lib_path()
    rng = np.random.default_rng(0)
    x = rng.random((64, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 64)
    paths = ArrayDataset(x, y).save_shards(str(tmp_path / "d"))
    batches = list(ArrayDataset.stream(paths, 16, seed=9, epochs=1))
    perm = nl.native_permutation(64, 9, 0)
    assert np.array_equal(np.concatenate([b[0] for b in batches]), x[perm])
    on_card = torch.from_numpy(batches[0][0]).to(cuda)
    assert torch.equal(on_card.cpu(), torch.from_numpy(x[perm[:16]]))


@pytest.mark.cuda
def test_hf_import_placed_on_the_card(cuda, tmp_path):
    """An HF checkpoint exported in bf16 and imported into a model on the
    card: the weights equal the written ones, the f32 logits the CPU's."""
    from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
    from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from fedml_tpu_torch.train.llm import checkpoint_import as ci

    cfg = TransformerConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=256, max_seq_len=64, dtype=torch.float32, attention_impl="xla",
                            remat=False)
    src = TransformerLM(cfg)
    src.reset_parameters(torch.Generator().manual_seed(0))
    ci.export_hf_checkpoint(params_to_jax(src), cfg, str(tmp_path), dtype=torch.bfloat16)
    state = params_from_jax(ci.import_hf_checkpoint(str(tmp_path)))
    models = {}
    for dev in ("cpu", cuda):
        models[str(dev)] = TransformerLM(cfg, device=dev)
        models[str(dev)].load_state_dict(state)
    for name, w in src.state_dict().items():
        assert torch.equal(models["cuda"].state_dict()[name].cpu(),
                           w.to(torch.bfloat16).float()), name
    toks = torch.randint(0, 512, (2, 16), generator=torch.Generator().manual_seed(1))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ref, got = models["cpu"](toks), models["cuda"](toks.to(cuda)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


# the int8 GEMM against its plain version (ops/int8_matmul.py), relative
# error over the whole output: bf16 outputs differ where the one cast of an
# f32 result rounds the other way after another summation order (at most a
# bf16 ulp, 2^-8, an element, far fewer in norm); f32 by summation order only.
# The limits are chip_smoke.py's (INT8_RTOL).
INT8_RTOL = {torch.bfloat16: 4e-3, torch.float32: 1e-5}
# the tile edges of the bf16 designs: M around the decode limit of 8 and the
# prefill's token tiles (16, 32, 64, 128; two consumers above 128), N 1000
# (not a multiple of the 64- and 128-channel tiles), K 48 and 1040 (multiples
# of 16, not of the prefill's 128-column stage; 48 leaves one stage, 1040 a
# K split over a cluster with a ragged end); f32 stays on the SIMT designs
INT8_CASES = [(torch.bfloat16, m, n, k)
              for m in (1, 2, 7, 8, 9, 16, 63, 64, 65, 77, 130, 512, 1000)
              for n in (1000, 4096) for k in (48, 1040, 4096)] + \
             [(torch.float32, m, n, k) for m in (1, 7, 8, 9, 77, 512)
              for n, k in ((1000, 1040), (4096, 4096))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m,n,k", INT8_CASES)
def test_int8_gemm_matches_plain_version(cuda, dtype, m, n, k):
    from fedml_tpu_torch.ops import int8_matmul as im

    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda, dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8)).to(cuda)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(np.float32)).to(cuda)
    before = im.launch_counts["int8_gemm"]
    designs_before = _build.kernels().int8_design_launches()
    got = im.int8_matmul(x, wq, scale)
    torch.cuda.synchronize()
    assert im.launch_counts["int8_gemm"] == before + 1
    designs = _build.kernels().int8_design_launches()
    ran = {d: designs[d] - designs_before[d] for d in designs if designs[d] != designs_before[d]}
    assert ran == {im.design_for(m, dtype): 1}, ran
    ref = im.int8_matmul_reference(x, wq, scale)
    assert got.dtype == dtype and got.shape == (m, n) and torch.isfinite(got).all()
    rel = ((got.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= INT8_RTOL[dtype], rel


@pytest.mark.cuda
def test_int8_gemm_refuses_what_the_kernel_does_not_take(cuda):
    from fedml_tpu_torch.ops import int8_matmul as im

    wq = torch.zeros(8, 24, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        im.int8_matmul(torch.zeros(1, 24, device=cuda), wq, torch.ones(8, device=cuda))
    with pytest.raises(ValueError, match="takes x in"):
        im.int8_matmul(torch.zeros(1, 16, device=cuda, dtype=torch.float16),
                       wq[:, :16].contiguous(), torch.ones(8, device=cuda))


@pytest.mark.cuda
def test_int8_decode_on_cuda_matches_the_cpu(cuda):
    """A tiny f32 int8 model decodes the same greedy tokens through the
    kernel on the card as through the plain version on the CPU."""
    from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from fedml_tpu_torch.serving.quant import quantize_model_int8
    from fedml_tpu_torch.train.llm import generation as tg

    cfg = TransformerConfig(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=128, max_seq_len=32, remat=False, lora_rank=0,
                            dtype=torch.float32)
    model = TransformerLM(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    qcfg, qstate = quantize_model_int8(cfg, model)
    prompts = [[1, 5, 9, 3], [7, 2, 2, 8]]
    cpu = tg.generate(tg.decode_model(qcfg, qstate, device="cpu"), qcfg, prompts, 8, device="cpu")
    card = tg.generate(tg.decode_model(qcfg, qstate, device=cuda), qcfg, prompts, 8, device=cuda)
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
def test_a_fresh_checkout_s_card_replica_loads_the_kernels_its_parent_built(cuda, tmp_path):
    """deploy_isolated from a checkout that has built no kernel: the
    ReplicaSet builds them once, in the deploying process, before its child
    starts; the child (an int8 replica, which launches the GEMM) loads them
    under the flag that makes a missing library raise, so it ran no nvcc."""
    import json
    import os
    import shutil
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    shutil.copytree(root / "fedml_tpu_torch", tmp_path / "fedml_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    script = textwrap.dedent("""
        import json, os, urllib.request
        from fedml_tpu_torch.ops import _build
        from fedml_tpu_torch.serving.endpoint import EndpointManager

        assert not _build.BUILD_DIR.exists()
        env = dict(os.environ, FEDML_BENCH_TINY="1", FEDML_BENCH_INT8="1",
                   FEDML_REPLICA_MEM_FRACTION="0.05")
        mgr = EndpointManager()
        gw = mgr.deploy_isolated(
            "fresh", "fedml_tpu_torch.serving.bench_predictors:llm_bench_predictor", 1, env=env)
        try:
            built = {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.iterdir()}
            out = gw.predict({"prompt": "federated", "max_new_tokens": 4})
            url = gw.replica_set.healthy()[0].url
            metrics = urllib.request.urlopen(url + "/metrics", timeout=30).read().decode()
            after = {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.iterdir()}
        finally:
            mgr.undeploy("fresh")
        launches = [float(line.split()[-1]) for line in metrics.splitlines()
                    if line.startswith("fedml_ops_int8_gemm_launches_total")]
        print(json.dumps({"libs": sorted(n for n in built if n.endswith(".so")),
                          "unchanged": built == after, "launches": launches,
                          "text": out["text"]}))
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("FEDML_")}
    env["PYTHONPATH"] = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(res["libs"]) == len(_build.KERNEL_SOURCES), res
    assert res["unchanged"] and res["launches"] and res["launches"][0] > 0, res


@pytest.mark.cuda
def test_devperf_reads_the_card(cuda):
    """devperf on the card: the card matches an H100 row (never the unknown
    default), a fold on a CUDA program records its allocated bytes without
    resetting the peak, and the sampler reads the card's memory."""
    from fedml_tpu_torch.core.distributed import device_specs
    from fedml_tpu_torch.core.telemetry import devperf

    devperf.reset()
    try:
        name = torch.cuda.get_device_name(0)
        assert device_specs.device_row(name) in ("h100", "h100 pcie", "h100 nvl")
        x = torch.ones(1024, 1024, device=cuda)
        peak = torch.cuda.max_memory_allocated()
        devperf.instrument(lambda: None, "t_card", flops_hint=2 * 1024 ** 3, device=cuda)
        mfu = devperf.observe_step("t_card", 1e-3)
        rec = devperf.snapshot()["programs"]["t_card"]
        assert rec["device_kind"] == name and rec["dtype"] == "bfloat16"
        assert rec["peak_flops_per_sec"] == device_specs.peak_flops_per_sec(name, torch.bfloat16)
        assert mfu == pytest.approx(2 * 1024 ** 3 / 1e-3 / rec["peak_flops_per_sec"])
        assert rec["memory"]["allocated_bytes"] >= x.numel() * 4
        assert torch.cuda.max_memory_allocated() == peak  # not reset
        ((label, st),) = devperf.device_memory_stats()[:1]
        assert label == "cuda:0" and 0 < st["peak_bytes_in_use"] <= st["bytes_limit"]
        assert st["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory
    finally:
        devperf.reset()


def _sync_calls(fn):
    """(fn(), the synchronising CUDA calls it made, as
    torch.cuda.set_sync_debug_mode("warn") reports them: their messages)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message) for w in caught if str(w.message).startswith("called a synchronizing")]


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True], ids=["float32", "mixed"])
def test_watched_fold_on_the_card_is_bit_equal_and_adds_no_sync(cuda, mixed):
    """modelwatch's fused fold on the card: 20 uploads (a full bucket of 16
    and a ragged one) published bit-equal with and without a watch, through
    ``aggregate`` and through the async buffer's two fold sites, with as
    many synchronising calls; the rows within rtol 1e-5 of the same stats
    computed on the CPU (f32 sums in another order), NaN counts exact."""
    from fedml_tpu_torch.core.aggregation.async_buffer import AsyncAggBuffer, StalenessPolicy
    from fedml_tpu_torch.core.aggregation.bucketed import BucketedAggregator
    from fedml_tpu_torch.core.telemetry import modelwatch

    gen = torch.Generator(device="cuda").manual_seed(0)

    def tree(scale=1.0):
        t = {"w": torch.randn(256, 128, device="cuda", generator=gen) * scale,
             "b": torch.randn(128, device="cuda", generator=gen) * scale}
        if mixed:
            t["e"] = (torch.randn(64, device="cuda", generator=gen) * scale).to(torch.bfloat16)
        return t

    ref = tree()
    pairs = [(float(i + 1), tree(50.0 if i == 7 else 1.0)) for i in range(20)]
    pairs[11][1]["w"][0, 0] = float("nan")
    eng = BucketedAggregator(bucket_size=16)
    for _ in range(2):  # warm both paths (and the caching allocator's pools)
        eng.aggregate(pairs)
        eng.aggregate(pairs, watch=modelwatch.WatchSession(ref))
    plain, n_plain = _sync_calls(lambda: eng.aggregate(pairs))
    sess = modelwatch.WatchSession(ref)
    watched, n_watched = _sync_calls(lambda: eng.aggregate(pairs, watch=sess))
    assert len(n_watched) == len(n_plain), (n_plain, n_watched)
    for k in plain:
        bits = torch.int16 if plain[k].dtype == torch.bfloat16 else torch.int32
        assert torch.equal(plain[k].view(bits), watched[k].view(bits)), k
    rows = sess.finish(watched).rows
    cpu = modelwatch.WatchSession({k: v.cpu() for k, v in ref.items()})
    modelwatch.screen_cohort(cpu, [(n, {k: v.cpu() for k, v in t.items()}) for n, t in pairs])
    want = cpu.finish({k: v.cpu() for k, v in watched.items()}).rows
    assert [r["nan"] for r in rows] == [r["nan"] for r in want] and rows[11]["nan"] == 1
    for got, ref_row in zip(rows, want):
        if ref_row["nan"]:
            continue
        for key in ("norm", "cosine", "update_ratio"):
            assert got[key] == pytest.approx(ref_row[key], rel=1e-5), (ref_row["rank"], key)
        assert got["group_norms"].keys() == ref_row["group_norms"].keys()
    outs = []
    for watch in (False, True):
        buf = AsyncAggBuffer(publish_k=20, policy=StalenessPolicy(exponent=0.0), engine=eng)
        if watch:
            assert buf.enable_watch(ref, ledger=modelwatch.ContributionLedger())
        for r, (n, t) in enumerate(pairs):
            buf.submit(r, t, n, None)
        outs.append(buf.publish())
    for k in outs[0]:
        bits = torch.int16 if outs[0][k].dtype == torch.bfloat16 else torch.int32
        assert torch.equal(outs[0][k].view(bits), outs[1][k].view(bits)), k


@pytest.mark.cuda
def test_train_guard_on_the_card_matches_a_plain_norm(cuda):
    """The LLM guard's ``[sq_norm, nan, inf]`` over a bf16 and f32 state
    dict on the card: the norm within rtol 1e-5 of float64's, the counts
    exact."""
    from fedml_tpu_torch.core.telemetry import modelwatch

    gen = torch.Generator(device="cuda").manual_seed(1)
    sd = {"a": torch.randn(4096, 1024, device="cuda", generator=gen).to(torch.bfloat16),
          "b": torch.randn(1000, device="cuda", generator=gen)}
    g = modelwatch.train_guard(sd).cpu().double()
    want = sum(float(v.double().pow(2).sum()) for v in sd.values())
    assert float(g[0]) == pytest.approx(want, rel=1e-5) and g[1] == 0 and g[2] == 0
    sd["b"][3] = float("nan")
    sd["a"][0, :2] = float("inf")
    g = modelwatch.train_guard(sd).cpu()
    assert (int(g[1]), int(g[2])) == (1, 2)


# --- several processes on the one card (parallel/, simulation/collective) ---------------

_SHARED_CARD_RANK = """
import json, os, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import torch
from fedml_tpu_torch.parallel import multihost as mh
from fedml_tpu_torch.parallel.dp import DataParallelGroup

out_dir = sys.argv[1]
assert mh.init_distributed()
rank, dev = mh.process_index(), mh.process_device()
meta = mh.broadcast_round_metadata({"round": 3} if rank == 0 else None)
src = {"w": torch.arange(6.0, device=dev).reshape(2, 3) * (rank + 1),
       "n": torch.tensor([7 * (rank + 1)], device=dev)}
got = mh.broadcast_model_params(src)
p = torch.zeros(4, device=dev, requires_grad=True)
p.grad = torch.full((4,), float(rank + 1), device=dev)
loss = DataParallelGroup(2, rank).all_reduce_grads_({"p": p}, torch.tensor(rank + 1.0, device=dev))
res = {"backend": mh.backend(), "device": str(dev), "meta": meta,
       "w": got["w"].tolist(), "n": got["n"].tolist(), "sum": p.grad.tolist() + [loss.item()],
       "on_card": all(t.device == dev for t in (got["w"], got["n"], p.grad, loss)),
       "stats": mh.collective_stats()}
mh.shutdown_distributed()
json.dump(res, open(os.path.join(out_dir, f"rank{rank}.json"), "w"))
"""


@pytest.mark.cuda
def test_two_ranks_share_the_card_over_gloo(cuda, tmp_path):
    """Two ranks of one silo on the one card: the rule picks gloo (NCCL
    refuses two ranks on a device), the tensors stay on the card through
    the metadata and params broadcasts and the DP all-reduce."""
    import json
    import os
    import sys

    from fedml_tpu_torch.tools.launch_silo import launch

    if torch.cuda.device_count() != 1:
        pytest.skip("the shared-card rule is checked with one visible card")
    script = tmp_path / "rank.py"
    script.write_text(_SHARED_CARD_RANK)
    env = dict(os.environ, REPO_ROOT=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    rcs = launch([sys.executable, str(script), str(tmp_path)], 2, env=env,
                 log_dir=str(tmp_path / "logs")).wait(180)
    assert rcs == [0, 0], [(tmp_path / "logs" / f"rank{r}.err").read_text()[-2000:]
                           for r in (0, 1)]
    for r in (0, 1):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["backend"] == "gloo" and res["device"] == "cuda:0" and res["on_card"]
        assert res["meta"] == {"round": 3}
        assert res["w"] == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]] and res["n"] == [7]
        assert res["sum"] == [3.0] * 5
        assert res["stats"]["dp_all_reduce"] == {"calls": 1, "bytes": 20}


@pytest.mark.cuda
def test_nccl_one_group_on_the_card_is_the_vmapped_round(cuda):
    """Backend NCCL on the one visible card runs one group: the vmapped
    round, bit for bit (LR on the synthetic set, 4 clients, 2 rounds)."""
    import fedml_tpu_torch

    kw = dict(dataset="synthetic", model="lr", comm_round=2, client_num_in_total=4,
              client_num_per_round=4, batch_size=16, frequency_of_the_test=1, random_seed=0,
              data_cache_dir="")
    out = {}
    for backend in ("vmap", "NCCL"):
        args = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", backend=backend,
                                                                   **kw))
        dataset, output_dim = fedml_tpu_torch.data.load(args)
        model = fedml_tpu_torch.model.create(args, output_dim)
        runner = fedml_tpu_torch.FedMLRunner(args, fedml_tpu_torch.get_device(args), dataset,
                                             model)
        runner.run()
        api = runner.runner.fl_trainer
        out[backend] = (api.metrics_history, api.model.params)
    assert [d.type for d in runner.runner.fl_trainer.devices] == ["cuda"]
    assert out["NCCL"][0] == out["vmap"][0]
    assert all(torch.equal(out["NCCL"][1][k], out["vmap"][1][k]) for k in out["vmap"][1])


@pytest.mark.cuda
def test_moe_lora_step_through_the_kernels_matches_xla(cuda):
    """A MoE model with LoRA on q/k/v/o, one training step on the card
    through the flash kernels ("auto") against the same weights through the
    plain attention ("xla"), bf16: the loss within 1e-2 (phase 27 (a)'s
    tolerance: bf16 roundings through 2 layers), each adapter gradient
    within 5e-2 of its norm, K1-K3 launched as the step needs."""
    from fedml_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from fedml_tpu_torch.parallel.fsdp import causal_lm_loss

    base = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
                max_seq_len=256, lora_rank=4, moe_experts=4, remat=True)
    toks = torch.randint(0, 512, (2, 256), generator=torch.Generator().manual_seed(0)).cuda()
    out = {}
    for impl in ("auto", "xla"):
        model = TransformerLM(TransformerConfig(attention_impl=impl, **base), device="cuda")
        model.reset_parameters(torch.Generator(device="cuda").manual_seed(1))
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.endswith("lora_b"):
                    p.normal_(0.0, 0.02, generator=torch.Generator(device="cuda").manual_seed(2))
        for n, p in model.named_parameters():
            p.requires_grad_(n.rsplit(".", 1)[-1] in ("lora_a", "lora_b"))
        fa.reset_launch_counts()
        logits, aux = model(toks)
        loss = causal_lm_loss(logits, toks) + aux
        loss.backward()
        torch.cuda.synchronize()
        out[impl] = (float(loss), {n: p.grad.float() for n, p in model.named_parameters()
                                   if p.grad is not None}, dict(fa.launch_counts))
    assert abs(out["auto"][0] - out["xla"][0]) <= 1e-2
    assert out["auto"][2] == {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert out["xla"][2] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for n, g in out["xla"][1].items():
        err = float((out["auto"][1][n] - g).norm())
        assert err <= 5e-2 * float(g.norm()) + 1e-6, (n, err)


_RING_RANK = """
import json, os, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import torch
from fedml_tpu_torch.models.transformer import xla_attention
from fedml_tpu_torch.parallel import multihost as mh
from fedml_tpu_torch.parallel.mesh import RankMesh
from fedml_tpu_torch.parallel.ring_attention import ring_attention

out_dir = sys.argv[1]
assert mh.init_distributed()
rank, dev = mh.process_index(), mh.process_device()
torch.backends.cuda.matmul.allow_tf32 = False
g = torch.Generator(device="cpu").manual_seed(3)
q, k, v, w = (torch.randn(2, 64, 4, 32, generator=g) for _ in range(4))
mesh = RankMesh((2,), ("sp",))
res = {"backend": mh.backend(), "device": str(dev)}
for layout in ("zigzag", "contiguous"):
    sl = slice(rank * 32, rank * 32 + 32)
    ql, kl, vl = (x[:, sl].to(dev).requires_grad_() for x in (q, k, v))
    o = ring_attention(ql, kl, vl, mesh, layout=layout)
    (o * w[:, sl].to(dev)).sum().backward()
    qf, kf, vf = (x.to(dev).requires_grad_() for x in (q, k, v))
    ref = xla_attention(qf, kf, vf, causal=True)
    (ref * w.to(dev)).sum().backward()
    res[layout] = {"out": float((o - ref[:, sl]).abs().max()),
                   "dq": float((ql.grad - qf.grad[:, sl]).abs().max()),
                   "dk": float((kl.grad - kf.grad[:, sl]).abs().max()),
                   "dv": float((vl.grad - vf.grad[:, sl]).abs().max()),
                   "on_card": all(t.device == dev for t in (o, ql.grad, kl.grad, vl.grad))}
res["stats"] = mh.collective_stats()
mh.shutdown_distributed()
json.dump(res, open(os.path.join(out_dir, f"rank{rank}.json"), "w"))
"""


@pytest.mark.cuda
def test_ring_shift_across_two_ranks_sharing_the_card(cuda, tmp_path):
    """Ring attention over 2 gloo ranks on the one card (the ring shift
    stages CUDA tensors through host memory: gloo's CUDA send/recv fail):
    each rank's output and dQ/dK/dV within 1e-5 of the whole sequence's
    plain attention (f32, TF32 off), both layouts, the shifts counted."""
    import json
    import os
    import sys

    from fedml_tpu_torch.tools.launch_silo import launch

    if torch.cuda.device_count() != 1:
        pytest.skip("ranks share the card only with one visible card")
    script = tmp_path / "rank.py"
    script.write_text(_RING_RANK)
    env = dict(os.environ, REPO_ROOT=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    rcs = launch([sys.executable, str(script), str(tmp_path)], 2, env=env,
                 log_dir=str(tmp_path / "logs")).wait(180)
    assert rcs == [0, 0], [(tmp_path / "logs" / f"rank{r}.err").read_text()[-2000:]
                           for r in (0, 1)]
    for r in (0, 1):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["backend"] == "gloo" and res["device"] == "cuda:0"
        for layout in ("zigzag", "contiguous"):
            row = res[layout]
            assert row["on_card"]
            assert max(row[n] for n in ("out", "dq", "dk", "dv")) <= 1e-5, (layout, row)
        assert res["stats"]["ring_shift"]["calls"] > 0
        assert res["stats"]["ring_zigzag"]["calls"] > 0
