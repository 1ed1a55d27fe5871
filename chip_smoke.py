#!/usr/bin/env python3
"""Chip smoke for fedml_tpu_torch: the FedLLM LoRA train step on one CUDA card.

    python3 chip_smoke.py

Phases, in order (any failed check exits non-zero; no phase swallows an
exception):

1. device: the card's name and power limit (nvidia-smi) and the versions;
2. build: the three flash-attention kernels from ops/csrc, at first use;
3. kernels: each kernel against its plain PyTorch version on the card at the
   slice shapes (B=2, T=2048, Hq=32, D=128, bf16; causal, dense, GQA with
   Hkv=8, ragged T=2000, D=64 tiles, one f32 case), checking O, lse, dQ, dK
   and dV, with timings of the kernel, its plain version and
   torch's scaled_dot_product_attention as a yardstick (the port never
   calls it);
4. train step: LLMTrainer.train for 3 steps at Llama-2-7B widths (d_model
   4096, 32 heads, d_ff 11008, vocab 32000) cut to 4 layers, bf16 compute,
   f32 params, LoRA rank 8 on q/k/v/o, seq_len 2048, batch 2: finite loss,
   adapters moved, base weights bit-unchanged;
5. client round: LLMClientTrainer set_model_params -> train -> get_model_params;
   adapter keys equal split_lora's paths and the round moves them.
   Launch counts are zeroed before phase 4 and read after phase 5: each kernel
   must have run exactly as often as those steps imply;
6. the kernels line (JSON), the card line, and last the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Slice shapes: Llama-2-7B attention (32 heads of 128) at seq 2048, batch 2.
B, T, HQ, D = 2, 2048, 32, 128
N_LAYERS = 4
TRAIN_STEPS = 3
ROUND_STEPS = 2

# Kernel against plain version, on the same inputs, row by row: for every
# row r of an output (one query or key position of one head),
# ||got_r - ref_r|| <= ROW_RTOL * ||ref_r|| + ROW_ATOL. Each row is held to
# its own size, so small late rows (causal O, dQ) are held as tightly as
# the large early ones. bf16 outputs differ where the last cast, or the cast
# of p/ds, rounds the other way (one bf16 ulp, 2^-8 relative, an element):
# worst rows measured 4.8e-3 on an H100 (PERF.md), about half the limit. f32
# outputs differ by summation order only: worst rows measured 1.6e-6.
ROW_RTOL = {"bfloat16": 1e-2, "float32": 1e-5}
ROW_ATOL = 1e-6
LSE_TOL = 1e-4  # lse is f32 in both dtypes, ~8 in size: abs 1e-4 is 1e-5 relative

KERNELS = {
    "flash_fwd": ("fedml_tpu_torch/ops/csrc/flash_fwd.cu", "fedml_tpu/ops/flash_attention.py:180"),
    "flash_bwd_dq": ("fedml_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     "fedml_tpu/ops/flash_attention.py:273"),
    "flash_bwd_dkv": ("fedml_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                      "fedml_tpu/ops/flash_attention.py:305"),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _inputs(b, t, hq, hkv, d, dtype, seed=0):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    mk = lambda rows: torch.randn(rows, t, d, generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(b * hq), mk(b * hkv), mk(b * hkv), mk(b * hq)


def _err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item()


def row_check(got, ref, dtype) -> tuple[bool, float]:
    """(every row within ROW_RTOL * ||ref_r|| + ROW_ATOL, worst ||err_r|| / ||ref_r||)."""
    d = got.shape[-1]
    err = (got.float() - ref.float()).reshape(-1, d).norm(dim=-1)
    size = ref.float().reshape(-1, d).norm(dim=-1)
    ok = bool((err <= ROW_RTOL[str(dtype).split(".")[-1]] * size + ROW_ATOL).all().item())
    return ok, (err / size.clamp_min(1e-30)).max().item()


def kernel_case(fa, b, t, hq, hkv, d, causal, dtype, block_q=None, block_k=None) -> dict:
    """Each kernel against its plain version on the same inputs; raises on a
    disagreement. Returns the max abs error per kernel."""
    import torch

    q, k, v, do = _inputs(b, t, hq, hkv, d, dtype)
    kw = dict(causal=causal, hq=hq, hkv=hkv)
    tiles = dict(block_q=block_q, block_k=block_k)
    o, lse = fa.flash_fwd(q, k, v, **kw, **tiles)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, **kw)
    # both backward kernels read the plain forward's stats, so each is held
    # against its own plain version on identical inputs
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw, **tiles)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **kw, **tiles)
    torch.cuda.synchronize()
    dq_ref = fa.flash_bwd_dq_reference(q, k, v, do, lse_ref, delta, **kw)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, do, lse_ref, delta, **kw)
    label = (f"B={b} T={t} Hq={hq} Hkv={hkv} D={d} causal={causal} {str(dtype)[6:]} "
             f"tiles={fa.resolve_blocks(block_q, block_k)}")
    errs, rels = {}, {}
    for name, got, ref in (("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref),
                           ("dv", dv, dv_ref)):
        errs[name] = _err(got, ref)
        check(torch.isfinite(got).all().item(), f"{label}: {name} not finite")
        ok, rels[name] = row_check(got, ref, dtype)
        check(ok, f"{label}: {name} row error {rels[name]:.3g} of its row's size, "
                  f"over {ROW_RTOL[str(dtype).split('.')[-1]]}")
    errs["lse"] = _err(lse, lse_ref)
    check(errs["lse"] <= LSE_TOL, f"{label}: lse err {errs['lse']} > {LSE_TOL}")
    say(f"  ok {label}: max abs " + " ".join(f"{n}={e:.3g}" for n, e in errs.items())
        + "; worst row rel " + " ".join(f"{n}={e:.3g}" for n, e in rels.items()))
    return {"flash_fwd": max(errs["o"], errs["lse"]), "flash_bwd_dq": errs["dq"],
            "flash_bwd_dkv": max(errs["dk"], errs["dv"])}


def time_kernels(fa, b, t, hq, hkv, d, dtype) -> dict:
    """ms of each kernel, its plain version and the library yardstick, and
    the bound, at the main path's shape (causal)."""
    import torch
    import torch.nn.functional as F

    q, k, v, do = _inputs(b, t, hq, hkv, d, dtype, seed=1)
    kw = dict(causal=True, hq=hq, hkv=hkv)
    o, lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    q4, k4, v4 = (x.view(b, -1, t, d).detach().clone().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, enable_gqa=hq != hkv)
    do4 = do.view(b, hq, t, d)

    @torch.no_grad()
    def sdpa_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, enable_gqa=hq != hkv)

    times = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_fwd_reference(q, k, v, **kw),
                      sdpa_fwd),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                         lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
                         None),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
                          lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw),
                          None),
    }
    # the library's backward computes dQ, dK and dV in one call: it stands
    # beside both backward kernels
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, (q4, k4, v4), do4,
                                                      retain_graph=True), 10)
    # operations: 2*D per (q, k) product, over the causal pairs these inputs need
    pairs = b * hq * t * (t + 1) / 2
    esize = q.element_size()
    qbytes, kvbytes, stat = q.numel() * esize, k.numel() * esize, b * hq * t * 4
    work = {  # (operations, bytes: inputs read once + outputs written once)
        "flash_fwd": (2 * 2 * d * pairs, 2 * qbytes + 2 * kvbytes + stat),
        "flash_bwd_dq": (3 * 2 * d * pairs, 3 * qbytes + 2 * kvbytes + 2 * stat),
        "flash_bwd_dkv": (4 * 2 * d * pairs, 2 * qbytes + 4 * kvbytes + 2 * stat),
    }
    peak = PEAK_FLOPS[str(dtype).split(".")[-1]]
    out = {}
    for name, (kernel, plain, lib) in times.items():
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = {
            "ms": cuda_ms(kernel, 10),
            "plain_ms": cuda_ms(plain, 3),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": cuda_ms(lib, 10) if lib is not None else sdpa_bwd_ms,
        }
    return out


def _snapshot(model, adapters: bool):
    from fedml_tpu_torch.train.llm.llm_trainer import is_lora_name

    return {n: p.detach().clone() for n, p in model.named_parameters()
            if is_lora_name(n) == adapters}


def train_phase(tmp: str) -> dict:
    """LLMTrainer.train: 3 steps at Llama-2-7B widths, 4 layers."""
    import numpy as np
    import torch

    from fedml_tpu_torch.train.llm.configurations import (DatasetArguments,
                                                          ExperimentArguments, ModelArguments)
    from fedml_tpu_torch.train.llm.data import TextDataset
    from fedml_tpu_torch.train.llm.llm_trainer import LLMTrainer

    ma = ModelArguments(vocab_size=32000, d_model=4096, n_layers=N_LAYERS, n_heads=HQ,
                        n_kv_heads=HQ, d_ff=11008, seq_len=T, lora_rank=8, remat=True)
    ea = ExperimentArguments(max_steps=TRAIN_STEPS, per_device_batch_size=B, learning_rate=1e-4,
                             warmup_steps=1, output_dir=os.path.join(tmp, "trainer"))
    trainer = LLMTrainer(ma, DatasetArguments(), ea)  # device defaults to cuda
    check(trainer.cfg.attention_impl == "auto" and trainer.device.type == "cuda",
          "trainer is not on the CUDA kernel path")
    trainer._build(trainer.init_params())
    n_params = sum(p.numel() for p in trainer.model.parameters())
    base0, lora0 = _snapshot(trainer.model, False), _snapshot(trainer.model, True)
    blocks = np.random.default_rng(0).integers(0, ma.vocab_size, (16, T), dtype=np.int32)
    torch.cuda.reset_peak_memory_stats()
    metrics = trainer.train(TextDataset(blocks).batches(B, TRAIN_STEPS, seed=0))
    check(metrics["steps"] == TRAIN_STEPS, f"trainer ran {metrics['steps']} steps")
    check(np.isfinite(metrics["final_loss"]), f"loss not finite: {metrics['final_loss']}")
    after_base, after_lora = _snapshot(trainer.model, False), _snapshot(trainer.model, True)
    check(all(torch.equal(base0[n], after_base[n]) for n in base0), "base weights changed")
    check(any(not torch.equal(lora0[n], after_lora[n]) for n in lora0), "adapters did not move")
    say(f"  params={n_params} final_loss={metrics['final_loss']:.6f} "
        f"tokens_per_sec={metrics['tokens_per_sec']:.1f} "
        f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    adapters = trainer.adapter_params()
    del trainer, base0, lora0, after_base, after_lora
    torch.cuda.empty_cache()
    return {"metrics": metrics, "adapters": adapters, "n_params": n_params}


def client_phase(tmp: str, global_adapters: dict) -> dict:
    """One LLMClientTrainer round: set_model_params -> train -> get_model_params."""
    import numpy as np

    from fedml_tpu_torch.models.lora import split_lora
    from fedml_tpu_torch.train.llm.fed_llm_trainer import LLMClientTrainer

    args = SimpleNamespace(vocab_size=32000, d_model=4096, n_layers=N_LAYERS, n_heads=HQ,
                           n_kv_heads=HQ, d_ff=11008, seq_len=T, lora_rank=8, remat=True,
                           per_device_batch_size=B, local_steps=ROUND_STEPS, learning_rate=1e-4,
                           warmup_steps=1, output_dir=os.path.join(tmp, "client"))
    client = LLMClientTrainer(args)
    client.set_id(1)
    client.set_model_params(global_adapters)
    sent = _flat(global_adapters)
    got = _flat(client.get_model_params())
    expected = _flat(split_lora(client.llm.named_params())[0])
    check(sorted(got) == sorted(expected), "adapter keys differ from split_lora's")
    check(len(got) == N_LAYERS * 4 * 2, "unexpected number of adapter leaves")
    check(got.keys() == sent.keys() and all(np.array_equal(got[p], sent[p]) for p in sent),
          "set_model_params -> get_model_params is not the identity")
    blocks = np.random.default_rng(1).integers(0, args.vocab_size, (8, T), dtype=np.int32)
    metrics = client.train(blocks)
    out = _flat(client.get_model_params())
    check(np.isfinite(metrics["final_loss"]), "client loss not finite")
    check(any(not np.array_equal(out[p], sent[p]) for p in sent),
          "the round did not move the adapters")
    say(f"  client round: steps={metrics['steps']} final_loss={metrics['final_loss']:.6f} "
        f"tokens_per_sec={metrics['tokens_per_sec']:.1f} adapter_leaves={len(out)}")
    return metrics


def _flat(tree, prefix=()) -> dict:
    """Nested dict -> {path tuple: leaf}."""
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs one CUDA card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "fedml_tpu_torch", "ops", "csrc")):
        print("chip_smoke: run from a checkout of the repository (fedml_tpu_torch/ not found)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from fedml_tpu_torch.ops import _build
    from fedml_tpu_torch.ops import flash_attention as fa

    t_start = time.time()
    say("== 1. device")
    card = card_line()
    say(f"  {card}; torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    say("== 2. build")
    t0 = time.time()
    _build.kernels()
    say(f"  built route={_build.build_route()} in {time.time() - t0:.1f}s")

    say("== 3. kernels against their plain versions")
    bf16, f32 = torch.bfloat16, torch.float32
    errs = kernel_case(fa, B, T, HQ, HQ, D, True, bf16)  # the main path's shape
    kernel_case(fa, B, T, HQ, HQ, D, False, bf16)
    kernel_case(fa, B, T, HQ, 8, D, True, bf16)       # GQA
    kernel_case(fa, B, 2000, HQ, HQ, D, True, bf16)   # ragged T
    kernel_case(fa, B, T, HQ, HQ, D, True, f32)
    kernel_case(fa, B, 1024, 16, 4, 64, True, bf16, block_q=32, block_k=64)
    kernel_case(fa, B, 1000, 16, 16, 64, False, f32, block_q=64, block_k=32)
    timing = time_kernels(fa, B, T, HQ, HQ, D, bf16)
    for name, row in timing.items():
        say(f"  {name}: " + " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                                     for k, v in row.items()))

    tmp = os.path.join(ROOT, ".smoke_run")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        fa.reset_launch_counts()
        say("== 4. train step (LLMTrainer.train)")
        trained = train_phase(tmp)
        say("== 5. client round (LLMClientTrainer)")
        client_phase(tmp, trained["adapters"])
        launches = dict(fa.launch_counts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = TRAIN_STEPS + ROUND_STEPS
    # per step and layer: the forward, its recompute under remat, one dQ, one dK/dV
    want = {"flash_fwd": 2 * N_LAYERS * steps, "flash_bwd_dq": N_LAYERS * steps,
            "flash_bwd_dkv": N_LAYERS * steps}
    say(f"  launches on the main path: {launches} (expected {want})")
    check(launches == want, f"launch counts {launches} != {want}")

    say("== 6. result")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errs[name], **timing[name]})
    say(f"  total {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
