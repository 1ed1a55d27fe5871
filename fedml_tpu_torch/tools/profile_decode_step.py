"""Where the time of one serving decode step goes, on one CUDA card.

    python -m fedml_tpu_torch.tools.profile_decode_step

Builds the decode model of chip_smoke.py's serve phase (Llama-2-7B, 32
layers, bf16 weights drawn from a seed, ``max_seq_len`` 4096) and times one
single-token decode step in the two modes the serving entry points run:
``contiguous`` (``generate`` / ``generate_batch``: a shared write index)
at B=1 and B=8, and ``slot`` (the slot engine's per-row ``cache_idx``) at
B=8, each row about 300 tokens into its cache (every step reads the whole
4096-slot cache under a mask, so the context does not change its cost).
For each: the steady step on the host clock with a synchronize at each
end, the host's time to enqueue a step, and ``torch.profiler``'s device
time of the profiled steps grouped (matmuls, copies, the rest) and by
kernel, with the device's busy share of a steady step. Prints one JSON
object. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import time

CONTEXT = 300  # tokens already in each row's cache
TIMED_STEPS, PROFILED_STEPS = 10, 3


def _group(name: str) -> str:
    low = name.lower()
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet", "gemv")):
        return "matmul"
    if "copy" in low:
        return "copy"
    return "other"


def _profile(step) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        step()
    enqueue_s = (time.perf_counter() - t0) / TIMED_STEPS
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            step()
        torch.cuda.synchronize()
    groups: dict = {}
    by_kernel: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = (getattr(ev, "self_device_time_total", 0) or 0) / 1e3 / PROFILED_STEPS
        groups[_group(ev.key)] = groups.get(_group(ev.key), 0.0) + ms
        by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + ms
    kernel_ms = sum(groups.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "steady_step_ms": step_s * 1e3,
        "host_enqueue_ms_per_step": enqueue_s * 1e3,
        "device_ms_per_step_by_group": groups if kernel_ms else "not measured",
        "device_ms_per_step": kernel_ms if kernel_ms else "not measured",
        "device_busy_share_of_steady_step": (kernel_ms / (step_s * 1e3)
                                             if kernel_ms else "not measured"),
        "top_kernels_ms_per_step": {name[:90]: ms for name, ms in top},
    }


def main() -> None:
    import torch

    from ..models.transformer import TransformerConfig, init_cache
    from ..train.llm.generation import decode_model

    cfg = TransformerConfig.llama2_7b(dtype=torch.bfloat16, remat=False)
    model = decode_model(cfg, None, device="cuda")
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        "model": "llama2_7b, 32 layers, bf16, max_seq_len 4096", "context": CONTEXT}
    with torch.inference_mode():
        for mode, b in (("contiguous", 1), ("contiguous", 8), ("slot", 8)):
            cache = init_cache(model.cfg, b, "cuda")
            tok = torch.zeros((b, 1), dtype=torch.long, device="cuda")
            idx = torch.full((b,), CONTEXT, device="cuda")
            for layer in cache.values():
                layer["attn"]["idx"].fill_(CONTEXT)

            def step():
                # the contiguous mode advances its write index each step; both
                # modes read the whole max_seq_len cache under a mask
                model(tok, idx[:, None], cache_idx=idx if mode == "slot" else None,
                      cache=cache)
            out[f"{mode}_b{b}"] = _profile(step)
            del cache
            torch.cuda.empty_cache()
    out["peak_mem_GB"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
