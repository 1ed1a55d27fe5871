"""Where the time of one LoRA train step goes, on one CUDA card.

    python -m fedml_tpu_torch.tools.profile_train_step

Builds the LLMTrainer of chip_smoke.py (Llama-2-7B widths cut to 4 layers,
seq 2048, batch 2, LoRA rank 8 on q/k/v/o, bf16 compute), runs warm-up steps
through the
trainer's step function (each timed alone, after the kernels' build), then
times steady steps on the host clock with a synchronize at each end, and
profiles two more with ``torch.profiler``. Prints one JSON object: the card,
build and first-step times, steady step time and tokens/s, the host's time
to enqueue a steady step (the steps issue no synchronize, so a host that
needs about the whole step time to enqueue one is what bounds it), device
kernel time over the two profiled steps grouped (the three flash kernels,
matmuls, the rest) and by kernel, the device's busy share of the profiled
window (the profiler slows the host) and of a steady step, and the launches
per step.
Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import tempfile
import time

# the shape of chip_smoke.py's train phase
LAYERS, SEQ, BATCH = 4, 2048, 2
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 3, 5, 2


def _group(name: str) -> str:
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if kernel + "_kernel" in name:
            return kernel
    low = name.lower()
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet", "wgmma")):
        return "matmul"
    return "other"


def main() -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops import _build
    from ..ops import flash_attention as fa
    from ..train.llm.configurations import DatasetArguments, ExperimentArguments, ModelArguments
    from ..train.llm.llm_trainer import LLMTrainer

    ma = ModelArguments(vocab_size=32000, d_model=4096, n_layers=LAYERS, n_heads=32,
                        n_kv_heads=32, d_ff=11008, seq_len=SEQ, lora_rank=8, remat=True)
    with tempfile.TemporaryDirectory() as out_dir:  # the trainer's (unused) checkpoint dir
        ea = ExperimentArguments(max_steps=TIMED_STEPS, per_device_batch_size=BATCH,
                                 learning_rate=1e-4, warmup_steps=1, output_dir=out_dir)
        trainer = LLMTrainer(ma, DatasetArguments(), ea)
    trainer._build(trainer.init_params())
    rng = np.random.default_rng(0)

    def batch():
        toks = rng.integers(0, ma.vocab_size, (BATCH, SEQ), dtype=np.int32)
        return (torch.from_numpy(toks).to(trainer.device),
                torch.ones(BATCH, SEQ, device=trainer.device))

    t0 = time.perf_counter()
    _build.kernels()
    build_s = time.perf_counter() - t0
    warm_s = []
    for _ in range(WARMUP_STEPS):
        t0 = time.perf_counter()
        trainer._step_fn(*batch())
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)

    inputs = [batch() for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for toks, mask in inputs:
        trainer._step_fn(toks, mask)
    enqueue_s = (time.perf_counter() - t0) / TIMED_STEPS
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS

    fa.reset_launch_counts()
    inputs = [batch() for _ in range(PROFILED_STEPS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for toks, mask in inputs:
            trainer._step_fn(toks, mask)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    groups: dict = {}
    by_kernel: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = (getattr(ev, "self_device_time_total", 0) or 0) / 1e3
        groups[_group(ev.key)] = groups.get(_group(ev.key), 0.0) + ms
        by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    kernel_ms = sum(groups.values())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": card,
        "shape": {"layers": LAYERS, "seq": SEQ, "batch": BATCH},
        "build_s": build_s, "first_steps_s": warm_s,
        "steady_step_ms": step_s * 1e3,
        "steady_tokens_per_sec": BATCH * SEQ / step_s,
        "host_enqueue_ms_per_step": enqueue_s * 1e3,
        "profiled_steps": PROFILED_STEPS, "profiled_window_ms": window_s * 1e3,
        "device_ms_by_group": groups if kernel_ms else "not measured",
        "device_ms_per_step": kernel_ms / PROFILED_STEPS if kernel_ms else "not measured",
        "device_busy_share": kernel_ms / (window_s * 1e3) if kernel_ms else "not measured",
        "device_busy_share_of_steady_step": (kernel_ms / PROFILED_STEPS / (step_s * 1e3)
                                             if kernel_ms else "not measured"),
        "top_kernels_ms": {name[:90]: ms for name, ms in top},
        "launches_per_step": {k: v / PROFILED_STEPS for k, v in fa.launch_counts.items()},
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
    }, indent=1))


if __name__ == "__main__":
    main()
