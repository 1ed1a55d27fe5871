"""Where the time of one ResNet-56 client round goes, on one CUDA card.

    python -m fedml_tpu_torch.tools.profile_fedavg_round

The shape of chip_smoke.py's FedAvg phase: ResNet-56 at full width (855,770
params, f32, the port's default precision: TF32 convolutions, f32 matmuls)
on the CIFAR-10 surrogate in 16 hetero shards (alpha 0.5), batch 128, SGD lr
0.05, momentum 0.9, wd 5e-4. One client (the median shard, client 0: 755
examples, 6 steps) runs a warm-up round, then timed rounds on the host clock
(each ends in the trainer's read of its mean loss), then rounds whose
steps are enqueued without that read (the host's time to enqueue a step),
then one round under ``torch.profiler``, and last the fold of 16 copies of
its ``w_local`` under the profiler. Prints one JSON object: the card, the
round and step times, the host's enqueue time per step, the device's
kernel time by group (conv, cuDNN's layout transposes, GroupNorm, matmul,
elementwise, optimizer, and the fold's own), the device's busy share of the profiled round, the top
kernels and the host operators with the most time of their own (under the
profiler, which slows the host). Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import time

CLIENT, WARMUP_ROUNDS, TIMED_ROUNDS, FOLD_CLIENTS = 0, 1, 3, 16
ARGS = dict(random_seed=0, dataset="cifar10", data_cache_dir="", partition_method="hetero",
            partition_alpha=0.5, model="resnet56", client_num_in_total=16,
            client_num_per_round=16, epochs=1, batch_size=128, client_optimizer="sgd",
            learning_rate=0.05, momentum=0.9, weight_decay=5e-4)


def group(name: str) -> str:
    """The kernel group of a CUDA kernel's name."""
    low = name.lower()
    if any(s in low for s in ("group_norm", "groupnorm", "rowwisemoments", "computefusedparams",
                              "gammabeta", "computeinternalgradients",
                              "computebackwardfusedparams", "compute1dbackward")):
        return "group_norm"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "conv_layout"  # cuDNN's transposes around its NHWC tensor-core kernels
    if any(s in low for s in ("conv", "implicit", "winograd", "dgrad", "wgrad", "fprop",
                              "cudnn", "fft", "cf32", "nchw", "nhwc")):
        return "conv"
    if any(s in low for s in ("gemm", "gemv", "cublas", "nvjet", "cutlass")):
        return "matmul"
    if any(s in low for s in ("multi_tensor", "foreach")):
        return "optimizer"
    return "elementwise"


def _device_ms(prof) -> dict:
    import torch

    by_kernel: dict = {}
    for ev in prof.key_averages():
        # a record_function range (the optimizer's "Optimizer.step#SGD.step")
        # also shows as device time: the sum of the kernels it holds
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False) or "#" in ev.key):
            continue
        by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + (
            getattr(ev, "self_device_time_total", 0) or 0) / 1e3
    return by_kernel


def _host_ms(prof, top: int = 12) -> dict:
    """The host's own time (self CPU ms) of the profiled window's busiest
    operators."""
    import torch

    rows = [(ev.key, ev.self_cpu_time_total / 1e3, ev.count) for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CPU]
    return {name[:60]: {"ms": ms, "calls": n} for name, ms, n in
            sorted(rows, key=lambda r: -r[1])[:top]}


def main() -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import fedml_tpu_torch as fedml
    from ..core.aggregation.bucketed import get_engine
    from ..ml.trainer.classification_trainer import ClassificationTrainer
    from ..ml.trainer.local_sgd import epoch_index_array

    args = fedml.init(fedml.default_config("simulation", **ARGS))
    dev = fedml.get_device(args)
    dataset, output_dim = fedml.data.load(args)
    model = fedml.model.create(args, output_dim, device=dev)
    shard = dataset[5][CLIENT]
    trainer = ClassificationTrainer(model, args)
    trainer.set_id(CLIENT)
    w0 = trainer.get_model_params()

    def round_once():
        trainer.set_model_params(w0)
        trainer.train(shard)

    t0 = time.perf_counter()
    for _ in range(WARMUP_ROUNDS):
        round_once()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    steps = trainer.last_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_ROUNDS):
        round_once()
    torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / TIMED_ROUNDS

    # the same steps, enqueued without the round's closing read of its loss
    idx, mask = epoch_index_array(len(shard), args.batch_size, args.epochs, 0)
    x_all = torch.from_numpy(np.ascontiguousarray(shard.x)).to(dev)
    y_all = torch.from_numpy(np.ascontiguousarray(shard.y)).to(dev)
    rng = torch.Generator(device=dev).manual_seed(0)
    enqueue_s = unsynced_round_s = 0.0
    for _ in range(TIMED_ROUNDS):
        trainer.set_model_params(w0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._local_train(x_all, y_all, idx, mask, rng, None)
        enqueue_s += (time.perf_counter() - t0) / TIMED_ROUNDS
        torch.cuda.synchronize()
        unsynced_round_s += (time.perf_counter() - t0) / TIMED_ROUNDS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        round_once()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    by_kernel = _device_ms(prof)
    groups: dict = {}
    for name, ms in by_kernel.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    device_ms = sum(by_kernel.values())

    w_local = trainer.get_model_params()
    pairs = [(float(len(shard)), {k: v.clone() for k, v in w_local.items()})
             for _ in range(FOLD_CLIENTS)]
    engine = get_engine()
    engine.aggregate(pairs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as fprof:
        t0 = time.perf_counter()
        engine.aggregate(pairs)
        torch.cuda.synchronize()
        fold_s = time.perf_counter() - t0
    fold_device_ms = sum(_device_ms(fprof).values())

    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    measured = device_ms > 0
    print(json.dumps({
        "card": card,
        "shape": {"model": "resnet56", "params": model.num_params, "client": CLIENT,
                  "examples": len(shard), "batch": args.batch_size, "steps": steps},
        "precision": {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32},
        "warmup_round_s": warm_s,
        "round_ms": round_s * 1e3, "step_ms": round_s * 1e3 / steps,
        "host_enqueue_ms_per_step": enqueue_s * 1e3 / steps,
        "unsynced_round_ms": unsynced_round_s * 1e3,
        "profiled_round_ms": window_s * 1e3,
        "device_ms_by_group": groups if measured else "not measured",
        "device_ms_per_step": device_ms / steps if measured else "not measured",
        "device_busy_share": device_ms / (window_s * 1e3) if measured else "not measured",
        "device_busy_share_of_timed_round": (device_ms / (round_s * 1e3) if measured
                                             else "not measured"),
        "fold": {"clients": FOLD_CLIENTS, "host_ms": fold_s * 1e3,
                 "device_ms": fold_device_ms if fold_device_ms else "not measured"},
        "top_kernels_ms": {name[:90]: ms for name, ms in top},
        "top_host_ops_ms": _host_ms(prof),
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
    }, indent=1))


if __name__ == "__main__":
    main()
