"""Where the time of one ResNet-56 round goes, on one CUDA card: a client
round of the sp simulator, or a round of the vmapped one.

    python -m fedml_tpu_torch.tools.profile_fedavg_round [--backend sp|vmap]

The shape of chip_smoke.py's FedAvg phases: ResNet-56 at full width (855,770
params, f32, the port's default precision: TF32 convolutions, f32 matmuls)
on the CIFAR-10 surrogate in 16 hetero shards (alpha 0.5), batch 128, SGD lr
0.05, momentum 0.9, wd 5e-4.

``--backend sp`` (the default): one client (the median shard, client 0: 755
examples, 6 steps) runs a warm-up round, then timed rounds on the host clock
(each ends in the trainer's read of its mean loss), then rounds whose steps
are enqueued without that read (the host's time to enqueue a step), then one
round under ``torch.profiler``, and last the fold of 16 copies of its
``w_local`` under the profiler.

``--backend vmap``: the 16 clients' shards are staged on the card once (the
staging timed), then the client-batched local round of all 16 runs
(``ceil(989/128) = 8`` batched steps of 16 x 128 images) with the stacked
fold: a warm-up round, timed rounds on the host clock (each ends in a
synchronize), rounds enqueued without one, one round under the profiler, and
the stacked fold of its ``[16, P]`` result under the profiler. Every
convolution of the vmapped step has per-client weights, which vmap turns into
one grouped convolution (``groups=16``); their kernels are the group
``grouped_conv``.

Prints one JSON object: the card, the round and step times, the host's
enqueue time per step, the device's kernel time by group (conv, cuDNN's
layout transposes, GroupNorm, matmul, elementwise, optimizer, and the fold's
own), kernel launches a step, the device's busy share of the profiled round,
the top kernels and the host operators with the most time of their own
(under the profiler, which slows the host). Run each backend in a process of
its own. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

CLIENT, WARMUP_ROUNDS, TIMED_ROUNDS, FOLD_CLIENTS = 0, 1, 3, 16
ARGS = dict(random_seed=0, dataset="cifar10", data_cache_dir="", partition_method="hetero",
            partition_alpha=0.5, model="resnet56", client_num_in_total=16,
            client_num_per_round=16, epochs=1, batch_size=128, client_optimizer="sgd",
            learning_rate=0.05, momentum=0.9, weight_decay=5e-4)


def group(name: str, grouped: bool = False) -> str:
    """The kernel group of a CUDA kernel's name; ``grouped`` names the
    convolutions of a vmapped step (all grouped) as such."""
    low = name.lower()
    if any(s in low for s in ("group_norm", "groupnorm", "rowwisemoments", "computefusedparams",
                              "gammabeta", "computeinternalgradients",
                              "computebackwardfusedparams", "compute1dbackward")):
        return "group_norm"
    conv = "grouped_conv" if grouped else "conv"
    if any(s in low for s in ("nchwtonhwc", "nhwctonchw", "generictranspose")):
        return conv + "_layout"  # cuDNN's transposes around its NHWC tensor-core kernels
    if any(s in low for s in ("conv", "implicit", "winograd", "dgrad", "wgrad", "fprop",
                              "cudnn", "fft", "cf32", "nchw", "nhwc")):
        return conv
    if any(s in low for s in ("gemm", "gemv", "cublas", "nvjet", "cutlass")):
        return "matmul"
    if any(s in low for s in ("multi_tensor", "foreach")):
        return "optimizer"
    return "elementwise"


def _kernels(prof):
    """The profiled window's CUDA kernels (``key_averages`` rows)."""
    import torch

    for ev in prof.key_averages():
        # a record_function range (the optimizer's "Optimizer.step#SGD.step")
        # also shows as device time: the sum of the kernels it holds
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False) and "#" not in ev.key):
            yield ev


def _device_ms(prof) -> dict:
    by_kernel: dict = {}
    for ev in _kernels(prof):
        by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + (
            getattr(ev, "self_device_time_total", 0) or 0) / 1e3
    return by_kernel


def _launches(prof) -> int:
    return sum(ev.count for ev in _kernels(prof))


def _host_ms(prof, top: int = 12) -> dict:
    """The host's own time (self CPU ms) of the profiled window's busiest
    operators."""
    import torch

    rows = [(ev.key, ev.self_cpu_time_total / 1e3, ev.count) for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CPU]
    return {name[:60]: {"ms": ms, "calls": n} for name, ms, n in
            sorted(rows, key=lambda r: -r[1])[:top]}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def sp_round() -> None:
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
    launches = _launches(prof)

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
    card = _card()
    measured = device_ms > 0
    print(json.dumps({
        "backend": "sp",
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
        "launches_per_step": launches / steps if measured else "not measured",
        "device_busy_share": device_ms / (window_s * 1e3) if measured else "not measured",
        "device_busy_share_of_timed_round": (device_ms / (round_s * 1e3) if measured
                                             else "not measured"),
        "fold": {"clients": FOLD_CLIENTS, "host_ms": fold_s * 1e3,
                 "device_ms": fold_device_ms if fold_device_ms else "not measured"},
        "top_kernels_ms": {name[:90]: ms for name, ms in top},
        "top_host_ops_ms": _host_ms(prof),
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
    }, indent=1))



def vmap_round() -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import fedml_tpu_torch as fedml
    from ..core.aggregation.bucketed import get_engine
    from ..simulation.vmapped.vmap_fedavg import VmapFedAvgAPI

    args = fedml.init(fedml.default_config("simulation", backend="vmap", **ARGS))
    dev = fedml.get_device(args)
    dataset, output_dim = fedml.data.load(args)
    model = fedml.model.create(args, output_dim, device=dev)
    api = VmapFedAvgAPI(args, dev, dataset, model)
    cohort = list(range(args.client_num_per_round))
    engine = get_engine()
    counts = np.asarray([dataset[4][c] for c in cohort], np.float32)
    weights = counts / counts.sum()
    w0 = model.params

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, y, idx, mask = api._stack_clients(cohort)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    steps = idx.shape[1] * idx.shape[2]
    images = sum(len(dataset[5][c]) for c in cohort) * args.epochs

    def round_once():
        result = api._vmapped_train(w0, x, y, idx, mask, 0)
        return engine.aggregate_stacked(result.params, weights)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(WARMUP_ROUNDS):
        round_once()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TIMED_ROUNDS):
        round_once()
    torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / TIMED_ROUNDS

    # the local rounds alone, enqueued without a synchronize
    enqueue_s = unsynced_s = 0.0
    for _ in range(TIMED_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = api._vmapped_train(w0, x, y, idx, mask, 0)
        enqueue_s += (time.perf_counter() - t0) / TIMED_ROUNDS
        torch.cuda.synchronize()
        unsynced_s += (time.perf_counter() - t0) / TIMED_ROUNDS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = api._vmapped_train(w0, x, y, idx, mask, 0)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    by_kernel = _device_ms(prof)
    groups: dict = {}
    for name, ms in by_kernel.items():
        groups[group(name, grouped=True)] = groups.get(group(name, grouped=True), 0.0) + ms
    device_ms = sum(by_kernel.values())
    launches = _launches(prof)

    engine.aggregate_stacked(result.params, weights)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as fprof:
        t0 = time.perf_counter()
        engine.aggregate_stacked(result.params, weights)
        torch.cuda.synchronize()
        fold_s = time.perf_counter() - t0
    fold_device_ms = sum(_device_ms(fprof).values())

    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    measured = device_ms > 0
    print(json.dumps({
        "backend": "vmap",
        "card": _card(),
        "shape": {"model": "resnet56", "params": model.num_params, "clients": len(cohort),
                  "batch": args.batch_size, "batched_steps": steps, "images": images,
                  "stacked_shard_MB": x.numel() * x.element_size() / 1e6},
        "precision": {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32},
        "stage_ms": stage_s * 1e3,
        "warmup_round_s": warm_s,
        "round_ms": round_s * 1e3, "step_ms": round_s * 1e3 / steps,
        "images_per_s": images / round_s,
        "host_enqueue_ms_per_step": enqueue_s * 1e3 / steps,
        "unsynced_local_round_ms": unsynced_s * 1e3,
        "profiled_local_round_ms": window_s * 1e3,
        "device_ms_by_group": groups if measured else "not measured",
        "device_ms_per_step": device_ms / steps if measured else "not measured",
        "launches_per_step": launches / steps if measured else "not measured",
        "device_busy_share": device_ms / (window_s * 1e3) if measured else "not measured",
        "fold": {"clients": len(cohort), "host_ms": fold_s * 1e3,
                 "device_ms": fold_device_ms if fold_device_ms else "not measured"},
        "top_kernels_ms": {name[:90]: ms for name, ms in top},
        "top_host_ops_ms": _host_ms(prof),
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
    }, indent=1))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--backend", choices=("sp", "vmap"), default="sp")
    {"sp": sp_round, "vmap": vmap_round}[parser.parse_args().backend]()


if __name__ == "__main__":
    main()
