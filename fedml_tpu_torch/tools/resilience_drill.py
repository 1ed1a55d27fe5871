"""The SIGKILL drills of durable round state, one process a run.

    python -m fedml_tpu_torch.tools.resilience_drill DRILL MODE DIR \\
        [--device cuda|cpu] [--model lr|resnet20] [--report FILE]

``DRILL`` is one of three federations, each with its round store in ``DIR``
(``resilience_dir``):

- ``sp``: the sp simulator through ``FedMLRunner``;
- ``cs``: a cross-silo federation over INMEMORY, the server and its silos as
  threads of this process, the store on the server;
- ``cs_async``: the same front in async mode with one silo (so the arrival
  order is total), a publish every 2 merges and a buffer snapshot after
  every merge (``async_checkpoint_every_merges`` 1).

``MODE``: ``baseline`` runs to the end; ``crash`` sets the SIGKILL drill
(``chaos_kill_after_round`` 1, or for ``cs_async`` ``chaos_kill_after_merges``
3, the first merge of the second window, whose snapshot is committed before
the kill), so the process dies by SIGKILL (exit -9 or 137) with a complete
round short of the end in its store; ``resume`` restarts with ``resume`` set
and runs to the end. The resumed run's final round state is then bit-equal
to the baseline's (:func:`final_state` reads a store, :func:`bit_equal`
compares two).

``--model lr`` (the default) is the JAX package's drills (``tests/
_resilience_sp_run.py``, ``_resilience_cs_cluster.py``, ``_async_buffer_run.py``):
LR on the synthetic set; ``sp`` 4 clients, 2 a round, 4 rounds; ``cs`` 3
silos, 4 rounds; ``cs_async`` 3 publishes. ``--model resnet20`` is
ResNet-56's widths at ResNet-20's depth on the CIFAR-10 surrogate (batch
128, SGD lr 0.05, momentum 0.9, wd 5e-4): ``sp`` 16 clients all in every
round under FedOpt (Adam, server lr 1e-3, so a server state is persisted),
3 rounds; ``cs`` 4 silos, 3 rounds; ``cs_async`` 3 publishes.

Every run is deterministic: ``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA
initialises, cuDNN deterministic without autotuning, TF32 off and
``torch.use_deterministic_algorithms(True)``. The run is on the card
(``--device cuda``, the default) and fails where there is none (the entry
points refuse); ``--device cpu`` asks for the CPU. ``--report`` writes a JSON
report: each round-state save (step, wait, milliseconds with the card waited
for before and after, dropped or not), the ``checkpoint_save_seconds``
histogram and ``checkpoint.dropped`` counter, the bytes of the newest step
file and its sidecar, and the wall-clock time at ``main`` and at the end of
the first save (the first round this process completed).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

DRILLS = ("sp", "cs", "cs_async")
MODES = ("baseline", "crash", "resume")
KILL_AFTER_ROUND = 1
KILL_AFTER_MERGES = 3   # first merge of window v1: the buffer holds one pending arrival
PARTY_TIMEOUT_S = 600

_LR = dict(model="lr", dataset="synthetic", random_seed=0, epochs=1, batch_size=16)
_RESNET20 = dict(model="resnet20", dataset="cifar10", data_cache_dir="", random_seed=0,
                 partition_method="hetero", partition_alpha=0.5, epochs=1, batch_size=128,
                 client_optimizer="sgd", learning_rate=0.05, momentum=0.9, weight_decay=5e-4)
# (drill, model) -> the federation's knobs
CONFIGS: Dict[tuple, Dict[str, Any]] = {
    ("sp", "lr"): dict(_LR, comm_round=4, client_num_in_total=4, client_num_per_round=2),
    ("cs", "lr"): dict(_LR, comm_round=4, client_num_in_total=3, client_num_per_round=3),
    ("cs_async", "lr"): dict(_LR, comm_round=3, client_num_in_total=1, client_num_per_round=1),
    ("sp", "resnet20"): dict(_RESNET20, comm_round=3, client_num_in_total=16,
                             client_num_per_round=16, federated_optimizer="FedOpt",
                             server_optimizer="adam", server_lr=1e-3),
    ("cs", "resnet20"): dict(_RESNET20, comm_round=3, client_num_in_total=4,
                             client_num_per_round=4),
    ("cs_async", "resnet20"): dict(_RESNET20, comm_round=3, client_num_in_total=1,
                                   client_num_per_round=1),
}
_ASYNC = dict(async_rounds=True, async_publish_k=2, async_staleness_exponent=0.5,
              async_max_staleness=10)


def deterministic() -> None:
    """The settings under which a resumed run replays its rounds bit for
    bit on the card; call before CUDA initialises."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)


def config(drill: str, mode: str, rdir: str, model: str) -> Dict[str, Any]:
    """The knobs of one run: the federation, the store, the drill."""
    over = dict(CONFIGS[(drill, model)], resilience_dir=rdir)
    over["frequency_of_the_test"] = over["comm_round"] + 1  # evaluate at the end only
    if drill == "cs_async":
        over.update(_ASYNC, async_checkpoint_every_merges=1)
    if mode == "crash" and drill == "cs_async":
        over["chaos_kill_after_merges"] = KILL_AFTER_MERGES
    elif mode == "crash":
        over["chaos_kill_after_round"] = KILL_AFTER_ROUND
    elif mode == "resume":
        over["resume"] = True
    return over


_SERVER_ONLY = ("resilience_dir", "resume", "chaos_kill_after_round", "chaos_kill_after_merges",
                "async_checkpoint_every_merges")


def _run_sp(over: Dict[str, Any], device: str) -> None:
    import fedml_tpu_torch as fedml

    args = fedml.init(fedml.default_config("simulation", backend="sp",
                                           using_gpu=device == "cuda", **over))
    dev = fedml.get_device(args)
    dataset, output_dim = fedml.data.load(args)
    model = fedml.model.create(args, output_dim)
    fedml.FedMLRunner(args, dev, dataset, model).run()


def _run_cross_silo(over: Dict[str, Any], device: str, run_id: str) -> None:
    """The server and every silo as threads of this process, each built
    through the entry points; the data is loaded once and handed to all."""
    import fedml_tpu_torch as fedml
    from fedml_tpu_torch.core.distributed.communication.inmemory.broker import InMemoryBroker

    InMemoryBroker.reset(run_id)
    runners, errors = {}, {}
    dataset = output_dim = None
    for rank in range(int(over["client_num_per_round"]) + 1):
        party = over if rank == 0 else {k: v for k, v in over.items() if k not in _SERVER_ONLY}
        args = fedml.init(fedml.default_config(
            "cross_silo", run_id=run_id, rank=rank, role="server" if rank == 0 else "client",
            backend="INMEMORY", using_gpu=device == "cuda", **party))
        dev = fedml.get_device(args)
        if dataset is None:
            dataset, output_dim = fedml.data.load(args)
        runners[rank] = fedml.FedMLRunner(args, dev, dataset, fedml.model.create(args, output_dim))

    def party(rank):
        try:
            runners[rank].run()
        except BaseException as e:  # noqa: BLE001 - reported below, then re-raised in the thread
            errors[rank] = repr(e)
            raise

    threads = [threading.Thread(target=party, args=(r,), daemon=True, name=f"party-{r}")
               for r in runners]
    for t in threads:
        t.start()
    deadline = time.monotonic() + PARTY_TIMEOUT_S
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            raise RuntimeError(f"{t.name} still running after {PARTY_TIMEOUT_S}s")
    if errors:
        raise RuntimeError(f"parties failed: {errors}")


class _SaveRecorder:
    """Times every round-state save of this process (the card waited for
    before and after, so the time is the enqueue's: the host snapshot, the
    sidecar and the thread start; or the whole write for ``wait=True``)."""

    def __init__(self, device: str):
        import torch

        from fedml_tpu_torch.core.resilience import RoundStateStore

        self.rows: List[Dict[str, Any]] = []
        self.first_save_unix: Optional[float] = None
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        orig = RoundStateStore.save_round
        recorder = self

        def timed(store, round_idx, state, **kw):
            sync()
            t0 = time.perf_counter()
            ok = orig(store, round_idx, state, **kw)
            sync()
            recorder.rows.append({"step": int(round_idx), "wait": bool(kw.get("wait", False)),
                                  "ms": (time.perf_counter() - t0) * 1e3, "saved": bool(ok)})
            if recorder.first_save_unix is None:
                recorder.first_save_unix = time.time()
            return ok

        RoundStateStore.save_round = timed


def final_state(rdir: str):
    """The newest complete round of the store in ``rdir`` (a ``RoundState``
    on the host)."""
    from fedml_tpu_torch.core.resilience import RoundStateStore

    store = RoundStateStore(rdir)
    try:
        return store.resume()
    finally:
        store.close()


def bit_equal(a: Any, b: Any) -> bool:
    """Two restored trees (nested dicts, lists, tensors, scalars) equal bit
    for bit and in structure."""
    import torch

    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(bit_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(bit_equal(x, y) for x, y in zip(a, b)))
    return a == b


def store_bytes(rdir: str) -> Dict[str, int]:
    """Bytes of the newest complete step file and its sidecar."""
    from fedml_tpu_torch.core.resilience import RoundStateStore
    from fedml_tpu_torch.core.resilience.round_state import META_PREFIX

    step = RoundStateStore(rdir).latest_complete_round()
    if step is None:
        return {}
    return {"step": int(step),
            "step_file": os.path.getsize(os.path.join(rdir, f"step_{step}.pt")),
            "sidecar": os.path.getsize(os.path.join(rdir, f"{META_PREFIX}{step}.json"))}


def main(argv: Optional[List[str]] = None) -> int:
    main_start_unix = time.time()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("drill", choices=DRILLS)
    p.add_argument("mode", choices=MODES)
    p.add_argument("dir")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--model", choices=("lr", "resnet20"), default="lr")
    p.add_argument("--report", default=None)
    a = p.parse_args(argv)
    deterministic()
    import torch

    from fedml_tpu_torch.core import telemetry as tel
    from fedml_tpu_torch.utils import checkpoint as ckpt_mod

    rdir = os.path.abspath(a.dir)
    recorder = _SaveRecorder(a.device)
    over = config(a.drill, a.mode, rdir, a.model)
    t0 = time.perf_counter()
    if a.drill == "sp":
        _run_sp(over, a.device)
    else:
        _run_cross_silo(over, a.device, run_id=f"drill_{a.drill}_{a.mode}")
    snap = tel.snapshot()
    report = {
        "drill": a.drill, "mode": a.mode, "model": a.model, "device": a.device,
        "card": torch.cuda.get_device_name(0) if a.device == "cuda" else None,
        "run_s": time.perf_counter() - t0,
        "saves": recorder.rows,
        "checkpoint_save_seconds": snap["histograms"].get(ckpt_mod.SAVE_SECONDS_HISTOGRAM),
        "checkpoint_dropped": snap["counters"].get(ckpt_mod.DROPPED_COUNTER, 0),
        "store_bytes": store_bytes(rdir),
        "main_start_unix": main_start_unix,
        "first_save_unix": recorder.first_save_unix,
    }
    if a.report:
        with open(a.report, "w") as f:
            json.dump(report, f)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
