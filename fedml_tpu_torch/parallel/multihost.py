"""Several processes in one silo: counterpart of ``fedml_tpu/parallel/multihost.py``.

Reference: the hierarchical cross-silo client spawns N torchrun ranks per
silo; rank 0 talks WAN and syncs round metadata to the other ranks with
``dist.broadcast_object_list`` (``cross_silo/client/fedml_client_master_manager.py:67,200-212``,
``fedml_client_slave_manager.py``). The JAX package joins a pod slice's
processes with ``jax.distributed`` and broadcasts over ICI/DCN. Here the
silo's processes are the ranks of one ``torch.distributed`` process group,
and exactly one process (rank 0) opens the WAN connection.

**The collective backend.** NCCL when every rank of the group has a card of
its own (the process computes on CUDA and ``num_processes`` is at most
``torch.cuda.device_count()``); gloo otherwise: when ranks share a card
(NCCL refuses two ranks on one device), and on the CPU. The choice is
logged and kept (:func:`backend`). Under gloo the tensors stay on the card:
gloo's CUDA broadcast and all-reduce copy through host memory inside the
library, and nothing here moves a tensor to the CPU to call them. On the
H100 with torch 2.11, gloo takes CUDA tensors in broadcast, all-reduce,
all-gather and reduce-scatter, and fails send and recv: the ring shift
(:func:`ppermute`) therefore stages a CUDA tensor through host memory under
gloo, and is ``batch_isend_irecv`` under NCCL.

**The LLM mesh's collectives** (``all_gather``, ``reduce_scatter``,
``all_reduce``, ``ppermute``) run over a sub-group of the mesh
(``parallel/mesh.py`` ``RankMesh.group``), and the autograd functions at
the end of this module give the sharded step (``parallel/fsdp.py``) the
differentiable forms it needs: copy into a group (all-reduce in the
backward), reduce out of one, an all-reduce whose backward is one too,
gather shards (reduce-scatter or take the own shard in the backward) and
slice out the own part (all-gather in the backward).

**Devices.** Rank r computes on ``cuda:(r % torch.cuda.device_count())``
unless the caller asks for the CPU, and sets that device before its first
collective.

Every collective of this module is counted by op (calls and payload bytes
each rank sent or received, :func:`collective_stats`), so a round's traffic
can be read without a profiler.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

_MAX_META_BYTES = 1 << 16

# the process group's shape, once init_distributed has joined one
_STATE: Dict[str, Any] = {"initialized": False, "backend": None, "device": None}
_STATS: Dict[str, Dict[str, int]] = {}
_STATS_LOCK = threading.Lock()


def collective_backend(num_processes: int, device: torch.device,
                       device_count: Optional[int] = None) -> str:
    """The rule of the module docstring: ``"nccl"`` when ``device`` is CUDA
    and each of the ``num_processes`` ranks has a card of its own, else
    ``"gloo"``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    if device_count is None:
        device_count = torch.cuda.device_count()
    return "nccl" if num_processes <= device_count else "gloo"


def rank_device(rank: int, device: Any = None) -> torch.device:
    """The device rank ``rank`` computes on: the CPU when ``device`` names
    it, else ``cuda:(rank % device_count)`` (raising without CUDA)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    from ..device import resolve_device

    return resolve_device(f"cuda:{int(rank) % max(1, torch.cuda.device_count())}")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Any = None,
) -> bool:
    """Join this process to its silo's process group.

    Arguments fall back to the environment the launcher exports, the JAX
    package's names: ``FEDML_COORDINATOR_ADDRESS`` (``host:port`` of rank
    0's rendezvous), ``FEDML_NUM_PROCESSES``, ``FEDML_PROCESS_ID``. Returns
    False, and does nothing, for one process or without an address.
    ``device="cpu"`` keeps the rank on the CPU. Idempotent: a later call
    returns True."""
    if _STATE["initialized"]:
        return True
    coordinator_address = coordinator_address or os.environ.get("FEDML_COORDINATOR_ADDRESS")
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("FEDML_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("FEDML_PROCESS_ID", "0"))
    if not coordinator_address or num_processes <= 1:
        return False

    import torch.distributed as dist

    dev = rank_device(process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = collective_backend(num_processes, dev)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id))
    _STATE.update(initialized=True, backend=backend, device=dev)
    log.info("process group up: rank %d/%d on %s over %s via %s (%s)", process_id,
             num_processes, dev, backend, url,
             "a card a rank" if backend == "nccl" else
             "ranks share a card" if dev.type == "cuda" else "on the CPU")
    return True


def shutdown_distributed() -> None:
    """Leave the process group: a barrier (no rank tears its links down
    under a peer still reading the last broadcast), then destroy it."""
    if not _STATE["initialized"]:
        return
    import torch.distributed as dist

    try:
        sync_process_group()
    finally:
        dist.destroy_process_group()
        _STATE.update(initialized=False, backend=None, device=None)


def is_initialized() -> bool:
    return bool(_STATE["initialized"])


def backend() -> Optional[str]:
    """The backend the process group runs on (None without one)."""
    return _STATE["backend"]


def process_device() -> torch.device:
    """The device this rank computes on (the CPU without a process group)."""
    return _STATE["device"] if _STATE["initialized"] else torch.device("cpu")


def is_main_process() -> bool:
    """True on exactly one process of the silo: the only WAN talker
    (reference fedml_client_master_manager.py:67-70 rank-0 gating)."""
    return process_index() == 0


def process_index() -> int:
    if not _STATE["initialized"]:
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def process_count() -> int:
    if not _STATE["initialized"]:
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


# --- counted collectives -------------------------------------------------------------

def _count(op: str, nbytes: int) -> None:
    with _STATS_LOCK:
        row = _STATS.setdefault(op, {"calls": 0, "bytes": 0})
        row["calls"] += 1
        row["bytes"] += int(nbytes)


def collective_stats() -> Dict[str, Dict[str, int]]:
    """``{op: {"calls", "bytes"}}`` since the process started: the payload
    bytes this rank sent (as the source) or received in each collective."""
    with _STATS_LOCK:
        return {k: dict(v) for k, v in _STATS.items()}


def broadcast_(tensor: torch.Tensor, src: int = 0, op: str = "broadcast", group=None) -> None:
    """In-place broadcast of ``tensor`` from ``src``, counted under ``op``."""
    import torch.distributed as dist

    dist.broadcast(tensor, src=src, group=group)
    _count(op, tensor.numel() * tensor.element_size())


def all_reduce_sum_(tensor: torch.Tensor, op: str = "all_reduce", group=None) -> None:
    """In-place sum of ``tensor`` over the group's ranks, counted under ``op``."""
    import torch.distributed as dist

    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    _count(op, tensor.numel() * tensor.element_size())


def broadcast_round_metadata(meta: Optional[Any], *, is_source: Optional[bool] = None) -> Any:
    """Broadcast a small JSON-serialisable object from the main process to
    every process of the silo (the reference's ``dist.broadcast_object_list``
    at fedml_client_master_manager.py:200-212). The JAX package's framing: a
    ``_MAX_META_BYTES`` uint8 buffer, a 4-byte length, then the JSON, on the
    rank's device. Other processes pass ``meta=None`` and receive the
    source's object; an object over the buffer raises ``ValueError``."""
    if process_count() <= 1:
        return meta
    if is_source is None:
        is_source = is_main_process()
    buf = np.zeros(_MAX_META_BYTES, np.uint8)
    if is_source:
        raw = json.dumps(meta).encode()
        if len(raw) + 4 > _MAX_META_BYTES:
            raise ValueError(f"round metadata too large: {len(raw)} bytes")
        buf[:4] = np.frombuffer(np.uint32(len(raw)).tobytes(), np.uint8)
        buf[4: 4 + len(raw)] = np.frombuffer(raw, np.uint8)
    t = torch.from_numpy(buf).to(process_device())
    broadcast_(t, op="broadcast_round_metadata")
    out = t.cpu().numpy()
    n = int(np.frombuffer(out[:4].tobytes(), np.uint32)[0])
    return json.loads(out[4: 4 + n].tobytes().decode())


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree
    else:
        raise TypeError(f"broadcast_model_params: leaf {'/'.join(map(str, prefix))} is a "
                        f"{type(tree).__name__}, not a tensor")


def _rebuild(tree, values, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (k,)) for k, v in tree.items()}
    return values[prefix]


def broadcast_model_params(params, *, is_source: Optional[bool] = None):
    """Broadcast the global model (a state dict, nested dicts allowed) from
    the main process to every process of the silo. Every leaf travels,
    buffers and integer leaves included, in one flat buffer a dtype on the
    rank's device; other processes pass their current params (the same keys
    and shapes) and receive the source's values, on their own devices, in
    new tensors. The source gets its own params back."""
    if process_count() <= 1:
        return params
    if is_source is None:
        is_source = is_main_process()
    dev = process_device()
    leaves = list(_leaves(params))
    by_dtype: Dict[torch.dtype, list] = {}
    for path, leaf in leaves:
        by_dtype.setdefault(leaf.dtype, []).append((path, leaf))
    got = {}
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        if is_source:
            flat = torch.cat([leaf.detach().reshape(-1).to(dev) for _, leaf in group])
        else:
            flat = torch.empty(sum(leaf.numel() for _, leaf in group), dtype=dtype, device=dev)
        broadcast_(flat, op="broadcast_model_params")
        if is_source:
            continue
        for (path, leaf), part in zip(group, flat.split([leaf.numel() for _, leaf in group])):
            got[path] = part.view(leaf.shape)
    return params if is_source else _rebuild(params, got)


def sync_process_group() -> None:
    """Barrier across the silo's processes (reference sync_process_group)."""
    if process_count() > 1:
        import torch.distributed as dist

        if backend() == "nccl":
            dist.barrier(device_ids=[process_device().index])
        else:
            dist.barrier()
        _count("barrier", 0)


# --- the mesh's collectives (counted) ------------------------------------------------

def _group_size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


def all_reduce(tensor: torch.Tensor, group, op: str = "all_reduce") -> torch.Tensor:
    """The sum of ``tensor`` over ``group``, in a new tensor."""
    out = tensor.detach().clone().contiguous()
    all_reduce_sum_(out, op=op, group=group)
    return out


def all_gather(tensor: torch.Tensor, group, op: str = "all_gather") -> list:
    """Every member's ``tensor`` (same shape), in the group's rank order."""
    import torch.distributed as dist

    t = tensor.detach().contiguous()
    out = [torch.empty_like(t) for _ in range(_group_size(group))]
    dist.all_gather(out, t, group=group)
    _count(op, t.numel() * t.element_size() * len(out))
    return out


def reduce_scatter(tensor: torch.Tensor, group, dim: int, op: str = "reduce_scatter"
                   ) -> torch.Tensor:
    """This member's equal part along ``dim`` of the sum of ``tensor`` over
    the group."""
    import torch.distributed as dist

    n = _group_size(group)
    parts = [p.contiguous() for p in tensor.detach().chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    _count(op, tensor.numel() * tensor.element_size())
    return out


def ppermute(tensor: torch.Tensor, pairs, group, op: str = "ring_shift") -> torch.Tensor:
    """``jax.lax.ppermute`` over ``group``: ``pairs`` lists (source, dest)
    positions in the group's rank order, a bijection over the members;
    returns what this member receives (its own tensor where it is its own
    destination). Under NCCL one ``batch_isend_irecv``; under gloo a CUDA
    tensor is staged through host memory (gloo's CUDA send/recv fail)."""
    import torch.distributed as dist

    me = dist.get_rank(group)
    dest = dict(pairs)
    src = {d: s for s, d in pairs}
    t = tensor.detach().contiguous()
    if dest[me] == me:
        return t.clone()
    staged = t.is_cuda and dist.get_backend(group) != "nccl"
    send = t.cpu() if staged else t
    recv = torch.empty_like(send)
    to = dist.get_global_rank(group, dest[me])
    frm = dist.get_global_rank(group, src[me])
    ops = [dist.P2POp(dist.isend, send, to, group=group),
           dist.P2POp(dist.irecv, recv, frm, group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _count(op, t.numel() * t.element_size())
    return recv.to(t.device, non_blocking=False) if staged else recv


# --- differentiable forms --------------------------------------------------------------

class CopyToGroup(torch.autograd.Function):
    """Identity forward; all-reduce (sum) of the gradient over ``group``:
    the input of a computation the group's members split (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op = group, op
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, ctx.op + "_bwd"), None, None


class ReduceFromGroup(torch.autograd.Function):
    """All-reduce (sum) forward of the members' partial results; identity
    backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group, op):
        return all_reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class AllReduceSum(torch.autograd.Function):
    """The sum over ``group`` of each member's part of a quantity every
    member then uses (the global MoE expert inputs, the aux statistics):
    all-reduce forward, all-reduce of the members' partial gradients
    backward."""

    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op = group, op
        return all_reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, ctx.op + "_bwd"), None, None


class GatherShards(torch.autograd.Function):
    """A parameter's shards along ``dim`` over ``group``, concatenated.
    Backward: ``reduce=True`` (the members computed on different data)
    reduce-scatters the gradient, summing the members' parts; ``False``
    (they computed the same thing) takes this member's part."""

    @staticmethod
    def forward(ctx, x, group, dim, reduce, op):
        ctx.group, ctx.dim, ctx.reduce, ctx.op = group, dim, reduce, op
        return torch.cat(all_gather(x, group, op), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return reduce_scatter(g, ctx.group, ctx.dim, ctx.op + "_bwd"), None, None, None, None
        import torch.distributed as dist

        part = g.chunk(_group_size(ctx.group), dim=ctx.dim)[dist.get_rank(ctx.group)]
        return part.contiguous(), None, None, None, None


class SliceForGroup(torch.autograd.Function):
    """This member's equal part of a replicated tensor along ``dim``;
    backward all-gathers the members' gradients of their parts, so every
    member ends with the whole (and the same) gradient."""

    @staticmethod
    def forward(ctx, x, group, dim, op):
        import torch.distributed as dist

        ctx.group, ctx.dim, ctx.op = group, dim, op
        return x.chunk(_group_size(group), dim=dim)[dist.get_rank(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(all_gather(g, ctx.group, ctx.op + "_bwd"), dim=ctx.dim), None, None, None
