"""The bucketed fold: counterpart of ``fedml_tpu/core/aggregation/bucketed.py``.

A weighted average over client state dicts, taken in fixed-size buckets of
clients: each bucket's state dicts are flattened to f32 rows, stacked
``[bucket, P]`` and contracted with the bucket's weights in one matrix-vector
product, and the products are summed in an f32 accumulator. Device memory
stays O(bucket x model) whatever the cohort's size. A ragged tail is padded
to the bucket's shape by repeating the last client with weight 0.0, as in
the JAX package. At the end the accumulator is cast back to each leaf's
dtype.

:meth:`BucketedAggregator.aggregate_stacked` is the vmapped front's fold: its
state dict's leaves already carry a leading client axis ``[K, ...]``, so it
flattens each leaf once to ``[K, n]``, concatenates them to ``[K, P]``, pads K
to a multiple of the bucket with zero rows of weight 0.0 and sums bucket by
bucket in f32.

Object leaves (the FHE ciphertexts of ``core/fhe/rlwe.py``) define their own
``+`` and ``* w`` and fold with them, leaf by leaf, as in the JAX package
(``bucketed.py:39-48``): the weights normalised in f32, each passed as
``float(w)``.

Modelwatch rides the fold (``watch=``, a ``WatchSession`` of
``core/telemetry/modelwatch.py``): each bucket's per-client
stat block is computed from the same ``[bucket, P]`` f32 chunk the bucket
contracts, on its device, and stays there until the session's publish-time
fetch, so a watched fold adds no host synchronisation and publishes the
same bits as an unwatched one (JAX ``bucketed.py:62-124``, ``:166-239``).
Object-leaf cohorts fold unwatched.

Not ported: the mesh-sharded engine (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry as tel

StateDict = Dict[str, torch.Tensor]

DEFAULT_BUCKET_SIZE = 16


def is_object_leaf(leaf) -> bool:
    return not isinstance(leaf, (torch.Tensor, np.ndarray, np.generic, float, int))


def _object_fold(trees: Sequence[StateDict], weights: np.ndarray) -> StateDict:
    """The fold with the leaves' own ``+`` and ``*`` (the FHE path)."""
    acc = {k: x * float(weights[0]) for k, x in trees[0].items()}
    for w, t in zip(weights[1:], trees[1:]):
        acc = {k: a + t[k] * float(w) for k, a in acc.items()}
    return acc


def flat_f32(tree: StateDict) -> torch.Tensor:
    # one cat (which promotes mixed dtypes) and at most one cast: a cast per
    # leaf costs the host a dispatch per leaf and client
    return torch.cat([v.reshape(-1) for v in tree.values()]).to(torch.float32)


class BucketedAggregator:
    """Streaming weighted average over client state dicts in buckets of
    ``bucket_size``. :meth:`aggregate` takes ``(weight, state dict)`` pairs
    and normalises the weights; :meth:`accumulate_bucket` and
    :meth:`finalize` are the raw steps."""

    # modelwatch's statistics ride this engine's fold
    supports_watch = True

    def __init__(self, bucket_size: int = DEFAULT_BUCKET_SIZE):
        if bucket_size < 1:
            raise ValueError(f"bucket_size must be >= 1, got {bucket_size}")
        self.bucket_size = int(bucket_size)

    def accumulate_bucket(self, acc: Optional[torch.Tensor], chunk: Sequence[StateDict],
                          weights, watch=None, watch_real=None) -> torch.Tensor:
        """``acc + sum_i weights[i] * flat(chunk[i])`` in f32 (a new
        accumulator when ``acc`` is None; else ``acc`` is updated in place).
        ``chunk`` holds exactly ``bucket_size`` state dicts.

        With a ``watch`` session the bucket's stat block (delta norms
        against ``watch.ref``, NaN/Inf counts) is computed from the same
        stacked chunk and kept on the device in the session;
        ``watch_real`` says how many of the chunk's rows are not padding."""
        if len(chunk) != self.bucket_size:
            raise ValueError(f"chunk has {len(chunk)} trees, bucket_size is {self.bucket_size}")
        for tree in chunk:
            bad = [k for k, v in tree.items() if not isinstance(v, torch.Tensor)]
            if bad:
                raise TypeError(
                    f"leaves {bad[:3]} are not tensors: object leaves (FHE ciphertexts) "
                    "fold through aggregate(), not the f32 bucket step")
        dev = next(iter(chunk[0].values())).device
        w = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
        with tel.span("agg.bucket", bucket_size=self.bucket_size, first=acc is None,
                      watched=watch is not None):
            flat = torch.stack([flat_f32(t) for t in chunk])
            part = w @ flat
            if watch is not None:
                watch.add_block(watch.block_from_flat(flat),
                                len(chunk) if watch_real is None else watch_real)
            if acc is None:
                return part
            return acc.add_(part)

    def finalize(self, acc: torch.Tensor, template: StateDict) -> StateDict:
        """Split the f32 accumulator into ``template``'s leaves, each cast
        back to its dtype."""
        with tel.span("agg.finalize"):
            out: StateDict = {}
            off = 0
            for name, leaf in template.items():
                n = leaf.numel()
                out[name] = acc[off:off + n].view(leaf.shape).to(leaf.dtype)
                off += n
            return out

    def aggregate(self, pairs: Sequence[Tuple[float, StateDict]], watch=None) -> StateDict:
        """Weighted average of ``(weight, state dict)`` pairs; weights
        normalised in f32, as the JAX engine does. A ``watch`` session rides
        the fold (object-leaf cohorts skip it)."""
        if not pairs:
            raise ValueError("aggregate() needs at least one (weight, tree) pair")
        weights = np.asarray([float(w) for w, _ in pairs], dtype=np.float32)
        weights = weights / weights.sum()
        trees = [t for _, t in pairs]
        if any(is_object_leaf(v) for v in trees[0].values()):
            with tel.span("agg.object_fold", k=len(trees)):
                return _object_fold(trees, weights)
        b = self.bucket_size
        with tel.span("agg.aggregate", k=len(trees), bucket_size=b):
            acc = None
            for start in range(0, len(trees), b):
                chunk = trees[start:start + b]
                w = weights[start:start + b]
                real = len(chunk)
                if real < b:  # ragged tail: zero-weight pad to the bucket's shape
                    pad = b - real
                    with tel.span("agg.pad_tail", pad=pad, real=real):
                        chunk = list(chunk) + [chunk[-1]] * pad
                        w = np.concatenate([w, np.zeros((pad,), np.float32)])
                acc = self.accumulate_bucket(acc, chunk, w, watch=watch, watch_real=real)
            return self.finalize(acc, trees[0])

    def aggregate_stacked(self, stacked: StateDict, weights) -> StateDict:
        """``sum_k weights[k] * leaf[k]`` over leaves with a leading client
        axis ``[K, ...]``; the weights are NOT normalised here. Returns leaves
        without the client axis, each in its own dtype."""
        if not stacked:
            return stacked
        leaves = list(stacked.values())
        k = leaves[0].shape[0]
        dev = leaves[0].device
        b = self.bucket_size
        pad = (-k) % b
        with tel.span("agg.aggregate_stacked", k=k, bucket_size=b):
            flat = torch.cat([v.reshape(k, -1) for v in leaves], dim=1).to(torch.float32)
            w = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad, flat.shape[1])])
                w = torch.cat([w, w.new_zeros(pad)])
            acc = torch.zeros(flat.shape[1], dtype=torch.float32, device=dev)
            for start in range(0, k + pad, b):
                acc.add_(w[start:start + b] @ flat[start:start + b])
            return self.finalize(acc, {name: v[0] for name, v in stacked.items()})


_ENGINES: Dict[int, BucketedAggregator] = {}
_ENGINES_LOCK = threading.Lock()


def get_engine(bucket_size: Optional[int] = None) -> BucketedAggregator:
    """The process-wide engine for a bucket size (default 16, or
    ``FEDML_AGG_BUCKET``)."""
    if bucket_size is None:
        bucket_size = int(os.environ.get("FEDML_AGG_BUCKET", DEFAULT_BUCKET_SIZE))
    with _ENGINES_LOCK:
        return _ENGINES.setdefault(int(bucket_size), BucketedAggregator(bucket_size))


def bucketed_weighted_average(pairs: Sequence[Tuple[float, StateDict]],
                              bucket_size: Optional[int] = None) -> StateDict:
    return get_engine(bucket_size).aggregate(pairs)
