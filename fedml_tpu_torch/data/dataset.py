"""Array-backed dataset shards: counterpart of ``fedml_tpu/data/dataset.py``.

A client shard is a pair of contiguous numpy arrays, as in the JAX package
(the reference's per-client ``torch.DataLoader`` dicts become these). The
trainer moves a shard to the device once per local round and gathers its
batches there by index. The native mmap shards and their C++ prefetcher are
not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    """One shard: features [N, ...] + labels [N] (or [N, ...])."""

    x: np.ndarray
    y: np.ndarray

    def __post_init__(self):
        if len(self.x) != len(self.y):
            raise ValueError(f"features {self.x.shape} and labels {self.y.shape} differ in length")

    def __len__(self) -> int:
        return len(self.x)

    def batches(self, batch_size: int, *, shuffle: bool = False, seed: int = 0,
                drop_last: bool = False) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.x))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        n = len(idx)
        end = n - (n % batch_size) if drop_last and n >= batch_size else n
        for start in range(0, end, batch_size):
            sel = idx[start:start + batch_size]
            yield self.x[sel], self.y[sel]

    def subset(self, indices: np.ndarray) -> "ArrayDataset":
        return ArrayDataset(self.x[indices], self.y[indices])
