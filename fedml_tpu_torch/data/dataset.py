"""Array-backed dataset shards: counterpart of ``fedml_tpu/data/dataset.py``.

A client shard is a pair of contiguous numpy arrays, as in the JAX package
(the reference's per-client ``torch.DataLoader`` dicts become these). The
trainer moves a shard to the device once per local round and gathers its
batches there by index. A dataset too large to hold goes to mmap-able shards
(:meth:`ArrayDataset.save_shards`) and streams back through the C++
prefetcher of ``native/dataplane`` (:meth:`ArrayDataset.stream`,
``native_loader.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

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

    # --- native data plane (shards too big to hold in memory) ---------------
    def save_shards(self, prefix: str) -> Tuple[str, str]:
        """Write (x, y) as mmap-able binary shards for the C++ prefetcher
        (native/dataplane): ``{prefix}.x.fdlp`` and ``{prefix}.y.fdlp``."""
        from .native_loader import write_shard

        xp, yp = f"{prefix}.x.fdlp", f"{prefix}.y.fdlp"
        write_shard(xp, self.x)
        write_shard(yp, self.y)
        return xp, yp

    @staticmethod
    def stream(paths: Tuple[str, str], batch_size: int, *, seed: int = 0,
               epochs: Optional[int] = None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Shuffled (x, y) batches gathered by the background C++ thread
        (the last partial batch of an epoch dropped); without a toolchain, a
        numpy gather from a memmap of the same files, in the order of
        ``np.random.default_rng(seed)``'s permutations (the JAX package's
        fallback)."""
        from .native_loader import NativeBatchLoader, shard_info

        if NativeBatchLoader.available():
            loader = NativeBatchLoader(list(paths), batch_size, seed=seed)
            try:
                e = 0
                while epochs is None or e < epochs:
                    for bx, by in loader.epoch():
                        yield bx, by
                    e += 1
            finally:
                loader.close()
            return
        specs = [shard_info(p) for p in paths]
        maps = [
            np.memmap(p, dtype=dt, mode="r", shape=dims, offset=16 + 8 * len(dims))
            for p, (dt, dims) in zip(paths, specs)
        ]
        n = specs[0][1][0]
        if any(dims[0] != n for _, dims in specs):
            raise ValueError(  # the native path refuses this too
                f"parallel shards disagree on n_samples: {[d[0] for _, d in specs]}")
        if batch_size > n:
            raise ValueError(f"batch size {batch_size} > {n} samples")  # as the native path
        rng = np.random.default_rng(seed)
        e = 0
        while epochs is None or e < epochs:
            idx = rng.permutation(n)
            for s in range(0, n - n % batch_size, batch_size):
                sel = idx[s:s + batch_size]
                yield maps[0][sel], maps[1][sel]
            e += 1
