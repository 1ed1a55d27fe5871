"""Packed-token datasets for LLM training (numpy only).

Counterpart of ``fedml_tpu/train/llm/data.py``: pack token streams into
fixed ``[N, seq_len]`` blocks, yield deterministic shuffled (tokens,
loss_mask) batches, and split blocks across clients. The numpy draws are the
JAX module's, so both packages see bit-identical batches from one seed. The
tokenizer and reading text files wait for a later slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def pack_tokens(
    token_streams: Sequence[List[int]], seq_len: int, *, eos_id: Optional[int] = None
) -> np.ndarray:
    """Concatenate documents (with optional EOS separators) and cut into
    fixed [N, seq_len] blocks — static shapes, no padding waste."""
    flat: List[int] = []
    for doc in token_streams:
        flat.extend(doc)
        if eos_id is not None:
            flat.append(eos_id)
    n = len(flat) // seq_len
    if n == 0:
        raise ValueError(f"corpus too small: {len(flat)} tokens < seq_len {seq_len}")
    return np.asarray(flat[: n * seq_len], np.int32).reshape(n, seq_len)


class TextDataset:
    """Packed-token dataset with deterministic shuffled epoch batches."""

    def __init__(self, blocks: np.ndarray):
        self.blocks = blocks

    def __len__(self) -> int:
        return len(self.blocks)

    def batches(
        self, batch_size: int, steps: Optional[int] = None, *, seed: int = 0
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (tokens, loss_mask) forever (or for `steps`), reshuffling
        each epoch; small shards wrap around rather than yielding short or
        empty batches."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.blocks))
        pos = emitted = 0
        while steps is None or emitted < steps:
            take: List[np.ndarray] = []
            need = batch_size
            while need > 0:
                if pos >= len(order):
                    order = rng.permutation(len(self.blocks))
                    pos = 0
                got = order[pos : pos + need]
                take.append(self.blocks[got])
                pos += len(got)
                need -= len(got)
            toks = np.concatenate(take, axis=0)
            yield toks, np.ones_like(toks, np.float32)
            emitted += 1


def client_shards(dataset: TextDataset, n_clients: int, *, seed: int = 0) -> List[TextDataset]:
    """Split packed blocks across clients (contiguous shards of a fixed
    permutation — every client gets >=1 block)."""
    if len(dataset) < n_clients:
        raise ValueError(f"{len(dataset)} blocks < {n_clients} clients")
    order = np.random.default_rng(seed).permutation(len(dataset))
    return [
        TextDataset(dataset.blocks[order[i::n_clients]]) for i in range(n_clients)
    ]
