"""Packed-token datasets for LLM training (numpy only).

Counterpart of ``fedml_tpu/train/llm/data.py``: read local text files, load
or train the BPE tokenizer, pack token streams into fixed ``[N, seq_len]``
blocks, yield deterministic shuffled (tokens, loss_mask) batches, and split
blocks across clients. The numpy draws are the JAX module's, so both
packages see bit-identical batches from one seed.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .tokenizer import BPETokenizer, train_bpe


def read_text_files(path: str, *, text_key: str = "text", max_lines: Optional[int] = None) -> List[str]:
    """path = a .txt/.jsonl file or a directory of them."""
    files: List[str] = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.endswith((".txt", ".jsonl", ".json")):
                files.append(os.path.join(path, name))
    else:
        files = [path]
    lines: List[str] = []
    for fp in files:
        with open(fp, encoding="utf-8", errors="replace") as f:
            if fp.endswith((".jsonl", ".json")):
                for raw in f:
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        obj = json.loads(raw)
                        lines.append(obj[text_key] if isinstance(obj, dict) else str(obj))
                    except (json.JSONDecodeError, KeyError):
                        continue
                    if max_lines and len(lines) >= max_lines:
                        return lines
            else:
                for raw in f:
                    raw = raw.rstrip("\n")
                    if raw:
                        lines.append(raw)
                    if max_lines and len(lines) >= max_lines:
                        return lines
    return lines


def load_or_train_tokenizer(
    dataset_path: Optional[str],
    tokenizer_path: Optional[str],
    *,
    vocab_size: int = 512,
    corpus: Optional[Sequence[str]] = None,
) -> BPETokenizer:
    """tokenizer.json if given (HF checkpoint dir or file); else train a
    byte-level BPE from the dataset itself (self-contained, zero egress)."""
    if tokenizer_path:
        return BPETokenizer.load(tokenizer_path)
    corpus = corpus if corpus is not None else (read_text_files(dataset_path) if dataset_path else [])
    if not corpus:
        raise ValueError("no tokenizer_path and no corpus to train one from")
    return train_bpe(corpus, vocab_size=vocab_size)


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

    @classmethod
    def from_path(
        cls,
        dataset_path: str,
        tokenizer: BPETokenizer,
        seq_len: int,
        *,
        text_key: str = "text",
        max_lines: Optional[int] = None,
    ) -> "TextDataset":
        """The text under ``dataset_path`` (``read_text_files``), each line
        encoded and followed by the tokenizer's ``</s>`` if it has one, packed
        into [N, seq_len] blocks."""
        lines = read_text_files(dataset_path, text_key=text_key, max_lines=max_lines)
        if not lines:
            raise ValueError(f"no text found under {dataset_path}")
        eos = tokenizer.special_tokens.get("</s>")
        streams = [tokenizer.encode(ln) for ln in lines]
        return cls(pack_tokens(streams, seq_len, eos_id=eos))

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
