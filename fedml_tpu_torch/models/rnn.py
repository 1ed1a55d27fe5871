"""Recurrent models for the federated text tasks: counterpart of
``fedml_tpu/models/rnn.py`` (reference ``python/fedml/model/nlp/rnn.py``).

The state dict keeps flax's leaves (``Embed_0.embedding``,
``LSTMCell_k.{ii,if,ig,io}.weight``, ``LSTMCell_k.{hi,hf,hg,ho}.{weight,
bias}``), so the fold, the wire order and models/convert.py stay generic.
The JAX package runs the recurrence as a ``lax.scan`` in XLA; the port runs
it as ``torch.lstm`` (cuDNN on the card) from the same leaves
(``models/layers.py`` ``lstm``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import Embed, LSTMCell, lstm


class RNNOriginalFedAvg(nn.Module):
    """Char-LSTM for Shakespeare: embedding 8, 2 x LSTM(256), dense to the
    vocab; logits [B, T, V] (reference model/nlp/rnn.py:6-39)."""

    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8, hidden_size: int = 256):
        super().__init__()
        self.Embed_0 = Embed(vocab_size, embedding_dim)
        self.LSTMCell_0 = LSTMCell(embedding_dim, hidden_size)
        self.LSTMCell_1 = LSTMCell(hidden_size, hidden_size)
        self.Dense_0 = nn.Linear(hidden_size, vocab_size)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h = lstm(self.Embed_0(x), self.LSTMCell_0)
        return self.Dense_0(lstm(h, self.LSTMCell_1))


class RNNStackOverflow(nn.Module):
    """Next-word LSTM for stackoverflow_nwp: vocab 10,000 + pad/bos/eos + the
    oov buckets, embedding 96, LSTM 670, two projections (reference
    model/nlp/rnn.py:42-77)."""

    def __init__(self, vocab_size: int = 10000, num_oov_buckets: int = 1,
                 embedding_size: int = 96, latent_size: int = 670):
        super().__init__()
        extended_vocab = vocab_size + 3 + num_oov_buckets
        self.Embed_0 = Embed(extended_vocab, embedding_size)
        self.LSTMCell_0 = LSTMCell(embedding_size, latent_size)
        self.Dense_0 = nn.Linear(latent_size, embedding_size)
        self.Dense_1 = nn.Linear(embedding_size, extended_vocab)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h = lstm(self.Embed_0(x), self.LSTMCell_0)
        return self.Dense_1(self.Dense_0(h))
