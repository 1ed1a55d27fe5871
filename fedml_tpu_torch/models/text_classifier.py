"""Transformer text classifier (the FedNLP / DistilBERT-task model):
counterpart of ``fedml_tpu/models/text_classifier.py``.

Token and position embeddings, N pre-LayerNorm blocks of self-attention and
a GELU (tanh form) feed-forward, a masked mean pool and a linear head. The
attention is flax's ``MultiHeadDotProductAttention`` written out: plain
einsums and a softmax (it is no Pallas kernel in the JAX package, and it
does not route to the port's flash kernels), with flax's kernels
``[d, H, hd]`` / ``[H, hd, d]`` kept as they are (``models/layers.py``
``DenseGeneral``). A masked logit is ``finfo(dtype).min``, as in flax, not
``-inf``: a padding query row (every key masked) then gets a uniform
softmax where ``-inf`` would give NaN, and the pool's ``NaN * 0`` would
carry it into every logit of the example. The attention dropout draws one
[T, T] mask for every example and head (flax's ``broadcast_dropout``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from .layers import DenseGeneral, Embed, LayerNorm, dropout, gelu


@dataclasses.dataclass(frozen=True)
class TextClassifierConfig:
    vocab_size: int = 5000
    num_classes: int = 20
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 1024
    max_seq_len: int = 128
    dropout: float = 0.1
    pad_id: int = 0


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dropout_rate: float):
        super().__init__()
        hd = d_model // n_heads
        self.dropout_rate = dropout_rate
        self.query = DenseGeneral((d_model,), (n_heads, hd))
        self.key = DenseGeneral((d_model,), (n_heads, hd))
        self.value = DenseGeneral((d_model,), (n_heads, hd))
        self.out = DenseGeneral((n_heads, hd), (d_model,))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool,
                rng: Optional[torch.Generator]) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, T, H, hd]
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        t = x.shape[1]
        w = dropout(w, self.dropout_rate, train, rng, shape=(1, 1, t, t))
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class EncoderBlock(nn.Module):
    def __init__(self, cfg: TextClassifierConfig):
        super().__init__()
        self.rate = cfg.dropout
        self.LayerNorm_0 = LayerNorm(cfg.d_model)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            cfg.d_model, cfg.n_heads, cfg.dropout)
        self.LayerNorm_1 = LayerNorm(cfg.d_model)
        self.Dense_0 = nn.Linear(cfg.d_model, cfg.d_ff)
        self.Dense_1 = nn.Linear(cfg.d_ff, cfg.d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool,
                rng: Optional[torch.Generator]) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), mask, train, rng)
        h = self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(x))))
        return x + dropout(h, self.rate, train, rng)


class TransformerTextClassifier(nn.Module):
    def __init__(self, cfg: TextClassifierConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = Embed(cfg.vocab_size, cfg.d_model)
        self.pos_embed = Embed(cfg.max_seq_len, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", EncoderBlock(cfg))
        self.final_norm = LayerNorm(cfg.d_model)
        self.classifier = nn.Linear(cfg.d_model, cfg.num_classes)

    def forward(self, tokens: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        pad = tokens != cfg.pad_id  # [B, T]
        t = tokens.shape[1]
        x = self.tok_embed(tokens) + self.pos_embed(torch.arange(t, device=tokens.device))
        mask = pad[:, None, :, None] & pad[:, None, None, :]  # [B, 1, T, T]
        for i in range(cfg.n_layers):
            x = getattr(self, f"block_{i}")(x, mask, train, rng)
        x = self.final_norm(x)
        keep = pad[..., None].to(x.dtype)
        pooled = (x * keep).sum(dim=1) / keep.sum(dim=1).clamp_min(1.0)
        return self.classifier(pooled)


def distilbert_shape(num_classes: int, vocab_size: int = 5000, max_seq_len: int = 128,
                     **over) -> TransformerTextClassifier:
    """The DistilBERT-proportioned config, scaled to the federated task."""
    return TransformerTextClassifier(TextClassifierConfig(
        vocab_size=vocab_size, num_classes=num_classes, max_seq_len=max_seq_len, **over))
