"""DARTS supernet for FedNAS: counterpart of ``fedml_tpu/models/darts.py``
(reference ``python/fedml/model/cv/darts/{model_search,operations,genotypes}.py``).

The mixed op is the softmax(alpha)-weighted sum over a fixed op bank,
stacked and contracted in one einsum as the JAX module does. The
architecture parameters are one top-level leaf, ``arch`` [edges, ops], so
FedAvg folds weights and alphas alike. The op modules carry flax's
auto-names: only the ops with parameters have a module (``_Op_2`` conv3,
``_Op_3`` conv5, ``_Op_6`` sepconv3, ``_Op_7`` dilconv3), numbered by their
place in ``OP_NAMES``. ``dilconv3`` pads as SAME over the dilated kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, GroupNorm, avg_pool_same, max_pool_same, nhwc_to_nchw

OP_NAMES: Sequence[str] = ("none", "skip", "conv3", "conv5", "maxpool", "avgpool", "sepconv3",
                           "dilconv3")


class _Op(nn.Module):
    """One op of the bank that has parameters: relu, conv(s), GroupNorm(4)."""

    def __init__(self, kind: str, in_ch: int, filters: int):
        super().__init__()
        self.kind = kind
        if kind == "sepconv3":
            self.Conv_0 = Conv(in_ch, in_ch, (3, 3), use_bias=False, groups=in_ch)
            self.Conv_1 = Conv(in_ch, filters, (1, 1), use_bias=False)
        elif kind == "dilconv3":
            self.Conv_0 = Conv(in_ch, filters, (3, 3), use_bias=False, dilation=(2, 2))
        else:
            k = 3 if kind == "conv3" else 5
            self.Conv_0 = Conv(in_ch, filters, (k, k), use_bias=False)
        self.GroupNorm_0 = GroupNorm(4, filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(torch.relu(x))
        if self.kind == "sepconv3":
            y = self.Conv_1(y)
        return self.GroupNorm_0(y)


class MixedOp(nn.Module):
    def __init__(self, filters: int):
        super().__init__()
        for i, kind in enumerate(OP_NAMES):
            if kind in ("conv3", "conv5", "sepconv3", "dilconv3"):
                self.add_module(f"_Op_{i}", _Op(kind, filters, filters))

    def forward(self, x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        outs = []
        for i, kind in enumerate(OP_NAMES):
            if kind == "none":
                outs.append(torch.zeros_like(x))
            elif kind == "skip":
                outs.append(x)
            elif kind == "maxpool":
                outs.append(max_pool_same(x, 3, 1))
            elif kind == "avgpool":
                outs.append(avg_pool_same(x, 3, 1))
            else:
                outs.append(getattr(self, f"_Op_{i}")(x))
        return torch.einsum("o,obchw->bchw", torch.softmax(alpha, dim=-1), torch.stack(outs))


class Cell(nn.Module):
    """``steps`` nodes, each the sum of mixed ops over every earlier state;
    the output is the nodes concatenated. 1x1 convs bring both inputs to
    ``filters`` channels first."""

    def __init__(self, in0: int, in1: int, filters: int, steps: int = 3):
        super().__init__()
        self.steps = steps
        self.pre0 = Conv(in0, filters, (1, 1), use_bias=False)
        self.pre0_norm = GroupNorm(4, filters)
        self.pre1 = Conv(in1, filters, (1, 1), use_bias=False)
        self.pre1_norm = GroupNorm(4, filters)
        for e in range(num_edges(steps)):
            self.add_module(f"MixedOp_{e}", MixedOp(filters))

    def forward(self, s0: torch.Tensor, s1: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
        states = [self.pre0_norm(self.pre0(torch.relu(s0))),
                  self.pre1_norm(self.pre1(torch.relu(s1)))]
        edge = 0
        for _ in range(self.steps):
            node = 0
            for h in states:
                node = node + getattr(self, f"MixedOp_{edge}")(h, alphas[edge])
                edge += 1
            states.append(node)
        return torch.cat(states[2:], dim=1)


def num_edges(steps: int = 3) -> int:
    return sum(2 + i for i in range(steps))


class DARTSNetwork(nn.Module):
    """Stem, ``layers`` cells (2x2 average pools between them), mean pool,
    classifier; the alphas are ``arch`` [num_edges, len(OP_NAMES)]."""

    def __init__(self, num_classes: int = 10, width: int = 16, layers: int = 3, steps: int = 3,
                 in_channels: int = 3):
        super().__init__()
        self.layers, self.steps = layers, steps
        self.arch = nn.Parameter(torch.empty(num_edges(steps), len(OP_NAMES)))
        self.Conv_0 = Conv(in_channels, width, (3, 3), use_bias=False)
        self.GroupNorm_0 = GroupNorm(4, width)
        c0 = c1 = width
        for layer in range(layers):
            self.add_module(f"Cell_{layer}", Cell(c0, c1, width, steps))
            c0, c1 = c1, width * steps
        self.Dense_0 = nn.Linear(c1, num_classes)

    def flax_init(self, generator: torch.Generator) -> None:
        self.arch.data.fill_(1e-3)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.GroupNorm_0(self.Conv_0(nhwc_to_nchw(x)))
        s0 = s1 = x
        for layer in range(self.layers):
            s0, s1 = s1, getattr(self, f"Cell_{layer}")(s0, s1, self.arch)
            if layer != self.layers - 1:
                s0, s1 = F.avg_pool2d(s0, 2, 2), F.avg_pool2d(s1, 2, 2)
        return self.Dense_0(s1.mean(dim=(2, 3)))


def derive_genotype(alphas, steps: int = 3) -> Tuple[Tuple[int, str], ...]:
    """Argmax discretisation of the searched architecture (reference
    model_search.py genotype()): each node's two strongest input edges
    (a stable sort, as ``jnp.argsort``: at init every alpha ties) with
    their best op other than 'none'."""
    alphas = np.asarray(alphas.detach().cpu() if isinstance(alphas, torch.Tensor) else alphas)
    geno = []
    edge = 0
    for i in range(steps):
        n_in = 2 + i
        block = alphas[edge:edge + n_in]
        edge += n_in
        best_op = np.argmax(block[:, 1:], axis=-1) + 1
        strength = np.max(block[:, 1:], axis=-1)
        for j in np.argsort(-strength, kind="stable")[:2]:
            geno.append((int(j), OP_NAMES[int(best_op[j])]))
    return tuple(geno)
