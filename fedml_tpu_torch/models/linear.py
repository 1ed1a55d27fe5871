"""Linear models: counterpart of ``fedml_tpu/models/linear.py`` (reference
``python/fedml/model/linear/lr.py``). The input is flattened as the JAX
models flatten it (NHWC images in H, W, C order); logits are returned.
Torch sizes its layers up front, so each model takes ``in_features``, the
size of one flattened example."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class LogisticRegression(nn.Module):
    """LR as used by the quick-start configs (model="lr")."""

    def __init__(self, in_features: int, num_classes: int = 10):
        super().__init__()
        self.linear = nn.Linear(in_features, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.linear(x.reshape(x.shape[0], -1))


class TwoNN(nn.Module):
    """2-hidden-layer MLP baseline (reference: MNIST MLP examples)."""

    def __init__(self, in_features: int, hidden: int = 200, num_classes: int = 10):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)
