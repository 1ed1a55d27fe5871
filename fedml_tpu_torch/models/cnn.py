"""CNNs from the FedAvg paper family: counterpart of
``fedml_tpu/models/cnn.py`` (reference ``python/fedml/model/cv/cnn.py``).

The data is NHWC; each model permutes it to NCHW once at its entry. Before
the first dense layer the activations are permuted back to NHWC and then
flattened, so that layer sees the features in the JAX model's H, W, C order
and takes the JAX kernel as it is (transposed only, by models/convert.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, dropout, nhwc_to_nchw


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class CNNDropOut(nn.Module):
    """McMahan et al. CNN: 2x(conv3x3 + maxpool) + dense, with dropout
    (conv 32, conv 64, fc 128, fc classes) for 28x28x1 inputs."""

    def __init__(self, num_classes: int = 10, in_shape: Sequence[int] = (28, 28, 1)):
        super().__init__()
        h, w, c = in_shape
        self.Conv_0 = Conv(c, 32, (3, 3))
        self.Conv_1 = Conv(32, 64, (3, 3))
        self.Dense_0 = nn.Linear((h // 4) * (w // 4) * 64, 128)
        self.Dense_1 = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.ndim == 3:
            x = x[..., None]
        x = nhwc_to_nchw(x)
        x = F.max_pool2d(torch.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        x = dropout(x, 0.25, train, rng)
        x = torch.relu(self.Dense_0(_flatten_nhwc(x)))
        x = dropout(x, 0.5, train, rng)
        return self.Dense_1(x)


class CNNCifar(nn.Module):
    """Simple CIFAR CNN (reference: model/cv/cnn.py CNN_CIFAR-style)."""

    def __init__(self, num_classes: int = 10, in_shape: Sequence[int] = (32, 32, 3)):
        super().__init__()
        h, w, c = in_shape
        self.Conv_0 = Conv(c, 32, (3, 3))
        self.Conv_1 = Conv(32, 64, (3, 3))
        self.Conv_2 = Conv(64, 64, (3, 3))
        self.Dense_0 = nn.Linear((h // 4) * (w // 4) * 64, 64)
        self.Dense_1 = nn.Linear(64, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = nhwc_to_nchw(x)
        x = F.max_pool2d(torch.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        x = torch.relu(self.Conv_2(x))
        x = torch.relu(self.Dense_0(_flatten_nhwc(x)))
        return self.Dense_1(x)
