"""ResNets for CIFAR/ImageNet-scale federated vision: counterpart of
``fedml_tpu/models/resnet.py`` (reference ``python/fedml/model/cv/resnet56.py``
and ``resnet_gn.py``), GroupNorm everywhere, so client updates carry no
running statistics.

Submodules carry flax's auto-names (``Conv_0``, ``GroupNorm_0``,
``BasicBlock_26``, ``Dense_0``, and the explicit ``proj``/``proj_norm``), so
a parameter's path is the flax path with dots. The data is NHWC; each model
permutes it to NCHW once at its entry. The convolutions and the stem's max
pool pad as flax's ``"SAME"`` does (models/layers.py): asymmetrically, (0, 1),
for a 3x3 stride-2 conv on an even input, and (2, 3) for the 7x7 stride-2
stem. GroupNorm's epsilon is flax's 1e-6. The global pool is the mean over
H and W.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import Conv, GroupNorm, max_pool_same, nhwc_to_nchw


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, stride: int, num_groups: int):
        super().__init__()
        s = (stride, stride)
        self.Conv_0 = Conv(in_features, filters, (3, 3), s, use_bias=False)
        self.GroupNorm_0 = GroupNorm(num_groups, filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), use_bias=False)
        self.GroupNorm_1 = GroupNorm(num_groups, filters)
        # the JAX block projects when the residual's shape differs from y's
        if stride != 1 or in_features != filters:
            self.proj = Conv(in_features, filters, (1, 1), s, use_bias=False)
            self.proj_norm = GroupNorm(num_groups, filters)
        else:
            self.proj = self.proj_norm = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = x if self.proj is None else self.proj_norm(self.proj(x))
        return torch.relu(y + residual)


class ResNetCifar(nn.Module):
    """6n+2 CIFAR ResNet (n=9 -> ResNet-56)."""

    def __init__(self, depth: int = 56, num_classes: int = 10, width: int = 16,
                 group_norm_groups: int = 8, in_channels: int = 3):
        super().__init__()
        n = (depth - 2) // 6
        self.Conv_0 = Conv(in_channels, width, (3, 3), use_bias=False)
        self.GroupNorm_0 = GroupNorm(group_norm_groups, width)
        i, in_f = 0, width
        for stage, filters in enumerate([width, 2 * width, 4 * width]):
            for block in range(n):
                stride = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"BasicBlock_{i}",
                                BasicBlock(in_f, filters, stride, group_norm_groups))
                i, in_f = i + 1, filters
        self.n_blocks = i
        self.Dense_0 = nn.Linear(in_f, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.GroupNorm_0(self.Conv_0(nhwc_to_nchw(x))))
        for i in range(self.n_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


class ResNet18GN(nn.Module):
    """ImageNet-style ResNet-18 with GroupNorm."""

    def __init__(self, num_classes: int = 1000, group_norm_groups: int = 32,
                 in_channels: int = 3):
        super().__init__()
        self.Conv_0 = Conv(in_channels, 64, (7, 7), (2, 2), use_bias=False)
        self.GroupNorm_0 = GroupNorm(group_norm_groups, 64)
        i, in_f = 0, 64
        for stage, filters in enumerate([64, 128, 256, 512]):
            for block in range(2):
                stride = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"BasicBlock_{i}",
                                BasicBlock(in_f, filters, stride, group_norm_groups))
                i, in_f = i + 1, filters
        self.n_blocks = i
        self.Dense_0 = nn.Linear(in_f, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.GroupNorm_0(self.Conv_0(nhwc_to_nchw(x))))
        x = max_pool_same(x, 3, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def resnet56(num_classes: int = 10, in_channels: int = 3) -> ResNetCifar:
    return ResNetCifar(depth=56, num_classes=num_classes, in_channels=in_channels)


def resnet20(num_classes: int = 10, in_channels: int = 3) -> ResNetCifar:
    return ResNetCifar(depth=20, num_classes=num_classes, in_channels=in_channels)
