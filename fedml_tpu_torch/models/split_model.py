"""Split models for split NN and FedGKT: counterpart of
``fedml_tpu/models/split_model.py`` (reference ``model/model_hub.py:54-57``
and ``model/cv/resnet56_gkt``).

The model is cut at an activation boundary: the client half
(:class:`SplitClientNet`, a stem and ``blocks`` residual blocks at
``width``) emits features, and for FedGKT also logits from its own pooled
features; the server half (:class:`SplitServerNet`, two strided stages)
consumes the features. Submodules carry flax's names (``Conv_0``,
``GroupNorm_0``, ``BasicBlock_i``, ``client_head``, ``Dense_0``), so
``models/convert.py`` carries either half's parameters to and from the JAX
package by name. The client takes NHWC images, as the data loaders give
them; the features cross the boundary in the port's NCHW layout.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from .layers import Conv, GroupNorm, flax_init_, nhwc_to_nchw
from .resnet import BasicBlock


class SplitClientNet(nn.Module):
    """The client-side feature extractor (resnet8-ish); with ``with_logits``
    it also returns logits from its pooled features (FedGKT's local head)."""

    def __init__(self, num_classes: int = 10, width: int = 16, blocks: int = 3,
                 group_norm_groups: int = 8, with_logits: bool = True, in_channels: int = 3):
        super().__init__()
        self.Conv_0 = Conv(in_channels, width, (3, 3), use_bias=False)
        self.GroupNorm_0 = GroupNorm(group_norm_groups, width)
        self.n_blocks = blocks
        for i in range(blocks):
            self.add_module(f"BasicBlock_{i}", BasicBlock(width, width, 1, group_norm_groups))
        self.with_logits = with_logits
        if with_logits:
            self.client_head = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        x = torch.relu(self.GroupNorm_0(self.Conv_0(nhwc_to_nchw(x))))
        for i in range(self.n_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        if not self.with_logits:
            return x
        return x, self.client_head(x.mean(dim=(2, 3)))


class SplitServerNet(nn.Module):
    """The server-side head over the client's features (resnet55-ish
    remainder): stages of ``2 * width`` and ``4 * width``, each opening with a
    stride-2 block."""

    def __init__(self, num_classes: int = 10, width: int = 16, blocks_per_stage: int = 3,
                 group_norm_groups: int = 8):
        super().__init__()
        i, in_f = 0, width
        for filters in (2 * width, 4 * width):
            for block in range(blocks_per_stage):
                stride = 2 if block == 0 else 1
                self.add_module(f"BasicBlock_{i}",
                                BasicBlock(in_f, filters, stride, group_norm_groups))
                i, in_f = i + 1, filters
        self.n_blocks = i
        self.Dense_0 = nn.Linear(in_f, num_classes)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features
        for i in range(self.n_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def create_split_pair(num_classes: int = 10, width: int = 16, in_channels: int = 3,
                      seed: int = 0, device="cuda") -> Tuple[SplitClientNet, SplitServerNet]:
    """The FedGKT pair (reference model_hub.py:54-57), drawn as flax's
    default initialisers draw (``layers.flax_init_``) from ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    client = flax_init_(SplitClientNet(num_classes, width, in_channels=in_channels), gen)
    server = flax_init_(SplitServerNet(num_classes, width), gen)
    return client.to(device), server.to(device)
