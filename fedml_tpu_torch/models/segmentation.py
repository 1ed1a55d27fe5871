"""Semantic-segmentation model for FedSeg: counterpart of
``fedml_tpu/models/segmentation.py`` (reference ``simulation/mpi/fedseg/``
trains DeepLabV3+/UNet heads).

A small UNet-style encoder-decoder: strided convolutions down, transposed
convolutions up, skip connections. The leaves carry the JAX module's
explicit names (``enc0`` ... ``head``). The decoder's transposed
convolutions (k=3, s=2) pad as flax's SAME does, (2, 1), which torch's
``padding``/``output_padding`` cannot express (``models/layers.py``
``ConvTranspose`` crops). NHWC in, per-pixel logits [B, H, W, classes] out.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import Conv, ConvTranspose, nhwc_to_nchw


class SegNetLite(nn.Module):
    def __init__(self, num_classes: int, width: int = 16, in_channels: int = 3):
        super().__init__()
        w = width
        self.enc0 = Conv(in_channels, w, (3, 3))
        self.enc1 = Conv(w, 2 * w, (3, 3), (2, 2))
        self.enc2 = Conv(2 * w, 4 * w, (3, 3), (2, 2))
        self.bottleneck = Conv(4 * w, 4 * w, (3, 3))
        self.dec1 = ConvTranspose(4 * w, 2 * w, (3, 3), (2, 2))
        self.dec0 = ConvTranspose(4 * w, w, (3, 3), (2, 2))
        self.head = Conv(2 * w, num_classes, (1, 1))

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        e0 = torch.relu(self.enc0(nhwc_to_nchw(x)))
        e1 = torch.relu(self.enc1(e0))
        e2 = torch.relu(self.enc2(e1))
        b = torch.relu(self.bottleneck(e2))
        d1 = torch.cat([torch.relu(self.dec1(b)), e1], dim=1)
        d0 = torch.cat([torch.relu(self.dec0(d1)), e0], dim=1)
        return self.head(d0).permute(0, 2, 3, 1)
