"""Generator/discriminator pair for FedGAN: counterpart of
``fedml_tpu/models/gan.py`` (reference ``python/fedml/model/cv/cgan.py``).

DCGAN-shaped with GroupNorm, NHWC at the edges: the generator maps z
[B, latent] to images [B, H, W, C] in (-1, 1), the discriminator images to
one logit. The pair is one state dict, ``generator.*`` and
``discriminator.*``, so FedAvg folds both halves at once. The generator's
transposed convolutions (k=4, s=2) pad as flax's SAME does, (2, 2)
(``models/layers.py`` ``ConvTranspose``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, ConvTranspose, GroupNorm, nhwc_to_nchw


class Generator(nn.Module):
    """z -> image: a dense projection and two transposed-conv upsamplings."""

    def __init__(self, image_hw: int = 28, channels: int = 1, latent_dim: int = 64,
                 base_width: int = 64):
        super().__init__()
        self.s, self.base_width = image_hw // 4, base_width
        self.Dense_0 = nn.Linear(latent_dim, self.s * self.s * base_width * 2)
        self.GroupNorm_0 = GroupNorm(8, base_width * 2)
        self.ConvTranspose_0 = ConvTranspose(base_width * 2, base_width, (4, 4), (2, 2))
        self.GroupNorm_1 = GroupNorm(8, base_width)
        self.ConvTranspose_1 = ConvTranspose(base_width, channels, (4, 4), (2, 2))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(z).reshape(z.shape[0], self.s, self.s, self.base_width * 2)
        x = torch.relu(self.GroupNorm_0(nhwc_to_nchw(x)))
        x = torch.relu(self.GroupNorm_1(self.ConvTranspose_0(x)))
        return torch.tanh(self.ConvTranspose_1(x)).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """image -> real/fake logit."""

    def __init__(self, image_hw: int = 28, channels: int = 1, base_width: int = 64):
        super().__init__()
        self.Conv_0 = Conv(channels, base_width, (4, 4), (2, 2))
        self.Conv_1 = Conv(base_width, base_width * 2, (4, 4), (2, 2))
        self.GroupNorm_0 = GroupNorm(8, base_width * 2)
        s = -(-image_hw // 4)  # two SAME stride-2 convs: ceil(ceil(n/2)/2)
        self.Dense_0 = nn.Linear(s * s * base_width * 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.Conv_0(nhwc_to_nchw(x)), 0.2)
        x = F.leaky_relu(self.GroupNorm_0(self.Conv_1(x)), 0.2)
        return self.Dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class GANPair(nn.Module):
    """G and D as one module; ``forward`` is D(G(z)), the JAX init path."""

    def __init__(self, image_hw: int = 28, channels: int = 1, latent_dim: int = 64):
        super().__init__()
        self.latent_dim = latent_dim
        self.generator = Generator(image_hw, channels, latent_dim)
        self.discriminator = Discriminator(image_hw, channels)

    def forward(self, z: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.discriminator(self.generator(z))

    def generate(self, z: torch.Tensor) -> torch.Tensor:
        return self.generator(z)

    def discriminate(self, x: torch.Tensor) -> torch.Tensor:
        return self.discriminator(x)
