"""EfficientNet-lite: counterpart of ``fedml_tpu/models/efficientnet.py``
(reference ``python/fedml/model/cv/efficientnet*.py``).

The lite-B0 trunk (no squeeze-excite, relu6) with GroupNorm; the depthwise
stages are grouped ``Conv``s. The hub builds :func:`efficientnet_lite0` for
every model name that starts with ``efficientnet``, as the JAX hub does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import Conv, GroupNorm, nhwc_to_nchw, relu6
from .mobilenet import _gn


class MBConv(nn.Module):
    def __init__(self, in_ch: int, expand_ratio: int, filters: int, kernel: int, stride: int):
        super().__init__()
        mid = in_ch * expand_ratio
        self.expands = expand_ratio != 1
        self.residual = stride == 1 and in_ch == filters
        i = 0
        if self.expands:
            self.Conv_0 = Conv(in_ch, mid, (1, 1), use_bias=False)
            self.GroupNorm_0 = GroupNorm(_gn(mid), mid)
            i = 1
        self.add_module(f"Conv_{i}", Conv(mid, mid, (kernel, kernel), (stride, stride),
                                          use_bias=False, groups=mid))
        self.add_module(f"GroupNorm_{i}", GroupNorm(_gn(mid), mid))
        self.add_module(f"Conv_{i + 1}", Conv(mid, filters, (1, 1), use_bias=False))
        self.add_module(f"GroupNorm_{i + 1}", GroupNorm(_gn(filters), filters))
        self.first = i

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expands:
            y = relu6(self.GroupNorm_0(self.Conv_0(y)))
        i = self.first
        y = relu6(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(y)))
        y = getattr(self, f"GroupNorm_{i + 1}")(getattr(self, f"Conv_{i + 1}")(y))
        return y + x if self.residual else y


# (expand, filters, kernel, stride, repeats): the B0 trunk
_B0: Sequence[Tuple[int, int, int, int, int]] = (
    (1, 16, 3, 1, 1),
    (6, 24, 3, 2, 2),
    (6, 40, 5, 2, 2),
    (6, 80, 3, 2, 3),
    (6, 112, 5, 1, 3),
    (6, 192, 5, 2, 4),
    (6, 320, 3, 1, 1),
)


class EfficientNetLite(nn.Module):
    def __init__(self, num_classes: int = 10, width_mult: float = 1.0, depth_mult: float = 1.0,
                 in_channels: int = 3):
        super().__init__()

        def w(c: int) -> int:
            return max(8, int(c * width_mult + 4) // 8 * 8)

        self.Conv_0 = Conv(in_channels, 32, (3, 3), (2, 2), use_bias=False)
        self.GroupNorm_0 = GroupNorm(8, 32)
        ch, n = 32, 0
        for expand, filters, kernel, stride, repeats in _B0:
            for i in range(int(math.ceil(repeats * depth_mult))):
                self.add_module(f"MBConv_{n}", MBConv(ch, expand, w(filters), kernel,
                                                      stride if i == 0 else 1))
                ch, n = w(filters), n + 1
        self.n_blocks = n
        self.Conv_1 = Conv(ch, 1280, (1, 1), use_bias=False)
        self.GroupNorm_1 = GroupNorm(8, 1280)
        self.Dense_0 = nn.Linear(1280, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = relu6(self.GroupNorm_0(self.Conv_0(nhwc_to_nchw(x))))
        for i in range(self.n_blocks):
            x = getattr(self, f"MBConv_{i}")(x)
        x = relu6(self.GroupNorm_1(self.Conv_1(x)))
        return self.Dense_0(x.mean(dim=(2, 3)))


def efficientnet_lite0(num_classes: int = 10, in_channels: int = 3) -> EfficientNetLite:
    return EfficientNetLite(num_classes=num_classes, in_channels=in_channels)
