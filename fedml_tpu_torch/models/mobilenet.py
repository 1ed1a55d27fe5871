"""MobileNet v1 and v3-small: counterpart of ``fedml_tpu/models/mobilenet.py``
(reference ``python/fedml/model/cv/mobilenet.py`` and ``mobilenet_v3.py``).

GroupNorm in place of BatchNorm, so a client's update carries no running
statistics. The depthwise convolutions are grouped ``Conv``s
(``groups=channels``); their flax kernels ``[kh, kw, 1, C]`` are the
port's ``[C, 1, kh, kw]``. Submodules carry flax's auto-names, numbered per
kind in call order (``Conv_0``, ``GroupNorm_0``, ``InvertedResidual_3``,
``SqueezeExcite_0``, ``Dense_1``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .layers import Conv, GroupNorm, hard_sigmoid, hard_swish, nhwc_to_nchw


def _gn(width: int) -> int:
    """A GroupNorm group count that divides ``width``."""
    for g in (8, 4, 2, 1):
        if width % g == 0:
            return g
    return 1


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_ch: int, filters: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_ch, in_ch, (3, 3), (stride, stride), use_bias=False, groups=in_ch)
        self.GroupNorm_0 = GroupNorm(_gn(in_ch), in_ch)
        self.Conv_1 = Conv(in_ch, filters, (1, 1), use_bias=False)
        self.GroupNorm_1 = GroupNorm(_gn(filters), filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        return torch.relu(self.GroupNorm_1(self.Conv_1(x)))


_V1_PLAN = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)] + [(512, 1)] * 5 + \
    [(1024, 2), (1024, 1)]


class MobileNetV1(nn.Module):
    """The reference's v1 at width multiplier ``alpha``."""

    def __init__(self, num_classes: int = 10, alpha: float = 1.0, in_channels: int = 3):
        super().__init__()

        def c(w: int) -> int:
            return max(8, int(w * alpha))

        self.Conv_0 = Conv(in_channels, c(32), (3, 3), (2, 2), use_bias=False)
        self.GroupNorm_0 = GroupNorm(_gn(c(32)), c(32))
        ch = c(32)
        for i, (filters, stride) in enumerate(_V1_PLAN):
            self.add_module(f"DepthwiseSeparable_{i}", DepthwiseSeparable(ch, c(filters), stride))
            ch = c(filters)
        self.Dense_0 = nn.Linear(ch, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.GroupNorm_0(self.Conv_0(nhwc_to_nchw(x))))
        for i in range(len(_V1_PLAN)):
            x = getattr(self, f"DepthwiseSeparable_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, reduce: int = 4):
        super().__init__()
        self.Dense_0 = nn.Linear(ch, max(8, ch // reduce))
        self.Dense_1 = nn.Linear(max(8, ch // reduce), ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.Dense_0(x.mean(dim=(2, 3))))
        return x * hard_sigmoid(self.Dense_1(s))[:, :, None, None]


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, expand: int, filters: int, kernel: int = 3, stride: int = 1,
                 se: bool = False, swish: bool = False):
        super().__init__()
        self.swish, self.expands = swish, expand != in_ch
        self.residual = stride == 1 and in_ch == filters
        i = 0
        if self.expands:
            self.Conv_0 = Conv(in_ch, expand, (1, 1), use_bias=False)
            self.GroupNorm_0 = GroupNorm(_gn(expand), expand)
            i = 1
        self.add_module(f"Conv_{i}", Conv(expand, expand, (kernel, kernel), (stride, stride),
                                          use_bias=False, groups=expand))
        self.add_module(f"GroupNorm_{i}", GroupNorm(_gn(expand), expand))
        self.SqueezeExcite_0 = SqueezeExcite(expand) if se else None
        self.add_module(f"Conv_{i + 1}", Conv(expand, filters, (1, 1), use_bias=False))
        self.add_module(f"GroupNorm_{i + 1}", GroupNorm(_gn(filters), filters))
        self.first = i

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = hard_swish if self.swish else torch.relu
        y = x
        if self.expands:
            y = act(self.GroupNorm_0(self.Conv_0(y)))
        i = self.first
        y = act(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(y)))
        if self.SqueezeExcite_0 is not None:
            y = self.SqueezeExcite_0(y)
        y = getattr(self, f"GroupNorm_{i + 1}")(getattr(self, f"Conv_{i + 1}")(y))
        return y + x if self.residual else y


# (expand, filters, kernel, stride, SE, hard-swish): the v3-small trunk
_V3_SMALL: Sequence[Tuple[int, int, int, int, bool, bool]] = (
    (16, 16, 3, 2, True, False),
    (72, 24, 3, 2, False, False),
    (88, 24, 3, 1, False, False),
    (96, 40, 5, 2, True, True),
    (240, 40, 5, 1, True, True),
    (240, 40, 5, 1, True, True),
    (120, 48, 5, 1, True, True),
    (144, 48, 5, 1, True, True),
    (288, 96, 5, 2, True, True),
    (576, 96, 5, 1, True, True),
    (576, 96, 5, 1, True, True),
)


class MobileNetV3Small(nn.Module):
    """The reference's v3 'small' variant."""

    def __init__(self, num_classes: int = 10, in_channels: int = 3):
        super().__init__()
        self.Conv_0 = Conv(in_channels, 16, (3, 3), (2, 2), use_bias=False)
        self.GroupNorm_0 = GroupNorm(8, 16)
        ch = 16
        for i, (expand, filters, kernel, stride, se, swish) in enumerate(_V3_SMALL):
            self.add_module(f"InvertedResidual_{i}",
                            InvertedResidual(ch, expand, filters, kernel, stride, se, swish))
            ch = filters
        self.Conv_1 = Conv(ch, 576, (1, 1), use_bias=False)
        self.GroupNorm_1 = GroupNorm(8, 576)
        self.Dense_0 = nn.Linear(576, 1024)
        self.Dense_1 = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = hard_swish(self.GroupNorm_0(self.Conv_0(nhwc_to_nchw(x))))
        for i in range(len(_V3_SMALL)):
            x = getattr(self, f"InvertedResidual_{i}")(x)
        x = hard_swish(self.GroupNorm_1(self.Conv_1(x)))
        x = hard_swish(self.Dense_0(x.mean(dim=(2, 3))))
        return self.Dense_1(x)
