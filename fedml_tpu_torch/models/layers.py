"""The flax layers the vision models use, as torch modules.

The JAX models are flax modules on NHWC data; the port's run on NCHW (each
model permutes its NHWC input once, at its entry). What the two layouts do
not share is written out here:

- ``Conv`` pads as flax's ``padding="SAME"`` does: the total padding
  ``max((ceil(n/s)-1)*s + k - n, 0)`` of each spatial dim, its smaller half
  before and the larger after. With stride 2 on an even input that is (0, 1),
  where torch's ``padding=1`` would pad (1, 1): the output shapes agree and
  the values do not. An asymmetric pair goes through ``F.pad``; a symmetric
  one is the convolution's own padding.
- ``GroupNorm`` holds flax's ``scale`` and ``bias`` (torch's would be
  ``weight`` and ``bias``) and uses flax's epsilon, 1e-6 (torch's is 1e-5).
- ``dropout`` draws its mask from a ``torch.Generator``, so a seeded round
  repeats (torch's ``F.dropout`` takes no generator); like flax it keeps an
  element with probability ``1 - rate`` and scales it by ``1 / (1 - rate)``.
- ``flax_init_`` draws every kernel as flax's default ``lecun_normal`` does
  (a normal truncated at two standard deviations, variance 1/fan_in), biases
  0, norm scales 1.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GROUP_NORM_EPS = 1e-6  # flax.linen.GroupNorm's default


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``padding="SAME"`` for one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int]):
    return [same_padding(x.shape[2 + i], kernel[i], stride[i]) for i in (0, 1)]


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel, strides)`` with ``padding="SAME"`` on
    NCHW: ``weight`` is [out, in, kh, kw] (flax's kernel is [kh, kw, in, out];
    models/convert.py maps one to the other)."""

    def __init__(self, in_features: int, features: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), use_bias: bool = True):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.weight = nn.Parameter(torch.empty(features, in_features, *self.kernel))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h0, h1), (w0, w1) = _pads(x, self.kernel, self.stride)
        if h0 == h1 and w0 == w1:
            return F.conv2d(x, self.weight, self.bias, self.stride, (h0, w0))
        return F.conv2d(F.pad(x, (w0, w1, h0, h1)), self.weight, self.bias, self.stride)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` over the channels of NCHW."""

    def __init__(self, num_groups: int, features: int):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.scale, self.bias, GROUP_NORM_EPS)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax ``nn.max_pool(x, (w, w), strides=(s, s), padding="SAME")``: the
    padding is -inf, so it never wins."""
    (h0, h1), (w0, w1) = _pads(x, (window, window), (stride, stride))
    return F.max_pool2d(F.pad(x, (w0, w1, h0, h1), value=-math.inf), window, stride)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate, deterministic=not train)``."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """The models' one layout change: NHWC data in, NCHW activations on."""
    return x.permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``module``'s parameters as flax's defaults do, in registration
    order from ``generator``: kernels lecun_normal, biases 0, scales 1."""
    for sub in module.modules():
        if isinstance(sub, (Conv, nn.Linear)):
            fan_in = sub.weight[0].numel()
            # lecun_normal: the std of a unit normal truncated to [-2, 2] is
            # 0.8796..., so the draw is widened to keep variance 1/fan_in
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(sub.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, GroupNorm):
            sub.scale.fill_(1.0)
            sub.bias.zero_()
    return module
