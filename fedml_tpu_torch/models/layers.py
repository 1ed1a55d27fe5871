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
- ``Conv`` takes flax's ``feature_group_count`` (``groups``: depthwise
  kernels ``[kh, kw, 1, C]`` are the port's ``[C, 1, kh, kw]``) and
  ``kernel_dilation``; SAME pads over the dilated kernel ``(k-1)*d+1``.
- ``ConvTranspose`` is flax's ``nn.ConvTranspose(padding="SAME")`` with
  ``transpose_kernel=False``: ``lax.conv_transpose``, a correlation of the
  unflipped kernel over the zero-inserted input, padded as
  :func:`conv_transpose_padding` says. torch's transposed convolution
  correlates with the kernel flipped and pads both sides alike, so the
  weight goes in flipped, and an uneven pair (k=3, s=2 pads (2, 1)) is
  padded as its larger half and the extra row and column cropped.
- ``avg_pool_same`` counts the padding, as flax's ``nn.avg_pool`` does.
- ``LayerNorm`` holds flax's ``scale``/``bias`` with its epsilon, 1e-6.
- ``Embed`` holds flax's ``embedding`` leaf ``[V, D]`` (a leaf named
  ``weight`` would be transposed by models/convert.py).
- ``DenseGeneral`` keeps flax's kernel layout, ``[*in, *out]`` (the
  attention's ``[d, H, hd]`` and ``[H, hd, d]``), which models/convert.py
  passes through as it is.
- ``LSTMCell`` holds flax's leaves (``ii``/``if``/``ig``/``io`` without
  bias, ``hi``/``hf``/``hg``/``ho`` with); :func:`lstm` runs a stack of them
  as ``torch.lstm`` (cuDNN on the card), the cell's four kernels of a kind
  concatenated in torch's gate order, i, f, g, o.
- ``gelu`` is the tanh form, flax's default (torch's default is exact);
  ``relu6``, ``hard_sigmoid`` and ``hard_swish`` are written as the JAX
  package writes them (``models/mobilenet.py``).
- ``flax_init_`` draws every kernel as flax's default ``lecun_normal`` does
  (a normal truncated at two standard deviations, variance 1/fan_in), the
  LSTM's recurrent kernels ``orthogonal``, embeddings a plain normal of
  variance 1/width, biases 0, norm scales 1; a module with a
  ``flax_init(generator)`` method draws its own leaves.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GROUP_NORM_EPS = 1e-6  # flax.linen.GroupNorm's default
LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``padding="SAME"`` for one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_transpose_padding(kernel: int, stride: int) -> Tuple[int, int]:
    """``lax._conv_transpose_padding(k, s, "SAME")``: the (before, after)
    padding of the zero-inserted input."""
    pad_len = kernel + stride - 2
    before = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return before, pad_len - before


def _pads(x: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int]):
    return [same_padding(x.shape[2 + i], kernel[i], stride[i]) for i in (0, 1)]


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel, strides, feature_group_count=groups,
    kernel_dilation=dilation)`` with ``padding="SAME"`` on NCHW: ``weight``
    is [out, in/groups, kh, kw] (flax's kernel is [kh, kw, in/groups, out];
    models/convert.py maps one to the other)."""

    def __init__(self, in_features: int, features: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), use_bias: bool = True, groups: int = 1,
                 dilation: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.groups, self.dilation = groups, tuple(dilation)
        self.weight = nn.Parameter(torch.empty(features, in_features // groups, *self.kernel))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        span = tuple((k - 1) * d + 1 for k, d in zip(self.kernel, self.dilation))
        (h0, h1), (w0, w1) = _pads(x, span, self.stride)
        if h0 == h1 and w0 == w1:
            return F.conv2d(x, self.weight, self.bias, self.stride, (h0, w0), self.dilation,
                            self.groups)
        return F.conv2d(F.pad(x, (w0, w1, h0, h1)), self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, kernel, strides)`` with
    ``padding="SAME"`` on NCHW; ``weight`` is [out, in, kh, kw], as ``Conv``'s
    (flax's kernel is [kh, kw, in, out])."""

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
        pads = [conv_transpose_padding(k, s) for k, s in zip(self.kernel, self.stride)]
        # torch pads k-1-p before and k-1-p+output_padding after
        padding = tuple(k - 1 - a for k, (a, _) in zip(self.kernel, pads))
        extra = tuple(max(b - a, 0) for a, b in pads)
        y = F.conv_transpose2d(x, self.weight.flip(2, 3).transpose(0, 1), self.bias,
                               self.stride, padding, extra)
        crop = [max(a - b, 0) for a, b in pads]
        return y[:, :, :y.shape[2] - crop[0], :y.shape[3] - crop[1]]


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


def avg_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax ``nn.avg_pool(x, (w, w), strides=(s, s), padding="SAME")``: the
    zero padding counts in the mean."""
    (h0, h1), (w0, w1) = _pads(x, (window, window), (stride, stride))
    return F.avg_pool2d(F.pad(x, (w0, w1, h0, h1)), window, stride)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` over the last dim."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.scale.shape, self.scale, self.bias, LAYER_NORM_EPS)


class Embed(nn.Module):
    """flax ``nn.Embed(num_embeddings, features)``."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.embedding)


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` from the last ``len(in_shape)`` dims to
    ``out_shape``; ``weight`` is flax's kernel ``[*in_shape, *out_shape]``."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...]):
        super().__init__()
        self.n_in = len(in_shape)
        self.weight = nn.Parameter(torch.empty(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.empty(*out_shape))

    @property
    def fan_in(self) -> int:
        return math.prod(self.weight.shape[:self.n_in])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(x, self.weight, dims=self.n_in) + self.bias


LSTM_GATES = ("i", "f", "g", "o")  # torch's gate order


class LSTMCell(nn.Module):
    """flax ``nn.LSTMCell(hidden)``: i, f, o = sigmoid(x W_i* + h W_h* + b_h*),
    g = tanh(...), c' = f c + i g, h' = o tanh(c')."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in LSTM_GATES:  # "if" is a keyword: registered by name
            self.add_module("i" + g, nn.Linear(in_features, hidden, bias=False))
        for g in LSTM_GATES:
            self.add_module("h" + g, nn.Linear(hidden, hidden))

    def torch_params(self):
        """(w_ih [4H, in], w_hh [4H, H], b_ih 0, b_hh [4H]) in torch's layout."""
        w_ih = torch.cat([getattr(self, "i" + g).weight for g in LSTM_GATES])
        w_hh = torch.cat([getattr(self, "h" + g).weight for g in LSTM_GATES])
        b_hh = torch.cat([getattr(self, "h" + g).bias for g in LSTM_GATES])
        return [w_ih, w_hh, torch.zeros_like(b_hh), b_hh]


def lstm(x: torch.Tensor, cell: LSTMCell) -> torch.Tensor:
    """flax ``nn.RNN(cell)`` over [B, T, in] from a zero carry: the hidden
    state of every step, [B, T, H]."""
    h0 = x.new_zeros(1, x.shape[0], cell.hidden)
    # train=True: cuDNN runs no backward of an inference-mode RNN; with no
    # dropout between layers the flag changes nothing else
    out, _, _ = torch.lstm(x, (h0, h0), cell.torch_params(), True, 1, 0.0, True, False, True)
    return out


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` (``approximate=True``)."""
    return F.gelu(x, approximate="tanh")


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator], shape: Optional[Tuple[int, ...]] = None
            ) -> torch.Tensor:
    """flax ``nn.Dropout(rate, deterministic=not train)``; ``shape`` draws a
    mask that broadcasts over ``x`` (flax's attention dropout draws one
    [T, T] mask for every example and head)."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(shape or x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """The models' one layout change: NHWC data in, NCHW activations on."""
    return x.permute(0, 3, 1, 2).contiguous()


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # the std of a unit normal truncated to [-2, 2] is 0.8796..., so the
    # draw is widened to keep variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``module``'s parameters as flax's defaults do, in registration
    order from ``generator`` (see the module docstring)."""
    recurrent = {id(getattr(sub, "h" + g)) for sub in module.modules()
                 if isinstance(sub, LSTMCell) for g in LSTM_GATES}
    for sub in module.modules():
        if isinstance(sub, (Conv, ConvTranspose, nn.Linear, DenseGeneral)):
            if id(sub) in recurrent:
                nn.init.orthogonal_(sub.weight, generator=generator)
            else:
                fan_in = sub.fan_in if isinstance(sub, DenseGeneral) else sub.weight[0].numel()
                _lecun_normal_(sub.weight, fan_in, generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, (GroupNorm, LayerNorm)):
            sub.scale.fill_(1.0)
            sub.bias.zero_()
        elif isinstance(sub, Embed):
            # variance_scaling(1, fan_in, normal): the fan is the width
            sub.embedding.normal_(0.0, math.sqrt(1.0 / sub.embedding.shape[1]),
                                  generator=generator)
        if hasattr(sub, "flax_init"):
            sub.flax_init(generator)
    return module
