"""Model factory keyed on (model_name, dataset): counterpart of
``fedml_tpu/models/model_hub.py`` (reference
``python/fedml/model/model_hub.py:19``).

:func:`create` returns a :class:`FedModel`: a torch module on the run's
device, the state dict it was created with, and the input spec. Parameters
travel as state dicts (``utils/pytree.py``), so aggregation never touches
the module. The port has the vision and linear models of the FedAvg path;
every other name of the JAX hub raises NotImplementedError.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .cnn import CNNCifar, CNNDropOut
from .layers import flax_init_
from .linear import LogisticRegression, TwoNN
from ..utils.pytree import tree_clone
from .resnet import ResNet18GN, resnet20, resnet56

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass
class FedModel:
    """Model handle: a torch module on ``device``, the state dict it was
    created with (``params``, storage of its own: training the module does
    not move it) and the input spec."""

    module: nn.Module
    params: Optional[StateDict]
    input_shape: Tuple[int, ...]
    name: str = "model"

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def apply(self, params: StateDict, x: torch.Tensor, train: bool = False,
              rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """The module's forward with ``params`` in place of its own."""
        return torch.func.functional_call(self.module, params, (x,), {"train": train, "rng": rng})

    def init_params(self, seed: int = 0) -> StateDict:
        """Fresh parameters drawn as flax's defaults draw them, from a CPU
        generator seeded with ``seed`` and then moved to the device, so every
        device starts from the same values. Loads them into the module."""
        probe = copy.deepcopy(self.module).to("cpu")
        flax_init_(probe, torch.Generator().manual_seed(int(seed)))
        self.module.load_state_dict(probe.state_dict())
        return tree_clone(self.module.state_dict())

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())


_INPUT_SPECS = {
    # dataset -> example input shape [B=1] (NHWC images, flat features)
    "mnist": (1, 28, 28, 1),
    "femnist": (1, 28, 28, 1),
    "fashion_mnist": (1, 28, 28, 1),
    "cifar10": (1, 32, 32, 3),
    "cifar100": (1, 32, 32, 3),
    "cinic10": (1, 32, 32, 3),
    "fed_cifar100": (1, 32, 32, 3),
    "synthetic": (1, 60),
    # the surrogates' 64x64 sets: torch sizes the stem by its input channels
    # up front, where flax sizes itself at its first call
    "imagenet": (1, 64, 64, 3),
    "gld23k": (1, 64, 64, 3),
    "landmarks": (1, 64, 64, 3),
}

_PORTED = ("lr", "logistic_regression", "mlp", "two_nn", "cnn", "cnn_dropout", "cnn_cifar",
           "resnet56", "resnet", "resnet20", "resnet18", "resnet18_gn")

# the rest of the JAX hub, not ported yet
_NOT_PORTED = ("distilbert", "bert", "text_classifier", "transformer_cls", "rnn", "rnn_fedavg",
               "rnn_stackoverflow", "rnn_nwp", "mobilenet", "mobilenet_v3", "gan", "cgan",
               "dcgan", "darts", "nas", "fednas", "unet", "segnet", "deeplab", "llama", "gpt",
               "transformer")


def input_spec_for(dataset: str) -> Tuple[int, ...]:
    return _INPUT_SPECS.get(dataset, (1, 28, 28, 1))


def _build(model_name: str, num_classes: int, in_shape: Tuple[int, ...]) -> nn.Module:
    image = len(in_shape) == 4
    flat = int(np.prod(in_shape[1:]))
    if model_name in ("lr", "logistic_regression"):
        return LogisticRegression(flat, num_classes)
    if model_name in ("mlp", "two_nn"):
        return TwoNN(flat, num_classes=num_classes)
    if model_name in ("cnn", "cnn_dropout", "cnn_cifar", "resnet56", "resnet", "resnet20",
                      "resnet18", "resnet18_gn") and not image:
        raise ValueError(f"model {model_name!r} needs NHWC image inputs, got shape {in_shape}")
    hwc = tuple(in_shape[1:])
    if model_name in ("cnn", "cnn_dropout"):
        cls = CNNDropOut if in_shape[1] == 28 else CNNCifar
        return cls(num_classes=num_classes, in_shape=hwc)
    if model_name == "cnn_cifar":
        return CNNCifar(num_classes=num_classes, in_shape=hwc)
    if model_name in ("resnet56", "resnet"):
        return resnet56(num_classes=num_classes, in_channels=hwc[-1])
    if model_name == "resnet20":
        return resnet20(num_classes=num_classes, in_channels=hwc[-1])
    return ResNet18GN(num_classes=num_classes, in_channels=hwc[-1])


def create(args: Any, output_dim: Optional[int] = None, seed: Optional[int] = None,
           device: Any = None) -> FedModel:
    """Mirror of the JAX package's ``model_hub.create``. ``device`` defaults
    to ``get_device(args)``: CUDA unless ``args.using_gpu`` is false."""
    model_name = str(getattr(args, "model", "lr")).lower()
    dataset = str(getattr(args, "dataset", "mnist")).lower()
    num_classes = int(output_dim or getattr(args, "output_dim", 10))
    seed = int(seed if seed is not None else getattr(args, "random_seed", 0))
    in_shape = tuple(getattr(args, "input_shape", None) or input_spec_for(dataset))
    if model_name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {model_name!r} is not ported to fedml_tpu_torch yet; the port has "
            f"{', '.join(_PORTED)} (see ROADMAP.md, Queue 1)")
    if model_name not in _PORTED:
        raise ValueError(f"unknown model {model_name!r}")
    if getattr(args, "pretrained_path", None):
        raise NotImplementedError(
            "pretrained_path: loading pretrained weights is not ported to fedml_tpu_torch "
            "yet (see ROADMAP.md, Queue 1)")
    if device is None:
        from ..device import get_device

        device = get_device(args)
    module = _build(model_name, num_classes, in_shape).to(device)
    model = FedModel(module=module, params=None, input_shape=in_shape, name=model_name)
    model.params = model.init_params(seed)
    return model
