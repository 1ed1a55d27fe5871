"""Model factory keyed on (model_name, dataset): counterpart of
``fedml_tpu/models/model_hub.py`` (reference
``python/fedml/model/model_hub.py:19``).

:func:`create` returns a :class:`FedModel`: a torch module on the run's
device, the state dict it was created with, and the input spec with its
dtype. Parameters travel as state dicts (``utils/pytree.py``), so
aggregation never touches the module. The port has every model of the JAX
hub: vision, text, GAN, DARTS, segmentation and the LLM names (``llama``,
``gpt``, ``transformer``: ``TransformerLM`` from
``TransformerConfig.from_args``). ``pretrained_path`` loads weights over
the fresh ones (:func:`load_pretrained`).
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .cnn import CNNCifar, CNNDropOut
from .layers import flax_init_
from .linear import LogisticRegression, TwoNN
from ..utils.pytree import tree_clone
from .resnet import ResNet18GN, resnet20, resnet56
from .transformer import TransformerConfig, TransformerLM

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass
class FedModel:
    """Model handle: a torch module on ``device``, the state dict it was
    created with (``params``, storage of its own: training the module does
    not move it) and the input spec."""

    module: nn.Module
    params: Optional[StateDict]
    input_shape: Tuple[int, ...]
    input_dtype: torch.dtype = torch.float32
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


_F32, _I32 = torch.float32, torch.int32

_INPUT_SPECS = {
    # dataset -> (example input shape [B=1], dtype): NHWC images, flat
    # features, int token ids
    "mnist": ((1, 28, 28, 1), _F32),
    "femnist": ((1, 28, 28, 1), _F32),
    "fashion_mnist": ((1, 28, 28, 1), _F32),
    "cifar10": ((1, 32, 32, 3), _F32),
    "cifar100": ((1, 32, 32, 3), _F32),
    "cinic10": ((1, 32, 32, 3), _F32),
    "fed_cifar100": ((1, 32, 32, 3), _F32),
    "synthetic": ((1, 60), _F32),
    "shakespeare": ((1, 80), _I32),
    "fed_shakespeare": ((1, 80), _I32),
    "stackoverflow_nwp": ((1, 20), _I32),
    "reddit": ((1, 64), _I32),
    "stackoverflow_lr": ((1, 10000), _F32),
    # FedNLP text classification (BASELINE config 3)
    "20news": ((1, 128), _I32),
    "agnews": ((1, 64), _I32),
    "sst2": ((1, 32), _I32),
    "semeval_2010_task8": ((1, 64), _I32),
    # the surrogates' 64x64 sets: torch sizes the stem by its input channels
    # up front, where flax sizes itself at its first call
    "imagenet": ((1, 64, 64, 3), _F32),
    "gld23k": ((1, 64, 64, 3), _F32),
    "landmarks": ((1, 64, 64, 3), _F32),
}

# vocab sizes of data/sources.py load_text_classification_dataset's specs
_TEXT_CLS_VOCAB = {"20news": 5000, "agnews": 5000, "sst2": 3000, "semeval_2010_task8": 4000}

_IMAGE_MODELS = ("cnn", "cnn_dropout", "cnn_cifar", "resnet56", "resnet", "resnet20", "resnet18",
                 "resnet18_gn", "mobilenet", "mobilenet_v3", "darts", "nas", "fednas")
_LLM_MODELS = ("llama", "gpt", "transformer")
_PORTED = ("lr", "logistic_regression", "mlp", "two_nn") + _IMAGE_MODELS + (
    "distilbert", "bert", "text_classifier", "transformer_cls", "rnn", "rnn_fedavg",
    "rnn_stackoverflow", "rnn_nwp", "efficientnet*", "gan", "cgan", "dcgan", "unet", "segnet",
    "deeplab") + _LLM_MODELS


def input_spec_for(dataset: str) -> Tuple[Tuple[int, ...], torch.dtype]:
    return _INPUT_SPECS.get(dataset, ((1, 28, 28, 1), _F32))


def _build(model_name: str, num_classes: int, in_shape: Tuple[int, ...], args: Any,
           dataset: str) -> Tuple[nn.Module, Optional[Tuple[Tuple[int, ...], torch.dtype]]]:
    """The module, and the input spec when the model fixes its own."""
    image = len(in_shape) == 4
    flat = int(np.prod(in_shape[1:]))
    if model_name in _LLM_MODELS:
        return _HubTransformerLM(TransformerConfig.from_args(args)), \
            ((1, int(getattr(args, "seq_len", 128))), _I32)
    if model_name in ("lr", "logistic_regression"):
        return LogisticRegression(flat, num_classes), None
    if model_name in ("mlp", "two_nn"):
        return TwoNN(flat, num_classes=num_classes), None
    if (model_name in _IMAGE_MODELS or model_name.startswith("efficientnet")) and not image:
        raise ValueError(f"model {model_name!r} needs NHWC image inputs, got shape {in_shape}")
    hwc = tuple(in_shape[1:])
    if model_name in ("cnn", "cnn_dropout"):
        cls = CNNDropOut if in_shape[1] == 28 else CNNCifar
        return cls(num_classes=num_classes, in_shape=hwc), None
    if model_name == "cnn_cifar":
        return CNNCifar(num_classes=num_classes, in_shape=hwc), None
    if model_name in ("resnet56", "resnet"):
        return resnet56(num_classes=num_classes, in_channels=hwc[-1]), None
    if model_name == "resnet20":
        return resnet20(num_classes=num_classes, in_channels=hwc[-1]), None
    if model_name in ("resnet18", "resnet18_gn"):
        return ResNet18GN(num_classes=num_classes, in_channels=hwc[-1]), None
    if model_name in ("distilbert", "bert", "text_classifier", "transformer_cls"):
        from .text_classifier import distilbert_shape

        return distilbert_shape(
            num_classes=num_classes,
            vocab_size=int(getattr(args, "vocab_size", 0) or _TEXT_CLS_VOCAB.get(dataset, 5000)),
            max_seq_len=in_shape[1],
            d_model=int(getattr(args, "text_d_model", 256)),
            n_layers=int(getattr(args, "text_n_layers", 4)),
            n_heads=int(getattr(args, "text_n_heads", 4)),
            d_ff=int(getattr(args, "text_d_ff", 1024)),
        ), None
    if model_name in ("rnn", "rnn_fedavg"):
        from .rnn import RNNOriginalFedAvg

        # the vocab follows the loaded data (output_dim is the vocab of a
        # language-model dataset), as in the JAX hub
        return RNNOriginalFedAvg(vocab_size=num_classes), None
    if model_name in ("rnn_stackoverflow", "rnn_nwp"):
        from .rnn import RNNStackOverflow

        return RNNStackOverflow(), None
    if model_name == "mobilenet":
        from .mobilenet import MobileNetV1

        return MobileNetV1(num_classes=num_classes, in_channels=hwc[-1]), None
    if model_name == "mobilenet_v3":
        from .mobilenet import MobileNetV3Small

        return MobileNetV3Small(num_classes=num_classes, in_channels=hwc[-1]), None
    if model_name.startswith("efficientnet"):
        from .efficientnet import efficientnet_lite0

        return efficientnet_lite0(num_classes=num_classes, in_channels=hwc[-1]), None
    if model_name in ("gan", "cgan", "dcgan"):
        from .gan import GANPair

        hw = in_shape[1] if image else 28
        ch = in_shape[-1] if image else 1
        return GANPair(image_hw=hw, channels=ch), ((1, 64), _F32)  # the latent z
    if model_name in ("darts", "nas", "fednas"):
        from .darts import DARTSNetwork

        return DARTSNetwork(
            num_classes=num_classes,
            width=int(getattr(args, "darts_width", 16)),
            layers=int(getattr(args, "darts_layers", 3)),
            steps=int(getattr(args, "darts_steps", 3)),
            in_channels=hwc[-1],
        ), None
    from .segmentation import SegNetLite  # unet, segnet, deeplab

    return SegNetLite(num_classes=num_classes), ((1, 32, 32, 3), _F32)


def create(args: Any, output_dim: Optional[int] = None, seed: Optional[int] = None,
           device: Any = None) -> FedModel:
    """Mirror of the JAX package's ``model_hub.create``. ``device`` defaults
    to ``get_device(args)``: CUDA unless ``args.using_gpu`` is false."""
    model_name = str(getattr(args, "model", "lr")).lower()
    dataset = str(getattr(args, "dataset", "mnist")).lower()
    num_classes = int(output_dim or getattr(args, "output_dim", 10))
    seed = int(seed if seed is not None else getattr(args, "random_seed", 0))
    in_shape, in_dtype = input_spec_for(dataset)
    # the loader records the loaded table's width where it differs from the
    # dataset's preset (models/model_hub.py in the JAX package)
    in_shape = tuple(getattr(args, "input_shape", None) or in_shape)
    if model_name not in _PORTED and not model_name.startswith("efficientnet"):
        raise ValueError(f"unknown model {model_name!r}")
    if device is None:
        from ..device import get_device

        device = get_device(args)
    module, spec = _build(model_name, num_classes, in_shape, args, dataset)
    if spec is not None:
        in_shape, in_dtype = spec
    model = FedModel(module=module.to(device), params=None, input_shape=in_shape,
                     input_dtype=in_dtype, name=model_name)
    model.params = model.init_params(seed)
    pretrained = getattr(args, "pretrained_path", None)
    if pretrained:
        model.params = load_pretrained(model.params, str(pretrained))
        model.module.load_state_dict(model.params)
    return model


class _HubTransformerLM(TransformerLM):
    """``TransformerLM`` under the hub's contract: ``FedModel.apply`` passes
    ``train``/``rng`` (the LM has no dropout), and ``flax_init_`` draws its
    parameters through ``flax_init`` (``TransformerLM.reset_parameters``)."""

    def forward(self, tokens: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return super().forward(tokens)

    def flax_init(self, generator: torch.Generator) -> None:
        self.reset_parameters(generator)


def load_pretrained(template: StateDict, path: str) -> StateDict:
    """Pretrained weights over ``template`` (a state dict), as the JAX hub's
    ``load_pretrained`` takes them: an HF llama safetensors directory (has a
    ``config.json``; through ``train/llm/checkpoint_import``), a flat
    ``.npz`` keyed by the JAX package's '/'-joined flax paths (JAX's
    ``save_pretrained_npz``; each kernel in flax's layout, mapped through
    ``models/convert.py``), or a directory of this package's
    ``utils/checkpoint.CheckpointManager`` (its newest step: a state dict, or
    a flax-layout tree of tensors as the LLM trainer saves). Returns a new
    state dict on the template's devices and dtypes.

    A JAX (orbax) checkpoint directory cannot be read without orbax, which
    the port does not load: it raises ValueError (ROADMAP.md, Queue 3)."""
    from .convert import flax_leaf, flax_name, params_from_jax, torch_leaf

    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "config.json")):
            from ..train.llm.checkpoint_import import config_from_hf, import_hf_checkpoint

            loaded = params_from_jax(import_hf_checkpoint(path, config_from_hf(path)))
        else:
            loaded = _restore_checkpoint_dir(path)
    elif path.endswith(".npz"):
        loaded = {}
        with np.load(path) as z:
            for name, leaf in template.items():
                key = flax_name(name)
                if key not in z:
                    raise KeyError(f"pretrained npz missing {key!r}")
                arr = z[key]
                want = tuple(flax_leaf(name, leaf).shape)
                if tuple(arr.shape) != want:
                    raise ValueError(f"{key}: shape {arr.shape} != {want}")
                loaded[name] = torch_leaf(name, torch.from_numpy(np.array(arr)))
    else:
        raise ValueError(f"unsupported pretrained weight source {path!r}")
    out = {}
    for name, leaf in template.items():
        value = loaded.get(name, leaf)
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(leaf.shape)}")
        out[name] = value.to(device=leaf.device, dtype=leaf.dtype).clone()
    unknown = sorted(set(loaded) - set(template))
    if unknown:
        raise KeyError(f"pretrained weights hold names the model lacks: {unknown[:5]}")
    return out


def _restore_checkpoint_dir(path: str) -> StateDict:
    from ..utils.checkpoint import CheckpointManager
    from .convert import params_from_jax

    names = os.listdir(path)
    if not any(n.startswith("step_") and n.endswith(".pt") for n in names):
        if any(n.isdigit() and os.path.isdir(os.path.join(path, n)) for n in names):
            raise ValueError(
                f"{path} is a JAX (orbax) checkpoint directory; fedml_tpu_torch does not read "
                "orbax checkpoints (see ROADMAP.md, Queue 3): save the params with the JAX "
                "package's save_pretrained_npz and pass the .npz")
        raise FileNotFoundError(f"no checkpoint found under {path}")
    restored = CheckpointManager(path).restore()
    if restored is None:
        raise FileNotFoundError(f"no checkpoint found under {path}")
    if any(isinstance(v, dict) for v in restored.values()):
        return params_from_jax(restored)  # a flax-layout tree (the LLM trainer's saves)
    return dict(restored)
