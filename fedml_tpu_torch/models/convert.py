"""Weight layout converter between the JAX package and the port.

The JAX params are a nested dict with flax path names
(``layer_0/attn/q_proj/kernel``); the port's state is a flat state dict
(``layer_0.attn.q_proj.weight``). Paths map one to one: the port's modules
carry flax's names, auto-names included (``BasicBlock_26/Conv_0``). The
only layout change is the kernel, which the port calls ``weight``:

- flax ``Dense`` stores ``kernel [in, out]``, the port ``weight [out, in]``
  as ``nn.Linear`` does: transposed;
- flax ``Conv`` stores ``kernel [kh, kw, in, out]`` (HWIO), the port
  ``weight [out, in, kh, kw]`` (OIHW) as ``F.conv2d`` takes it:
  ``transpose(3, 2, 0, 1)``, and back ``transpose(2, 3, 1, 0)``.

Everything else keeps its name and shape: the embedding ``[V, D]``, norm
scales ``[D]`` (flax's GroupNorm ``scale``/``bias`` are the port's
GroupNorm's own names, models/layers.py), biases, and the LoRA factors
(``lora_a [in, r]``, ``lora_b [r, out]``). The adapter subtree
(``layer_i/attn/q_proj/lora_a``, ...) is the WAN wire layout, so a JAX
server can fold adapters trained here; the cross-silo message plane sends
every model payload that leaves the process in this layout
(``core/distributed/fedml_comm_manager.py``).

Leaves are numpy arrays, except bfloat16 ones: numpy has no bfloat16 without
``ml_dtypes`` (a JAX dependency the port does not load), so those stay CPU
tensors in the flax layout, and the wire codec carries them bit-exactly.
``params_from_jax`` takes numpy arrays and tensors alike.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn


def _kernel_to_torch(t: torch.Tensor) -> torch.Tensor:
    return t.T if t.ndim == 2 else t.permute(3, 2, 0, 1)


def _weight_to_flax(t: torch.Tensor) -> torch.Tensor:
    return t.T if t.ndim == 2 else t.permute(2, 3, 1, 0)


def _torch_name(path) -> str:
    *head, leaf = path
    return ".".join(head + ["weight" if leaf == "kernel" else leaf])


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays or tensors (flax layout) -> the port's
    state dict of CPU tensors. Works on a partial tree (e.g. adapters
    only)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + [k])
                continue
            if isinstance(v, torch.Tensor):
                t = v.detach().cpu()
            else:
                arr = np.array(v)  # writable: JAX hands out read-only arrays
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
                    if arr.dtype.name == "bfloat16" else torch.from_numpy(arr)
            if k == "kernel":
                t = _kernel_to_torch(t)
            # a contiguous copy that shares no storage with the input
            out[_torch_name(path + [k])] = t.clone(memory_format=torch.contiguous_format)

    walk(tree, [])
    return out


def params_to_jax(model: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict:
    """The port's model (or a state dict, or part of one) -> nested dict of
    numpy arrays (bfloat16: CPU tensors) in the flax layout."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    out: Dict = {}
    for name, t in state.items():
        *head, leaf = name.split(".")
        t = t.detach().cpu()
        if leaf == "weight":
            leaf, t = "kernel", _weight_to_flax(t)
        # a contiguous copy that shares no storage with the model
        t = t.clone(memory_format=torch.contiguous_format)
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = t if t.dtype == torch.bfloat16 else t.numpy()
    return out
