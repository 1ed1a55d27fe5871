"""Weight layout converter between the JAX package and the port.

The JAX params are a nested dict with flax path names
(``layer_0/attn/q_proj/kernel``); the port's state is a flat state dict
(``layer_0.attn.q_proj.weight``). Paths map one to one. The only layout
change is the dense kernel: flax ``Dense`` stores ``kernel [in, out]``, the
port stores ``weight [out, in]`` as ``nn.Linear`` does, so it is
transposed. The embedding ``[V, D]``, norm scales ``[D]`` and LoRA factors
(``lora_a [in, r]``, ``lora_b [r, out]``) keep their shapes. The adapter
subtree (``layer_i/attn/q_proj/lora_a``, ...) is the WAN wire layout, so a
JAX server can fold adapters trained here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn


def _torch_name(path) -> str:
    *head, leaf = path
    return ".".join(head + ["weight" if leaf == "kernel" else leaf])


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (flax layout) -> the port's state dict.
    Works on a partial tree (e.g. adapters only)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + [k])
                continue
            arr = np.asarray(v)
            if k == "kernel":
                arr = arr.T
            # a C-ordered copy: JAX hands out read-only arrays
            out[_torch_name(path + [k])] = torch.from_numpy(np.array(arr, order="C"))

    walk(tree, [])
    return out


def params_to_jax(model: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict:
    """The port's model (or a state dict, or part of one) -> nested dict of
    numpy arrays in the flax layout."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    out: Dict = {}
    for name, t in state.items():
        *head, leaf = name.split(".")
        arr = t.detach().cpu().numpy()
        if leaf == "weight":
            leaf, arr = "kernel", arr.T
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out
