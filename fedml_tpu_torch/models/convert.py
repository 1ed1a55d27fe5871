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

The split halves of split NN and FedGKT (``models/split_model.py``) carry
flax's names too (``Conv_0``, ``BasicBlock_i``, ``client_head``,
``Dense_0``), so each half converts the same way.

- an int8 dense (``serving/quant.py``) keeps its names, ``kernel_q`` and
  ``kernel_scale``; ``kernel_q`` is transposed as a 2-D kernel is (flax
  ``[in, out]``, the port ``[out, in]``), ``kernel_scale [out]`` is not;

- a kernel of any other rank keeps flax's layout: the attention's
  ``DenseGeneral`` kernels ``[d, H, hd]`` and ``[H, hd, d]``
  (``models/layers.py``), which the port contracts as they are.

- the MoE MLP's parameters are not Dense kernels and keep flax's names and
  layout both ways: the router ``[D, E]`` and the expert stacks ``w_gate``
  and ``w_up`` ``[E, D, F]`` and ``w_down`` ``[E, F, D]`` are used as
  ``h @ w`` in both packages (``models/moe.py``), so flipping them the way
  a Dense kernel is flipped would be wrong.

Everything else keeps its name and shape: the embedding ``[V, D]``, norm
scales ``[D]`` (flax's GroupNorm ``scale``/``bias`` are the port's
GroupNorm's own names, models/layers.py), biases, and the LoRA factors
(``lora_a [in, r]``, ``lora_b [r, out]``). The adapter subtree
(``layer_i/attn/q_proj/lora_a``, ...) is the WAN wire layout, so a JAX
server can fold adapters trained here; the cross-silo message plane sends
every model payload that leaves the process in this layout
(``core/distributed/fedml_comm_manager.py``).

The flat wire vector (:func:`wire_vector`, :func:`state_from_wire_vector`)
is the JAX package's ``tree_flatten_to_vector`` of that tree: the leaves in
flax's order (each dict's keys sorted by name, so the paths sorted) and each
kernel raveled in its flax layout. The masked SecAgg uplink, its shared
sparse support and the unmasked publish all index this vector, so a port
client's masked vector equals a JAX client's for the same weights.

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
    if t.ndim == 2:
        return t.T
    return t.permute(3, 2, 0, 1) if t.ndim == 4 else t


def _weight_to_flax(t: torch.Tensor) -> torch.Tensor:
    if t.ndim == 2:
        return t.T
    return t.permute(2, 3, 1, 0) if t.ndim == 4 else t


def _flax_path(name: str) -> tuple:
    *head, leaf = name.split(".")
    return tuple(head + ["kernel" if leaf == "weight" else leaf])


def _is_kernel(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("weight", "kernel_q")


def flax_name(name: str) -> str:
    """The flax path of a state-dict name, ``/``-joined
    (``Dense_0.weight`` -> ``Dense_0/kernel``)."""
    return "/".join(_flax_path(name))


def flax_leaf(name: str, t: torch.Tensor) -> torch.Tensor:
    """A state-dict leaf in its flax layout (a view)."""
    return _weight_to_flax(t) if _is_kernel(name) else t


def torch_leaf(name: str, t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`flax_leaf`, contiguous."""
    return (_kernel_to_torch(t) if _is_kernel(name) else t).contiguous()


def wire_order(state: Mapping[str, torch.Tensor]) -> list:
    """The state dict's names in the order the JAX package flattens the
    flax tree: sorted by flax path."""
    return sorted(state, key=_flax_path)


def wire_vector(state: Mapping[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    """``tree_flatten_to_vector(params_to_jax(state))`` without leaving the
    state's device: one vector of ``dtype``, the leaves in flax order, the
    kernels in flax layout."""
    return torch.cat([(_weight_to_flax(state[k]) if _is_kernel(k) else state[k])
                      .reshape(-1).to(dtype) for k in wire_order(state)])


def state_from_wire_vector(vec: torch.Tensor, template: Mapping[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`wire_vector`: ``vec`` split into ``template``'s
    leaves (each in the port's layout, shape and dtype, contiguous), in the
    template's key order, on ``vec``'s device."""
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k in wire_order(template):
        t = template[k]
        n = t.numel()
        if _is_kernel(k):
            leaf = _kernel_to_torch(vec[off:off + n].reshape(_weight_to_flax(t).shape))
        else:
            leaf = vec[off:off + n].reshape(t.shape)
        out[k] = leaf.to(t.dtype).contiguous()
        off += n
    if off != vec.numel():
        raise ValueError(f"wire vector has {vec.numel()} elements, the template {off}")
    return {k: out[k] for k in template}


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
            if k in ("kernel", "kernel_q"):
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
        t = t.detach()
        if leaf == "weight":
            leaf, t = "kernel", _weight_to_flax(t)
        elif leaf == "kernel_q":
            t = _weight_to_flax(t)
        # a contiguous copy that shares no storage with the model: one copy,
        # laid out on the device and then moved (the move is the copy)
        t = (t.clone(memory_format=torch.contiguous_format) if t.device.type == "cpu"
             else t.contiguous().cpu())
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = t if t.dtype == torch.bfloat16 else t.numpy()
    return out
