"""State-dict arithmetic: the counterpart of ``fedml_tpu/utils/pytree.py``.

The JAX package passes model parameters as pytrees; the port passes them as
state dicts, ``{name: tensor}`` with the module's dotted parameter names, on
the device the model lives on. Every aggregation rule of the FedAvg path is
built from these helpers. The weighted average delegates to the bucketed
fold (``core/aggregation/bucketed.py``), as in the JAX package.

A state dict's order is its module's registration order; the flat vector
keeps that order. :func:`tree_to_device` is the counterpart of the JAX
package's ``tree_from_numpy``: host leaves go up in one copy per dtype group. ``models/convert.py`` maps a state dict to and from the
flax layout (the JAX package's wire layout).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..core import telemetry as tel

# the JAX package's transfer counters (core/telemetry/jax_hooks.py)
H2D_TRANSFERS = "comm.host_to_device_transfers"
H2D_BYTES = "comm.host_to_device_bytes"

StateDict = Dict[str, torch.Tensor]


def tree_add(a: StateDict, b: StateDict) -> StateDict:
    return {k: a[k] + b[k] for k in a}


def tree_sub(a: StateDict, b: StateDict) -> StateDict:
    return {k: a[k] - b[k] for k in a}


def tree_scale(a: StateDict, s) -> StateDict:
    return {k: v * s for k, v in a.items()}


def tree_zeros_like(a: StateDict) -> StateDict:
    return {k: torch.zeros_like(v) for k, v in a.items()}


def tree_global_norm(a: StateDict) -> torch.Tensor:
    """L2 norm over the whole state dict (as one flat vector), a 0-d tensor."""
    return torch.sqrt(sum(v.float().square().sum() for v in a.values()))


def _acc_dtype(v: torch.Tensor) -> torch.dtype:
    """The dtype a reduction over ``v`` runs in: float64 stays float64,
    every other dtype accumulates in f32."""
    return torch.float64 if v.dtype == torch.float64 else torch.float32


def tree_clip_by_global_norm(a: StateDict, max_norm) -> StateDict:
    """``a`` scaled by ``min(1, max_norm / (||a|| + 1e-12))``, the norm over
    the whole state dict (JAX ``utils/pytree.py:51``); each leaf keeps its
    dtype."""
    norm = torch.sqrt(sum(v.to(_acc_dtype(v)).square().sum() for v in a.values()))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return {k: (v * scale).to(v.dtype) for k, v in a.items()}


def tree_clone(a: StateDict) -> StateDict:
    """A copy that shares no storage with ``a`` (tensors are mutable, where
    JAX arrays are not: a state dict handed on must not move with its
    source)."""
    return {k: v.detach().clone() for k, v in a.items()}


def weighted_average(pairs: Sequence[Tuple[float, StateDict]]) -> StateDict:
    """Weighted average of ``(weight, state dict)`` pairs, weights normalised,
    through the bucketed fold (f32 accumulation, each leaf cast back to its
    dtype)."""
    from ..core.aggregation.bucketed import bucketed_weighted_average

    return bucketed_weighted_average(pairs)


def stacked_weighted_average(states: Sequence[StateDict], weights: torch.Tensor) -> StateDict:
    """``sum_k weights[k] * states[k]`` for every leaf, as the JAX package's
    ``stacked_weighted_average`` computes it: each leaf rounded to float32,
    contracted with the weights in the wider of their dtype and float32
    (float32 weights for a float32 model, float64 for a float64 one, as
    JAX's x64 mode gives), and cast back to the leaf's dtype."""
    acc = torch.promote_types(weights.dtype, torch.float32)
    w = weights.to(acc)
    return {k: torch.tensordot(w, torch.stack([s[k] for s in states]).to(torch.float32).to(acc),
                               dims=1).to(v.dtype)
            for k, v in states[0].items()}


def tree_flatten_to_vector(a: StateDict, dtype=torch.float32
                           ) -> Tuple[torch.Tensor, Tuple[List[str], List[torch.Size], List[torch.dtype]]]:
    """One contiguous vector of ``dtype`` (in the state dict's order) and the
    spec that restores the state dict."""
    names = list(a)
    shapes = [a[k].shape for k in names]
    dtypes = [a[k].dtype for k in names]
    if not names:
        return torch.zeros(0, dtype=dtype), (names, shapes, dtypes)
    flat = torch.cat([a[k].reshape(-1).to(dtype) for k in names])
    return flat, (names, shapes, dtypes)


def tree_unflatten_from_vector(flat: torch.Tensor, spec) -> StateDict:
    names, shapes, dtypes = spec
    out: StateDict = {}
    off = 0
    for name, shape, dtype in zip(names, shapes, dtypes):
        size = shape.numel()
        out[name] = flat[off:off + size].reshape(shape).to(dtype)
        off += size
    return out


def tree_to_device(a: StateDict, device) -> StateDict:
    """``a`` with its CPU tensors on ``device``, moved with ONE host-to-device
    copy per dtype group (not one per leaf): each group is concatenated on
    the host, copied up, and split into views of the one device buffer.
    Tensors already on a device, and every leaf when ``device`` is the CPU,
    pass through. Each copy bumps ``comm.host_to_device_transfers`` and
    ``comm.host_to_device_bytes``."""
    device = torch.device(device)
    if device.type == "cpu":
        return a
    out = dict(a)
    groups: Dict[torch.dtype, List[str]] = {}
    for k, v in a.items():
        if isinstance(v, torch.Tensor) and v.device.type == "cpu":
            groups.setdefault(v.dtype, []).append(k)
    for dtype, names in groups.items():
        flat_host = torch.cat([a[k].reshape(-1) for k in names])
        flat = flat_host.to(device)
        tel.counter(H2D_TRANSFERS).add(1)
        tel.counter(H2D_BYTES).add(flat_host.numel() * flat_host.element_size())
        for k, part in zip(names, torch.split(flat, [a[k].numel() for k in names])):
            out[k] = part.view(a[k].shape)
    return out
