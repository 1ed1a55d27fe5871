"""Laplace mechanism over state dicts: counterpart of
``fedml_tpu/core/dp/mechanisms/laplace.py`` (reference
core/dp/mechanisms/laplace.py). Draws by the inverse CDF from uniform
draws of an explicit generator, leaf by leaf in wire order."""

from __future__ import annotations

import torch

from ....models.convert import wire_order
from ....utils.pytree import StateDict


def laplace_like(tree: StateDict, gen: torch.Generator) -> StateDict:
    """Standard-Laplace f32 draws shaped like each leaf (wire order)."""
    out = {}
    for k in wire_order(tree):
        u = torch.rand(tree[k].shape, generator=gen, device=tree[k].device, dtype=torch.float32)
        # u in [0, 1) -> v in (-1, 1): sign(v) * -log(1 - |v|) is Laplace(0, 1)
        v = (2.0 * u - 1.0).clamp_min(-1.0 + torch.finfo(torch.float32).eps)
        out[k] = -torch.sign(v) * torch.log1p(-v.abs())
    return {k: out[k] for k in tree}


class Laplace:
    def __init__(self, *, epsilon: float, sensitivity: float = 1.0):
        if epsilon <= 0:
            raise ValueError("epsilon must be > 0")
        self.scale = sensitivity / epsilon
        self.epsilon = epsilon
        self.sensitivity = sensitivity

    def add_noise(self, tree: StateDict, gen: torch.Generator) -> StateDict:
        noise = laplace_like(tree, gen)
        return {k: v + (self.scale * noise[k]).to(v.dtype) for k, v in tree.items()}
