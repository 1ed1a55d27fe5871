"""Gaussian mechanism over state dicts: counterpart of
``fedml_tpu/core/dp/mechanisms/gaussian.py`` (reference
``python/fedml/core/dp/mechanisms/gaussian.py``).

The JAX package draws from a PRNG key split once per leaf; the port draws
from an explicit ``torch.Generator`` on the leaves' own device (a CPU
generator cannot draw on CUDA), leaf by leaf in ``models/convert.py``
``wire_order``, so a state dict's key order cannot change the draws. The
draws match JAX's in distribution, not bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ....models.convert import wire_order
from ....utils.pytree import StateDict


class DeviceGenerators:
    """One ``torch.Generator`` per device, each seeded with ``seed`` when a
    draw first lands on that device."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._gens: Dict[torch.device, torch.Generator] = {}

    def get(self, device) -> torch.Generator:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        gen = self._gens.get(device)
        if gen is None:
            gen = self._gens[device] = torch.Generator(device=device).manual_seed(self.seed)
        return gen

    def for_tree(self, tree: StateDict) -> torch.Generator:
        return self.get(next(iter(tree.values())).device)


def normal_like(tree: StateDict, gen: torch.Generator) -> StateDict:
    """Standard-normal f32 draws shaped like each leaf, drawn in wire order,
    returned in ``tree``'s key order."""
    out = {k: torch.randn(tree[k].shape, generator=gen, device=tree[k].device,
                          dtype=torch.float32) for k in wire_order(tree)}
    return {k: out[k] for k in tree}


def add_gaussian_noise(tree: StateDict, gen: torch.Generator, sigma: float) -> StateDict:
    """Per-leaf N(0, sigma^2) noise drawn in f32 and cast to the leaf's dtype
    (JAX ``gaussian.py:19-28``): the one noising primitive every DP frame
    shares."""
    noise = normal_like(tree, gen)
    return {k: v + (sigma * noise[k]).to(v.dtype) for k, v in tree.items()}


class Gaussian:
    def __init__(self, *, epsilon: float, delta: float, sensitivity: float = 1.0,
                 sigma: float | None = None):
        if sigma is not None:
            self.sigma = float(sigma)
        else:
            if not (0 < delta < 1):
                raise ValueError("Gaussian mechanism requires 0 < delta < 1")
            # the classic analytic bound: sigma >= sqrt(2 ln(1.25/delta)) * S / eps
            self.sigma = math.sqrt(2.0 * math.log(1.25 / delta)) * sensitivity / epsilon
        self.epsilon = epsilon
        self.delta = delta
        self.sensitivity = sensitivity

    def add_noise(self, tree: StateDict, gen: torch.Generator) -> StateDict:
        return add_gaussian_noise(tree, gen, self.sigma)
