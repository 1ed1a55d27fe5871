"""The LLM trainer's optimizer: the optax chain of the JAX trainer in torch.

``fedml_tpu/train/llm/llm_trainer.py:111-147`` builds
``multi_transform({train: chain(clip_by_global_norm(c),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, max(steps, warmup+1)),
wd)), freeze: set_to_zero()})``. Here the "train" branch is ``AdamW`` over
the trainable tensors only. The "freeze" branch has no counterpart: base
weights are ``requires_grad=False``, so no base gradient is ever formed
(saving its memory) and the base stays bit-unchanged, which is what
``set_to_zero`` gives.

Numerics follow optax exactly:
* the clip's global norm covers the trainable (adapter) grads only, since
  the clip lives inside the "train" branch, and scales by
  ``g / norm * max_norm`` when ``norm >= max_norm`` (no epsilon; not
  ``torch.nn.utils.clip_grad_norm_``);
* Adam with b1 0.9, b2 0.999, eps 1e-8 outside the sqrt, bias corrections
  at the incremented count, decoupled decay ``lr * wd * p``;
* the learning rate is the schedule at optax's 0-based count, so the first
  step has lr 0 after a warmup from 0.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List

import torch

# optax.adamw's defaults, the only values the JAX trainer uses
B1, B2, EPS = 0.9, 0.999, 1e-8


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: g / norm * max_norm when
    norm >= max_norm (no host sync: the choice is made on the device)."""
    norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, (g / norm) * max_norm))


class AdamW:
    """clip_by_global_norm + optax.adamw(schedule, weight_decay) over
    ``params``. State: the step count (optax's) and the two moments."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Callable[[int], float],
                 *, grad_clip: float, weight_decay: float = 0.0):
        self.params = list(params)
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        clip_by_global_norm_(grads, self.grad_clip)
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - B1 ** self.count
        bc2 = 1.0 - B2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).add_(g * g, alpha=1.0 - B2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.add_(update, alpha=-lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
