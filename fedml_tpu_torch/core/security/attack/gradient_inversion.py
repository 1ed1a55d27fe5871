"""Gradient-inversion attacks (the DLG family): counterpart of
``fedml_tpu/core/security/attack/gradient_inversion.py`` (reference
core/security/attack/{dlg_attack,invert_gradient_attack,
revealing_labels_from_gradients}.py).

Dummy inputs and soft labels are optimized with ``torch.optim.Adam`` to
match an observed gradient (L2 for DLG, cosine for Inverting Gradients, with
its total-variation prior), one eager step an iteration where JAX runs the
loop under ``lax.scan``. ``grad_fn(params, x, y_soft)`` returns the
parameter gradients (a dict or a sequence of tensors) and must keep their
graph (``torch.autograd.grad(..., create_graph=True)``): the match loss is
differentiated through it.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ....models.convert import flax_leaf, wire_order


def _leaves(g) -> List[torch.Tensor]:
    return list(g.values()) if isinstance(g, dict) else list(g)


def dlg_reconstruct(
    grad_fn: Callable,
    params: Any,
    observed_grad: Any,
    x_shape: Sequence[int],
    num_classes: int,
    *,
    iters: int = 300,
    lr: float = 0.1,
    match: str = "l2",
    tv_weight: float = 0.0,
    generator: Optional[torch.Generator] = None,
    history: Optional[list] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recover ``(x, y)`` from a gradient. ``tv_weight`` adds the
    Inverting-Gradients total-variation prior for 4-D x; ``history``, when
    given, receives each iteration's match loss."""
    obs = [o.detach() for o in _leaves(observed_grad)]
    dev = obs[0].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dummy_x = torch.randn(tuple(x_shape), generator=generator, device=dev).requires_grad_()
    dummy_y = torch.randn((x_shape[0], num_classes), generator=generator,
                          device=dev).requires_grad_()
    opt = torch.optim.Adam([dummy_x, dummy_y], lr=lr)
    obs_norm = torch.sqrt(sum((o * o).sum() for o in obs))
    for _ in range(iters):
        opt.zero_grad()
        g = _leaves(grad_fn(params, dummy_x, torch.softmax(dummy_y, dim=-1)))
        if match == "cosine":
            num = sum((a * b).sum() for a, b in zip(g, obs))
            den = torch.sqrt(sum((a * a).sum() for a in g)) * obs_norm + 1e-12
            loss = 1.0 - num / den
        else:
            loss = sum(((a - b) ** 2).sum() for a, b in zip(g, obs))
        if tv_weight > 0.0 and len(x_shape) == 4:
            loss = loss + tv_weight * total_variation(dummy_x)
        loss.backward()
        opt.step()
        if history is not None:
            history.append(float(loss.detach()))
    return dummy_x.detach(), torch.argmax(dummy_y.detach(), dim=-1)


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic TV over [B, H, W, C], the image prior of Inverting
    Gradients."""
    dh = (x[:, 1:, :, :] - x[:, :-1, :, :]).abs().mean()
    dw = (x[:, :, 1:, :] - x[:, :, :-1, :]).abs().mean()
    return dh + dw


def reveal_labels_from_gradients(last_layer_grad: torch.Tensor) -> torch.Tensor:
    """Labels in a batch show as rows of the classifier layer's gradient
    whose minimum is negative (Yin et al. 2021): pass the gradient with one
    row a class, e.g. a Linear weight's ``[C, F]``. The per-row mask."""
    row_signal = last_layer_grad.min(dim=-1).values if last_layer_grad.ndim > 1 \
        else last_layer_grad
    return row_signal < 0


class RevealingLabelsFromGradientsAttack:
    """Facade wrapper over :func:`reveal_labels_from_gradients`. Given a
    state dict it reads the last leaf of two or more dimensions in flax's
    order, in the flax layout, as the JAX package does: a Dense kernel is
    ``[in, out]`` there, so the mask is over its input rows."""

    def __init__(self, config: Any):
        self.config = config

    def reconstruct_data(self, a_gradient, extra_auxiliary_info=None):
        if isinstance(a_gradient, torch.Tensor):
            return reveal_labels_from_gradients(a_gradient)
        names = wire_order(a_gradient)
        pick = next((k for k in reversed(names) if a_gradient[k].ndim >= 2), names[-1])
        return reveal_labels_from_gradients(flax_leaf(pick, a_gradient[pick]))


class DLGAttack:
    """Facade wrapper: ``reconstruct_data(a_gradient, (grad_fn, params,
    x_shape, num_classes))``."""

    match = "l2"
    tv_weight = 0.0

    def __init__(self, config: Any):
        self.iters = int(getattr(config, "attack_iters", 300))
        self.lr = float(getattr(config, "attack_lr", 0.1))

    def reconstruct_data(self, a_gradient, extra_auxiliary_info=None):
        grad_fn, params, x_shape, num_classes = extra_auxiliary_info
        return dlg_reconstruct(grad_fn, params, a_gradient, x_shape, num_classes,
                               iters=self.iters, lr=self.lr, match=self.match,
                               tv_weight=self.tv_weight)


class InvertGradientAttack(DLGAttack):
    """Inverting Gradients (Geiping et al. 2020): cosine matching plus the
    total-variation prior (reference invert_gradient_attack.py)."""

    match = "cosine"

    def __init__(self, config: Any):
        super().__init__(config)
        self.tv_weight = float(getattr(config, "attack_tv_weight", 0.01))
