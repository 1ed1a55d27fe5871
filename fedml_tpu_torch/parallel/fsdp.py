"""Causal-LM loss and the single-device train step.

Counterpart of ``fedml_tpu/parallel/fsdp.py``. The JAX module shards params,
grads and optimizer state over a ('dp','fsdp','tp') mesh by path rules; this
slice of the port runs on one device, so only the loss and the step are
here. FSDP over more than one device waits for a later slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token CE in f32: predict tokens[t+1] from logits[t]; with a mask,
    the mean over unmasked targets."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1].to(torch.float32)
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                             reduction="none").view(targets.shape)
    if mask is not None:
        m = mask[:, 1:].to(torch.float32)
        return (losses * m).sum() / m.sum().clamp_min(1.0)
    return losses.mean()


def make_train_step(model: torch.nn.Module, optimizer) -> Callable:
    """-> step(tokens, mask) -> loss (a detached device scalar; reading it
    waits for the device). One forward, one backward, one optimizer update
    of the parameters that require grad."""

    def step(tokens: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        loss = causal_lm_loss(model(tokens), tokens, mask)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad()
        return loss.detach()

    return step
