"""Intra-silo data parallelism, the DDP replacement: counterpart of
``fedml_tpu/parallel/dp.py``.

Reference: the DDP wrap at ``ml/engine/ml_engine_adapter.py:273-281`` and
``cross_silo/client/fedml_trainer_dist_adapter.py:25-26``. The JAX package
re-jits the local round with the batch axis sharded over a ``dp`` mesh and
the parameters replicated, and XLA inserts the gradient all-reduce. Here the
silo's ranks run the same local round (:func:`shard_local_train`); at every
step each rank takes its contiguous 1/n of the batch (JAX's split of ``B``
in the ``[E, nb, B]`` ``idx``/``mask``), and one all-reduce a step sums the
ranks' gradients, so each step is the single-device step on the whole batch:

- the masked loss of a shard is divided by the whole batch's count,
  ``max(mask.sum(), 1)`` over all B rows (the mask is host numpy, the same
  on every rank, so no collective is needed for it), and the step's loss
  (the local round's reported mean) is the all-reduced sum of those parts;
- what does not depend on the data is added once: FedProx's proximal term
  joins the loss on the group's rank 0 only (the all-reduce then sums it
  once), and after the all-reduce every rank alike applies the algorithms'
  gradient transforms (SCAFFOLD, FedDyn, Mime) and weight decay, which the
  optimizer adds in its step;
- params and optimizer state stay replicated: every rank applies the same
  summed gradient to the same weights.

A batch that n does not divide raises ``ValueError`` at the local round's
first call, as JAX's sharded call does. The models the DP silo trains hold
no batch statistics (the repo's ResNets use GroupNorm); dropout draws its
mask per rank's shard, so a dropout model's DP round is not the one-rank
round (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict

import torch

from . import multihost


class DataParallelGroup:
    """The ranks a silo's local round is split over: this process's
    position ``rank`` of ``size``, and the ``torch.distributed`` group whose
    all-reduce sums their gradients (None: the default group)."""

    def __init__(self, size: int, rank: int, group=None):
        self.size, self.rank, self.group = int(size), int(rank), group

    @classmethod
    def from_mesh(cls, mesh, axis: str = "dp") -> "DataParallelGroup":
        """From a ``DeviceMesh``'s ``axis``."""
        import torch.distributed as dist

        group = mesh.get_group(axis)
        return cls(dist.get_world_size(group), dist.get_rank(group), group)

    def batch_slice(self, b: int) -> slice:
        """This rank's contiguous share of a batch of ``b`` rows."""
        if b % self.size:
            raise ValueError(
                f"the batch's global size {b} is not divisible by the {self.size} ranks of the "
                "data-parallel group (each rank takes an equal share of every batch)")
        share = b // self.size
        return slice(self.rank * share, (self.rank + 1) * share)

    def all_reduce_grads_(self, params: Dict[str, torch.Tensor],
                          loss: torch.Tensor) -> torch.Tensor:
        """Sum the ranks' gradients of ``params`` (in place) and their loss
        parts in one flat all-reduce; returns the summed loss. A parameter
        no gradient reached on this rank counts as zeros, so every rank
        sends the same layout and ends with the same gradients."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params.values()]
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1).to(grads[0].dtype)])
        multihost.all_reduce_sum_(flat, op="dp_all_reduce", group=self.group)
        for p, g in zip(params.values(), flat[:-1].split([p.numel() for p in params.values()])):
            p.grad = g.view(p.shape)
        return flat[-1]


def shard_local_train(local_train_fn: Callable, mesh: Any) -> Callable:
    """``local_sgd.make_local_train_fn``'s local round split over ``mesh``
    (a :class:`DataParallelGroup` or a ``DeviceMesh`` with a ``dp`` axis)
    for intra-silo DP. The signature stays ``(x_all, y_all, idx, mask, rng,
    extras)``."""
    dp = mesh if isinstance(mesh, DataParallelGroup) else DataParallelGroup.from_mesh(mesh)
    return functools.partial(local_train_fn, dp=dp)
