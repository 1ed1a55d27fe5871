"""Mixture-of-Experts MLP with expert parallelism: counterpart of
``fedml_tpu/models/moe.py``.

Switch-Transformer top-1 routing the dense way: a fixed expert capacity
``C = max(1, int(N / E * capacity_factor))`` and dense dispatch and combine
tensors ``[N, E, C]``, so the expert FFN is one batched product over ``[E,
C, D]`` with no scatter and no data-dependent shapes. A token past its
expert's capacity is dropped (combine weight 0: it passes through the
residual only). The Switch aux loss ``E * sum_e(fraction_e * prob_mean_e)``
comes back scaled by ``aux_loss_weight``.

Precision as in JAX: the router ``[D, E]`` and the expert stacks
``w_gate``/``w_up`` ``[E, D, F]`` and ``w_down`` ``[E, F, D]`` are f32
parameters (a decode model holds the stacks in ``dtype``, cast once when
loaded); the router logits and the softmax are f32 whatever the activation
dtype (JAX casts them, ``moe.py:76``), the FFN runs in ``dtype``. The expert
FFN and the two dispatch einsums are plain products, as in JAX, where XLA
computes them outside any Pallas kernel.

Under a mesh (``parallel.ring_attention.active_mesh``, set by the sharded
train step, ``parallel/fsdp.py``):

- ``ep`` (``ep_axis``): each ep rank holds ``E/ep`` experts and runs them on
  the full dispatch; the partial combines are summed over the ep group
  (JAX's shard_map form, ``moe.py:131-145``). The router stays replicated.
- ``tp``: each expert's ``F`` is split over tp (``w_gate``/``w_up`` by
  column, ``w_down`` by row), the partial outputs summed with ep's.
- batch and sequence sharding (``dp``, ``fsdp``, ``sp``): routing stays the
  global batch's, as under JAX's jit: the capacity comes from the global
  N, each token's place in its expert's queue is an exclusive count in the
  global ``[B, T]`` order (the ranks' per-row, per-expert counts are
  gathered and scanned in that order; under sp the order interleaves the
  ranks along each row), the aux statistics are global means, and the
  ranks' partial ``[E, C, D]`` expert inputs are summed before the experts
  run. So a sharded step drops exactly the tokens the global dispatch drops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    capacity_factor: float = 1.25
    d_model: int = 512
    d_ff: int = 1376
    aux_loss_weight: float = 0.01
    dtype: Any = torch.bfloat16
    ep_axis: Optional[str] = None
    # the pipeline's shard_map path only (experts held per ep rank); the
    # pipeline is not ported, so a value here raises
    local_experts: Optional[int] = None


def capacity_for(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Per-expert capacity of ``n_tokens`` routed tokens (JAX ``moe.py:108``)."""
    return max(1, int(n_tokens / n_experts * capacity_factor))


def route(router_logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs [N, E] f32, expert [N], gate [N]) of top-1 routing; a tie goes
    to the lowest expert index, as ``jnp.argmax`` gives it."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    expert = probs.argmax(dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    return probs, expert, gate


def dispatch_from(onehot: torch.Tensor, pos_in_expert: torch.Tensor, gate: torch.Tensor,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (dispatch, combine) [N, E, C] from each token's expert one-hot,
    its place in that expert's queue and its gate; a place at or past
    ``capacity`` is dropped (a zero row)."""
    keep = (pos_in_expert < capacity).to(onehot.dtype)
    slot = (pos_in_expert[:, None] == torch.arange(capacity, device=onehot.device,
                                                   dtype=pos_in_expert.dtype)[None, :])
    dispatch = onehot[:, :, None] * keep[:, None, None] * slot.to(onehot.dtype)[:, None, :]
    return dispatch, dispatch * gate[:, None, None]


def moe_dispatch(router_logits: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dispatch [N, E, C], combine [N, E, C], aux) from router logits [N, E]:
    top-1 routing with per-expert capacity, overflowing tokens dropped
    (JAX ``moe_dispatch``)."""
    E = router_logits.shape[1]
    probs, expert, gate = route(router_logits)
    onehot = F.one_hot(expert, E).to(torch.float32)
    # position of each token within its expert's queue
    pos = torch.cumsum(onehot, dim=0) * onehot - onehot
    dispatch, combine = dispatch_from(onehot, pos.sum(dim=-1), gate, capacity)
    aux = E * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
    return dispatch, combine, aux


def dropped_tokens(dispatch: torch.Tensor) -> torch.Tensor:
    """Tokens a dispatch routed nowhere (past their expert's capacity)."""
    return (dispatch.sum(dim=(1, 2)) == 0).sum()


def _lecun_std(shape) -> float:
    """flax lecun_normal's std: 1/sqrt(fan_in), fan_in = shape[-2] times the
    leading (receptive) dims."""
    fan_in = shape[-2]
    for s in shape[:-2]:
        fan_in *= s
    return fan_in ** -0.5


class MoEMLP(nn.Module):
    """Drop-in replacement for the dense SwiGLU MLP: forward(x) -> (out,
    aux) with ``aux`` pre-weighted by ``aux_loss_weight`` (f32 scalar). A
    dropped token's output row is exactly zero."""

    def __init__(self, cfg: MoEConfig, device=None, stack_dtype=torch.float32):
        super().__init__()
        if cfg.local_experts is not None:
            raise NotImplementedError(
                "moe_local_experts (the pipeline's shard_map experts) is not ported to "
                "fedml_tpu_torch yet: pipeline parallelism is queued in ROADMAP.md, Queue 1")
        self.cfg = cfg
        E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Parameter(torch.empty(D, E, device=device, dtype=torch.float32))
        self.w_gate = nn.Parameter(torch.empty(E, D, Fd, device=device, dtype=stack_dtype))
        self.w_up = nn.Parameter(torch.empty(E, D, Fd, device=device, dtype=stack_dtype))
        self.w_down = nn.Parameter(torch.empty(E, Fd, D, device=device, dtype=stack_dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.router, self.w_gate, self.w_up, self.w_down):
                p.normal_(0.0, _lecun_std(p.shape), generator=generator)

    def _ffn(self, h: torch.Tensor, wg, wu, wd) -> torch.Tensor:
        """[E, C, D] -> [E, C, D]: each expert's SwiGLU, weights cast to h's dtype."""
        dt = h.dtype
        return torch.bmm(F.silu(torch.bmm(h, wg.to(dt))) * torch.bmm(h, wu.to(dt)), wd.to(dt))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        from ..parallel.ring_attention import get_active_mesh

        mesh = get_active_mesh()
        if mesh is not None and mesh.size > 1:
            return self._sharded(x, mesh)
        D = cfg.d_model
        tokens = x.reshape(-1, D)
        capacity = capacity_for(tokens.shape[0], cfg.n_experts, cfg.capacity_factor)
        logits = tokens.to(torch.float32) @ self.router.to(torch.float32)
        dispatch, combine, aux = moe_dispatch(logits, capacity)
        dt = cfg.dtype
        expert_in = torch.einsum("nec,nd->ecd", dispatch.to(dt), tokens.to(dt))
        expert_out = self._ffn(expert_in, self.w_gate, self.w_up, self.w_down)
        out = torch.einsum("nec,ecd->nd", combine.to(dt), expert_out)
        return out.reshape(x.shape), (cfg.aux_loss_weight * aux).to(torch.float32)

    def _sharded(self, x: torch.Tensor, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step under a mesh (module docstring): x is this rank's
        [Bl, Tl, D] block of the global [B, T] batch."""
        from ..parallel import multihost as mh

        cfg = self.cfg
        E, D = cfg.n_experts, cfg.d_model
        Bl, Tl = x.shape[0], x.shape[1]
        tokens = x.reshape(-1, D)
        data_axes = mesh.present("dp", "fsdp", "sp")
        data = mesh.group(*data_axes)
        n_data = mesh.axis_size(*data_axes)
        capacity = capacity_for(tokens.shape[0] * n_data, E, cfg.capacity_factor)

        logits = tokens.to(torch.float32) @ self.router.to(torch.float32)
        probs, expert, gate = route(logits)
        onehot = F.one_hot(expert, E).to(torch.float32)
        oh_rows = onehot.view(Bl, Tl, E)
        # exclusive count within this rank's piece of each row, then the
        # offset of that piece in the global [B, T] order
        local_pos = torch.cumsum(oh_rows, dim=1) - oh_rows
        offset = self._row_offsets(oh_rows.sum(dim=1), mesh, data_axes)  # [Bl, E]
        pos = ((local_pos + offset[:, None, :]) * oh_rows).sum(dim=-1).reshape(-1)
        dispatch, combine = dispatch_from(onehot, pos, gate, capacity)

        # the Switch aux over the global batch: sums over the data ranks
        frac_sum = onehot.sum(dim=0)
        if data is not None:
            frac_sum = mh.all_reduce(frac_sum, data, op="moe_aux")
            prob_sum = mh.AllReduceSum.apply(probs.sum(dim=0), data, "moe_aux")
        else:
            prob_sum = probs.sum(dim=0)
        n_global = tokens.shape[0] * n_data
        aux = E * torch.sum((frac_sum / n_global) * (prob_sum / n_global))

        # the expert group: ep ranks hold E/ep experts, tp ranks F/tp of each;
        # each stack read once (under fsdp a read gathers it)
        wg, wu, wd = self.w_gate, self.w_up, self.w_down
        e_local = wg.shape[0]
        ep_axes = mesh.present("tp", cfg.ep_axis) if cfg.ep_axis else mesh.present("tp")
        egroup = mesh.group(*ep_axes)
        e0 = (mesh.index(cfg.ep_axis) * e_local) if (cfg.ep_axis and e_local < E) else 0
        if egroup is not None:
            tokens_in = mh.CopyToGroup.apply(tokens, egroup, "moe_expert")
            combine = mh.CopyToGroup.apply(combine, egroup, "moe_expert")
        else:
            tokens_in = tokens
        dt = cfg.dtype
        disp_l = dispatch[:, e0:e0 + e_local]
        comb_l = combine[:, e0:e0 + e_local]
        expert_in = torch.einsum("nec,nd->ecd", disp_l.to(dt), tokens_in.to(dt))
        if data is not None:
            expert_in = mh.AllReduceSum.apply(expert_in, data, "moe_expert_in")
        expert_out = self._ffn(expert_in, wg, wu, wd)
        out = torch.einsum("nec,ecd->nd", comb_l.to(dt), expert_out)
        if egroup is not None:
            out = mh.ReduceFromGroup.apply(out, egroup, "moe_combine")
        return out.reshape(x.shape), (cfg.aux_loss_weight * aux).to(torch.float32)

    @staticmethod
    def _row_offsets(counts: torch.Tensor, mesh, data_axes) -> torch.Tensor:
        """[Bl, E] exclusive per-expert counts of every token that comes
        before this rank's piece of each of its rows in the global [B, T]
        order (rows of earlier batch blocks whole, then the earlier sequence
        pieces of the same row)."""
        from ..parallel import multihost as mh

        group = mesh.group(*data_axes)
        if group is None:  # this rank holds the whole batch: earlier rows only
            return torch.cumsum(counts, dim=0) - counts
        gathered = mh.all_gather(counts, group, op="moe_route_counts")  # [n, Bl, E]
        n_sp = mesh.axis_size("sp")
        n_batch = mesh.axis_size("dp", "fsdp")
        Bl, E = counts.shape
        grid = counts.new_zeros(n_batch, Bl, n_sp, E)
        for member, c in zip(mesh.group_ranks(*data_axes), gathered):
            block = mesh.index("dp", "fsdp", rank=member)
            grid[block, :, mesh.index("sp", rank=member)] = c
        flat = grid.reshape(-1, E)
        excl = (torch.cumsum(flat, dim=0) - flat).reshape(n_batch, Bl, n_sp, E)
        return excl[mesh.index("dp", "fsdp"), :, mesh.index("sp")]
