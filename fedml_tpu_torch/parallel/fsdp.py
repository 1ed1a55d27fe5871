"""Sharded LLM training over a mesh of ranks: counterpart of
``fedml_tpu/parallel/fsdp.py``.

The JAX package shards parameters, gradients and optimizer state by path
rules over a ``('dp','fsdp','tp'[,'sp','ep'])`` mesh and lets GSPMD insert
the collectives, so its sharded step equals the unsharded one. Here the
same rules (:data:`DEFAULT_RULES`, on flax paths and flax's ``[in, out]``
layout) place each parameter of a ``TransformerLM`` over a
:class:`~.mesh.RankMesh` (:class:`ShardedLM`), and the model's own forward
runs the step with explicit collectives (``parallel/multihost.py``), equal
to the one-rank step; a mesh of one position is the one-device step:

- **Storage (ZeRO-3 over fsdp).** Each rank keeps only its shard of every
  parameter the rules shard (an axis the mesh lacks, or one that does not
  divide the dim, is dropped, as in JAX), and the optimizer's moments
  follow their parameter's shard (JAX ``_opt_state_shardings``). The
  port's state-dict names and ``[out, in]`` Dense weights take the rule of
  their flax path with the spec's axes flipped; the MoE stacks and the LoRA
  factors keep flax's layout, so their specs are not flipped.
- **Compute.** The batch is split over (``dp``, ``fsdp``) and the sequence
  over ``sp``. A sharded leaf the compute uses whole is a parametrization
  of its module that gathers it where the module reads it, so inside the
  block's remat region (the backward gathers it again), and the gather's
  backward reduce-scatters the gradient. Under ``tp`` the attention heads
  and d_ff stay split (Megatron, ``models/transformer.py``), the other
  tp-sharded parameters (the embedding, the head, a row-parallel
  ``lora_b``) are gathered and computed whole by every tp rank. Under
  ``ep`` each rank runs its experts (``models/moe.py``). After the
  backward, every gradient is summed over the data axes it is not sharded
  on; the clip's global norm sums each shard's squares over the axes that
  shard it and counts a replicated leaf once (``train/llm/optim.py``).
- **The loss** (:func:`sharded_causal_lm_loss`): the global batch's
  next-token CE: each rank's last position predicts the next rank's first
  token (the targets come from the global batch, which every rank holds),
  the global last position is dropped, and the mean runs over the global
  count of targets and the global mask's sum; a MoE model's aux (identical
  on every rank) joins each data rank's part divided by their number.

``tp`` must divide the heads, the KV heads and d_ff (a split of a head is
not ported: NotImplementedError naming ROADMAP.md), ``ep`` the experts, and
``sp`` above 1 needs ``attention_impl="ring"``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import multihost as mh

# (flax path regex, spec) -- first match wins; paths look like
# "layer_0/attn/q_proj/kernel". A spec names a mesh axis (or None) a dim.
DEFAULT_RULES: Sequence[Tuple[str, tuple]] = (
    (r"embed/embedding$", ("tp", "fsdp")),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)/kernel(_q)?$", ("fsdp", "tp")),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)/kernel_scale$", ("tp",)),
    (r"(o_proj|down_proj)/kernel(_q)?$", ("tp", "fsdp")),
    (r"(o_proj|down_proj)/kernel_scale$", ("fsdp",)),
    (r"lm_head/kernel(_q)?$", ("fsdp", "tp")),
    (r"lm_head/kernel_scale$", ("tp",)),
    (r"lora_a$", ("fsdp", None)),
    (r"lora_b$", (None, "tp")),
    (r"moe_mlp/(w_gate|w_up)$", ("ep", "fsdp", "tp")),
    (r"moe_mlp/w_down$", ("ep", "tp", "fsdp")),
    (r"moe_mlp/router$", ()),
    (r"(scale|bias)$", ()),
    (r".*", ()),
)

# the state-dict names whose shard over an axis stays split in the compute
# (every other sharded axis is gathered before use)
_COMPUTE_LOCAL = {
    "tp": re.compile(r"((q_proj|k_proj|v_proj|gate_proj|up_proj)\.(weight|lora_b)"
                     r"|(o_proj|down_proj)\.weight|moe_mlp\.(w_gate|w_up|w_down))$"),
    "ep": re.compile(r"moe_mlp\.(w_gate|w_up|w_down)$"),
}
_DATA_AXES = ("dp", "fsdp", "sp")


def spec_for_path(path: str, rules: Sequence[Tuple[str, tuple]] = DEFAULT_RULES) -> tuple:
    """The first rule matching the ``/``-joined flax ``path``."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            return tuple(spec)
    return ()


def fix_spec(spec: tuple, shape: Sequence[int], mesh_shape: Mapping[str, int]) -> tuple:
    """``spec`` for a leaf of ``shape``: an axis the mesh lacks, or one that
    does not divide its dim, dropped; trailing Nones trimmed (JAX
    ``param_shardings``)."""
    parts = []
    for i, axis in enumerate(spec):
        ok = (axis is not None and axis in mesh_shape and i < len(shape)
              and shape[i] % mesh_shape[axis] == 0)
        parts.append(axis if ok else None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def param_shardings(params: Mapping, mesh_shape: Mapping[str, int],
                    rules: Sequence[Tuple[str, tuple]] = DEFAULT_RULES) -> Dict:
    """Nested dict of specs matching a flax-layout ``params`` tree (leaves
    with ``.shape``), as JAX's ``param_shardings`` gives them."""

    def walk(node, prefix):
        return {k: walk(v, prefix + (k,)) if isinstance(v, Mapping) else
                fix_spec(spec_for_path("/".join(prefix + (k,)), rules), tuple(v.shape), mesh_shape)
                for k, v in node.items()}

    return walk(params, ())


def torch_spec(name: str, shape: Sequence[int], mesh_shape: Mapping[str, int],
               rules: Sequence[Tuple[str, tuple]] = DEFAULT_RULES) -> tuple:
    """The spec of a port state-dict leaf, one entry a torch dim: the rule of
    its flax path on its flax shape, flipped back for a 2-D Dense weight."""
    from ..models.convert import flax_name

    kernel = name.rsplit(".", 1)[-1] in ("weight", "kernel_q") and len(shape) == 2
    fshape = tuple(reversed(shape)) if kernel else tuple(shape)
    spec = fix_spec(spec_for_path(flax_name(name), rules), fshape, mesh_shape)
    spec = spec + (None,) * (len(shape) - len(spec))
    return tuple(reversed(spec)) if kernel else spec


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


def shifted_targets(tokens: torch.Tensor, mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(targets [B, T], target mask [B, T] f32, denominator) of the global
    batch, on ``tokens``' device: position t predicts t+1, the last position
    predicts nothing (mask 0); the denominator is the unsharded loss's (the
    mask's sum past position 0, at least 1; B*(T-1) without a mask), an f32
    scalar tensor, so a batch on the card needs no sync."""
    B, T = tokens.shape
    targets = torch.zeros_like(tokens)
    targets[:, :-1] = tokens[:, 1:]
    tmask = torch.zeros((B, T), dtype=torch.float32, device=tokens.device)
    tmask[:, :-1] = 1.0 if mask is None else mask[:, 1:].to(torch.float32)
    return targets, tmask, tmask.sum().clamp_min(1.0)


def sharded_causal_lm_loss(logits: torch.Tensor, targets: torch.Tensor, tmask: torch.Tensor,
                           denom) -> torch.Tensor:
    """This shard's part of the global causal loss: its positions' CE
    against :func:`shifted_targets`' targets, masked, over the global
    denominator; the parts of all shards sum to :func:`causal_lm_loss` of
    the whole batch."""
    losses = F.cross_entropy(logits.to(torch.float32).reshape(-1, logits.shape[-1]),
                             targets.reshape(-1).long(), reduction="none").view(targets.shape)
    return (losses * tmask.to(losses.dtype)).sum() / denom


def check_mesh_fits(cfg, mesh) -> None:
    """Refuse what the sharded step does not run (module docstring)."""
    tp, ep, sp = mesh.axis_size("tp"), mesh.axis_size("ep"), mesh.axis_size("sp")
    if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp):
        raise NotImplementedError(
            f"tp={tp} must divide n_heads {cfg.n_heads}, n_kv_heads {cfg.n_kv_heads} and d_ff "
            f"{cfg.d_ff}: a tp that splits a head is not ported to fedml_tpu_torch (see "
            "ROADMAP.md, Queue 3)")
    if ep > 1 and cfg.moe_experts > 0 and cfg.moe_experts % ep:
        raise NotImplementedError(
            f"ep={ep} must divide moe_experts {cfg.moe_experts} (see ROADMAP.md, Queue 3)")
    if sp > 1 and cfg.attention_impl != "ring":
        raise NotImplementedError(
            f"sp={sp} shards the sequence: it runs attention_impl='ring', not "
            f"{cfg.attention_impl!r} (see ROADMAP.md, Queue 3)")


class _Gathered(torch.nn.Module):
    """A parametrization: the leaf as the compute uses it, this rank's shard
    gathered along each ``(dim, axis)`` of ``gathers``. It runs where the
    module reads the leaf, so inside a block's remat region: the recompute
    gathers again, and the gather's backward reduce-scatters (a data axis)
    or slices (tp) the gradient."""

    def __init__(self, mesh, gathers: Sequence[Tuple[int, str]]):
        super().__init__()
        self.mesh, self.gathers = mesh, tuple(gathers)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        for dim, axis in self.gathers:
            t = mh.GatherShards.apply(t, self.mesh.group(axis), dim, axis in _DATA_AXES,
                                      f"gather_{axis}")
        return t


class ShardedLM:
    """A ``TransformerLM``'s parameters held, in place, as this rank's shards
    over ``mesh`` (module docstring); the model's own forward then runs the
    sharded step. Each leaf the compute uses whole is a parametrization that
    gathers it where the module reads it (:class:`_Gathered`); a leaf that
    stays split (``_COMPUTE_LOCAL``) or is not sharded is a plain parameter.
    ``local`` maps the state-dict names to the leaves the optimizer steps,
    those named by ``trainable(name)`` requiring grad. A mesh of one
    position shards nothing: the model is unchanged."""

    def __init__(self, model, mesh, trainable: Callable[[str], bool], rules=DEFAULT_RULES):
        from torch.nn.utils import parametrize

        check_mesh_fits(model.cfg, mesh)
        self.model, self.mesh = model, mesh
        self.device = model.embed.embedding.device
        self.full_shapes: Dict[str, Tuple[int, ...]] = {
            n: tuple(p.shape) for n, p in model.named_parameters()}
        self.specs: Dict[str, tuple] = {n: torch_spec(n, shape, mesh.shape, rules)
                                        for n, shape in self.full_shapes.items()}
        for axis, pattern in _COMPUTE_LOCAL.items():
            if mesh.axis_size(axis) > 1:
                for name, spec in self.specs.items():
                    if pattern.search(name) and axis not in spec:
                        raise NotImplementedError(
                            f"{name} {self.full_shapes[name]} is not split over {axis}: a dim "
                            f"{axis}={mesh.axis_size(axis)} does not divide (see ROADMAP.md, "
                            "Queue 3)")
        self.local: Dict[str, torch.Tensor] = {}
        for name, spec in self.specs.items():
            owner_name, _, attr = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            wide = [(dim, axis) for dim, axis in enumerate(spec)
                    if axis is not None and mesh.axis_size(axis) > 1]
            gathers = [(dim, axis) for dim, axis in wide
                       if not (axis in _COMPUTE_LOCAL and _COMPUTE_LOCAL[axis].search(name))]
            if wide:  # the whole leaf is freed once its shard is copied out
                setattr(owner, attr, torch.nn.Parameter(
                    self._shard(getattr(owner, attr).detach(), spec).clone()))
            if gathers:
                parametrize.register_parametrization(owner, attr, _Gathered(mesh, gathers),
                                                     unsafe=True)
                leaf = owner.parametrizations[attr].original
            else:
                leaf = getattr(owner, attr)
            self.local[name] = leaf.requires_grad_(trainable(name))

    def _shard(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        for dim, axis in enumerate(spec):
            if axis is not None and self.mesh.axis_size(axis) > 1:
                t = t.chunk(self.mesh.axis_size(axis), dim=dim)[self.mesh.index(axis)]
        return t

    def sharded_axes(self, name: str) -> Tuple[str, ...]:
        """The mesh axes (above 1) this leaf's storage is sharded over."""
        return self.mesh.present(*[a for a in self.specs[name] if a is not None])

    def resident_bytes(self) -> int:
        """Bytes of this rank's parameter shards."""
        return sum(t.numel() * t.element_size() for t in self.local.values())

    def full_bytes(self) -> int:
        return sum(int(np.prod(s)) * self.local[n].element_size()
                   for n, s in self.full_shapes.items())

    def sync_grads(self) -> None:
        """Sum each trainable shard's gradient over the data axes it is not
        sharded on (fsdp's sum came with the gather's reduce-scatter), one
        flat all-reduce a set of axes and dtype."""
        if not self.mesh.present(*_DATA_AXES):
            return
        buckets: Dict[tuple, List[torch.Tensor]] = {}
        for name, p in self.local.items():
            if not p.requires_grad:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            axes = tuple(a for a in self.mesh.present(*_DATA_AXES)
                         if a not in self.sharded_axes(name))
            if axes:
                buckets.setdefault((axes, p.dtype), []).append(p)
        for (axes, _), ps in buckets.items():
            flat = torch.cat([p.grad.reshape(-1) for p in ps])
            mh.all_reduce_sum_(flat, op="grad_all_reduce", group=self.mesh.group(*axes))
            for p, g in zip(ps, flat.split([p.numel() for p in ps])):
                p.grad = g.view_as(p)

    def norm_groups(self, names: Sequence[str]) -> list:
        """The group a leaf's squares are summed over for a global norm: the
        axes that shard it (None: replicated, counted once)."""
        return [self.mesh.group(*self.sharded_axes(n)) if self.sharded_axes(n) else None
                for n in names]

    def full_state(self, names: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
        """Every leaf (or those ``names``) whole, detached, on this rank's
        device: a sharded leaf gathered (collective: every rank calls it),
        any other the leaf itself, so a caller that keeps it copies it."""
        out = {}
        with torch.no_grad():
            for name in (self.local if names is None else names):
                t = self.local[name].detach()
                for dim, axis in enumerate(self.specs[name]):
                    if axis is not None and self.mesh.axis_size(axis) > 1:
                        t = torch.cat(mh.all_gather(t, self.mesh.group(axis), op="gather_state"),
                                      dim=dim)
                out[name] = t
        return out

    def load_full_state(self, state: Mapping[str, torch.Tensor]) -> None:
        """Copy whole leaves (all or some) into this rank's shards in place;
        a name the model lacks raises KeyError, a shape it does not have
        ValueError."""
        with torch.no_grad():
            for name, t in state.items():
                if name not in self.local:
                    raise KeyError(f"no parameter {name!r} in the model")
                if tuple(t.shape) != self.full_shapes[name]:
                    raise ValueError(f"shape mismatch for {name}: {self.full_shapes[name]} vs "
                                     f"{tuple(t.shape)}")
                self.local[name].copy_(self._shard(t, self.specs[name]))


def batch_block(mesh, shape: Sequence[int]) -> Tuple[slice, slice]:
    """(rows, positions) of the global [B, T] batch this rank computes: rows
    split over (dp, fsdp), dp-major (JAX ``P(("dp", "fsdp"), "sp")``), the
    sequence contiguously over sp."""
    B, T = shape
    nb, ns = mesh.axis_size("dp", "fsdp"), mesh.axis_size("sp")
    if B % nb or T % ns:
        raise ValueError(f"the global batch [{B}, {T}] does not split over (dp, fsdp) = {nb} "
                         f"rows and sp = {ns} sequence blocks")
    b, s = mesh.index("dp", "fsdp"), mesh.index("sp")
    return slice(b * (B // nb), (b + 1) * (B // nb)), slice(s * (T // ns), (s + 1) * (T // ns))


def make_train_step(model: ShardedLM, optimizer) -> Callable:
    """-> step(tokens, mask) over the GLOBAL batch ([B, T] numpy arrays or
    tensors on any device; every rank passes the same; mask may be None) ->
    the global loss (a detached device scalar, the same on every rank;
    reading it waits for the device). One forward of the model, one
    backward, the gradients summed over the data axes, one optimizer update
    of the leaves that require grad; a MoE model's aux joins the loss."""
    from .ring_attention import active_mesh

    mesh, dev = model.mesh, model.device
    data = mesh.group(*_DATA_AXES)
    n_data = mesh.axis_size(*_DATA_AXES)

    def step(tokens, mask) -> torch.Tensor:
        tokens = torch.as_tensor(tokens)
        mask = None if mask is None else torch.as_tensor(mask)
        rows, pos = batch_block(mesh, tuple(tokens.shape))
        targets, tmask, denom = shifted_targets(tokens, mask)
        tok = tokens[rows, pos].to(dev).long()
        tgt, tm = targets[rows, pos].to(dev), tmask[rows, pos].to(dev)
        positions = torch.arange(pos.start, pos.stop, device=dev).expand(tok.shape)
        with active_mesh(mesh):
            out = model.model(tok, positions)
            logits, aux = out if isinstance(out, tuple) else (out, None)
            loss = sharded_causal_lm_loss(logits, tgt, tm, denom.to(dev))
            if aux is not None:
                loss = loss + aux / n_data
            loss.backward()
        model.sync_grads()
        optimizer.step()
        optimizer.zero_grad()
        total = loss.detach().reshape(1)
        if data is not None:
            total = mh.all_reduce(total, data, op="loss_all_reduce")
        return total[0]

    return step
