"""Local SGD shared by the client trainers: counterpart of
``fedml_tpu/ml/trainer/local_sgd.py``.

The JAX package runs a client's whole local round, (epochs x batches)
steps, as one ``lax.scan``. Here it is a Python loop over the same steps:
the shard is moved to the device once, each step gathers its batch there by
index from the same ``[E, nb, B]`` index and mask arrays
(:func:`epoch_index_array`, numpy, bit-identical to JAX's), and nothing
reads back to the host until the round ends. The last batch of an epoch is
padded to B with repeated rows whose mask is 0: they stay in the batch, as
in JAX, and the loss ignores them.

The client-batched ("vmapped") local round, :func:`make_vmapped_local_train_fn`,
is the counterpart of ``jit(vmap(local_train))`` in the JAX package's vmapped
simulator: every client of the cohort trains from the same global weights
at once. The parameters are stacked ``[K, ...]`` leaves; each step gathers
the K clients' batches outside the vmap, takes the per-client gradients with
``torch.func.vmap(torch.func.grad_and_value(loss))`` over
``torch.func.functional_call``, and steps the stacked leaves with the same
``torch.optim`` optimizer: SGD (momentum, decay) and Adam are elementwise,
so one step over ``[K, ...]`` leaves is K independent client steps (every
client takes the same number of steps, so Adam's shared step count is
right). A padded step (a client with fewer batches than the cohort's
largest) has an all-zero mask and a zero gradient, which is written into
``.grad`` as zeros: weight decay and momentum still apply there, as in JAX.

The optimizers are ``torch.optim``'s, where they compute what optax does:
``add_decayed_weights(wd)`` then ``sgd`` (trace momentum) is
``SGD(momentum, dampening=0, weight_decay=wd)``; ``adam`` is
``Adam(betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)``, decay added to the
gradient before the moments as optax's chain does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...models.model_hub import FedModel
from ...utils.pytree import tree_clone

StateDict = Dict[str, torch.Tensor]

_INT_LABELS = (torch.int32, torch.int64)


def masked_loss(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax cross-entropy over [B] or [B, T] integer labels (a
    [B, T] row is the mean over its tokens), or the mean sigmoid
    cross-entropy over multi-hot [B, C] float labels; the sum over valid rows
    divided by max(valid rows, 1)."""
    return (row_losses(logits, y) * mask).sum() / mask.sum().clamp_min(1.0)


def row_losses(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The per-example losses :func:`masked_loss` weighs by the mask."""
    if y.dtype in _INT_LABELS:
        if y.ndim != logits.ndim - 1:
            raise ValueError(f"label shape {tuple(y.shape)} vs logits {tuple(logits.shape)}")
        c = logits.shape[-1]
        losses = F.cross_entropy(logits.reshape(-1, c), y.reshape(-1).long(),
                                 reduction="none").reshape(y.shape)
        if losses.ndim == 2:  # per token -> per example
            losses = losses.mean(dim=-1)
    else:  # multi-label
        losses = F.binary_cross_entropy_with_logits(logits, y.to(logits.dtype),
                                                    reduction="none").mean(dim=-1)
    return losses


def make_eval_fn(model: FedModel) -> Callable:
    """``eval_batch(params, x, y)`` -> (loss sum, correct) as 0-d tensors on
    the device and the count as a float; ``params`` None evaluates the
    module's own."""

    @torch.no_grad()
    def eval_batch(params: Optional[StateDict], x: torch.Tensor, y: torch.Tensor):
        logits = model.module(x) if params is None else model.apply(params, x)
        if y.dtype in _INT_LABELS and y.ndim == logits.ndim - 1:
            c = logits.shape[-1]
            losses = F.cross_entropy(logits.reshape(-1, c), y.reshape(-1).long(), reduction="none")
            correct = (logits.argmax(dim=-1) == y).sum()
            return losses.sum(), correct.float(), float(y.numel())
        losses = F.binary_cross_entropy_with_logits(logits, y.to(logits.dtype),
                                                    reduction="none").mean(dim=-1)
        pred = (logits > 0).to(y.dtype)
        correct = (pred == y).all(dim=-1).sum()
        return losses.sum(), correct.float(), float(y.shape[0])

    return eval_batch


def evaluate(eval_batch: Callable, params: Optional[StateDict], data, batch_size: int,
             device: torch.device) -> Dict[str, float]:
    """Test metrics over ``data`` (an ArrayDataset) in batches of
    ``batch_size``; the sums run in float64 on the device and are read once,
    where the JAX package adds each batch's f32 sums on the host in float64."""
    x = torch.from_numpy(np.ascontiguousarray(data.x)).to(device)
    y = torch.from_numpy(np.ascontiguousarray(data.y)).to(device)
    sums = torch.zeros(2, dtype=torch.float64, device=device)
    count = 0.0
    for start in range(0, len(data), batch_size):
        loss, correct, n = eval_batch(params, x[start:start + batch_size],
                                      y[start:start + batch_size])
        sums += torch.stack([loss, correct]).double()
        count += n
    loss_sum, correct = sums.tolist()
    return {
        "test_loss": loss_sum / max(count, 1.0),
        "test_correct": correct,
        "test_total": count,
        "test_acc": correct / max(count, 1.0),
    }


def create_client_optimizer(args: Any, params) -> torch.optim.Optimizer:
    """The client optimizer over ``params`` (see the module docstring)."""
    name = str(getattr(args, "client_optimizer", "sgd")).lower()
    lr = float(getattr(args, "learning_rate", 0.03))
    wd = float(getattr(args, "weight_decay", 0.0))
    momentum = float(getattr(args, "momentum", 0.0))
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=max(momentum, 0.0), dampening=0.0,
                               weight_decay=max(wd, 0.0))
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=max(wd, 0.0))
    raise ValueError(f"unknown client optimizer {name!r}")


def epoch_index_array(n: int, batch_size: int, epochs: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """[E, nb, B] gather indices + [E, nb, B] masks; fresh shuffle per epoch
    (matches torch DataLoader(shuffle=True) semantics). A copy of the JAX
    package's function: the same seed gives the same arrays."""
    nb = max(1, -(-n // batch_size))
    total = nb * batch_size
    idx = np.zeros((epochs, total), np.int32)
    mask = np.zeros((epochs, total), np.float32)
    rng = np.random.default_rng(seed)
    for e in range(epochs):
        perm = rng.permutation(n)
        # pad may exceed n (shard smaller than one batch): cycle the perm
        idx[e] = np.resize(perm, total)
        mask[e] = np.concatenate([np.ones(n, np.float32), np.zeros(total - n, np.float32)])
    return idx.reshape(epochs, nb, batch_size), mask.reshape(epochs, nb, batch_size)


class LocalTrainResult(NamedTuple):
    params: StateDict          # the module's own parameters (views, not copies); stacked
                               # [K, ...] leaves from the client-batched round
    loss: torch.Tensor         # mean loss over all local steps, 0-d ([K] batched), on the device
    num_steps: int             # total optimizer steps taken


def make_local_train_fn(model: FedModel, args: Any, *, grad_transform: Optional[Callable] = None):
    """Build the whole-local-round function
    ``local_train(x_all, y_all, idx, mask, rng, extras, *, dp=None)``: trains
    ``model.module`` in place from the parameters it holds, over the steps
    ``idx``/``mask`` ([E, nb, B] numpy arrays) give, with a fresh optimizer.

    ``grad_transform(grads, params, global_params, extras)`` lets algorithm
    variants correct the gradients (state dicts in, a state dict out);
    FedProx's proximal term ``0.5 * mu * ||w - w_global||^2`` joins the loss
    when ``args.fedprox_mu`` > 0. ``rng`` is the ``torch.Generator`` dropout
    draws from.

    ``dp`` (a ``parallel.dp.DataParallelGroup``) splits every batch over the
    silo's ranks (``parallel/dp.py`` states the rule): this rank's share of
    the batch, its masked loss over the whole batch's count, the proximal
    term on the group's rank 0 only, then one all-reduce a step of the
    gradients and the loss before the gradient transform and the
    optimizer's step, which every rank takes alike.
    """
    loss_fn = make_client_loss_fn(model, args)
    mu = float(getattr(args, "fedprox_mu", 0.0) or 0.0)
    module = model.module

    def local_train(x_all, y_all, idx, mask, rng, extras=None, *, dp=None) -> LocalTrainResult:
        params = dict(module.named_parameters())
        dev = next(iter(params.values())).device
        global_params = tree_clone(params) if mu > 0.0 or grad_transform is not None else None
        opt = create_client_optimizer(args, list(params.values()))
        e, nb, b = idx.shape
        steps = e * nb
        idx, mask = idx.reshape(steps, b), mask.reshape(steps, b)
        count, prox_params = None, global_params
        if dp is not None:
            # the whole batch's count, from the host mask every rank holds
            count = torch.from_numpy(np.maximum(mask.sum(axis=1, dtype=np.float32), 1.0)).to(dev)
            idx, mask = idx[:, dp.batch_slice(b)], mask[:, dp.batch_slice(b)]
            prox_params = global_params if dp.rank == 0 else None
        flat_idx = torch.from_numpy(np.ascontiguousarray(idx)).to(dev).long()
        flat_mask = torch.from_numpy(np.ascontiguousarray(mask)).to(dev)
        losses = torch.empty(steps, device=dev)
        for s in range(steps):
            bx = x_all.index_select(0, flat_idx[s])
            by = y_all.index_select(0, flat_idx[s])
            loss = loss_fn(None, bx, by, flat_mask[s], prox_params, rng,
                           None if count is None else count[s])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if dp is not None:
                loss = dp.all_reduce_grads_(params, loss)
            if grad_transform is not None:
                grads = {k: p.grad for k, p in params.items()}
                current = {k: p.detach() for k, p in params.items()}
                new = grad_transform(grads, current, global_params, extras)
                for k, p in params.items():
                    p.grad = new[k]
            opt.step()
            losses[s] = loss.detach()
        return LocalTrainResult({k: p.detach() for k, p in params.items()}, losses.mean(), steps)

    return local_train


def make_client_loss_fn(model: FedModel, args: Any) -> Callable:
    """``loss(params, x, y, mask, global_params, rng=None, count=None)``: one client's
    masked loss in training mode, plus FedProx's ``0.5 * mu * ||params -
    global_params||^2`` when ``args.fedprox_mu`` > 0. ``params`` None runs
    the module's own parameters (the eager loop: autograd fills their
    ``.grad``); a state dict runs through ``torch.func.functional_call``
    (the client-batched round). Dropout draws from ``rng``, or with None
    from the default generator of the data's device (inside
    ``torch.func.vmap`` only that one is allowed). ``count`` divides the
    masked sum in place of ``max(mask.sum(), 1)`` (a data-parallel rank's
    shard of a batch, over the whole batch's count); the proximal term is
    added only where ``global_params`` is given."""
    module = model.module
    mu = float(getattr(args, "fedprox_mu", 0.0) or 0.0)

    def loss(params, x, y, mask, global_params, rng=None, count=None):
        kwargs = {"train": True, "rng": rng}
        if params is None:
            logits = module(x, **kwargs)
        else:
            logits = torch.func.functional_call(module, params, (x,), kwargs)
        if count is None:
            out = masked_loss(logits, y, mask)
        else:
            out = (row_losses(logits, y) * mask).sum() / count
        if mu > 0.0 and global_params is not None:
            own = dict(module.named_parameters()) if params is None else params
            prox = sum(torch.sum(torch.square(p - global_params[k])) for k, p in own.items())
            out = out + 0.5 * mu * prox
        return out

    return loss


def make_vmapped_local_train_fn(model: FedModel, args: Any):
    """Build the client-batched local round
    ``local_train(w_global, x_all, y_all, idx, mask, round_idx)``:
    ``x_all``/``y_all`` are the cohort's padded shards ``[K, N, ...]`` and
    ``idx``/``mask`` their ``[K, E, nb, B]`` index and mask arrays, all on the
    device of ``w_global``. Every client starts from ``w_global`` (left
    unmoved) with a fresh optimizer; the result holds the K clients' weights
    as stacked ``[K, ...]`` leaves and their mean losses ``[K]``. The clients'
    dropout draws come from the device's default generator seeded with
    ``round_idx`` for the round (and restored after it), so a seeded round
    repeats bit for bit."""
    step = torch.func.vmap(torch.func.grad_and_value(make_client_loss_fn(model, args)),
                           in_dims=(0, 0, 0, 0, None), randomness="different")

    def local_train(w_global: StateDict, x_all, y_all, idx, mask,
                    round_idx: int) -> LocalTrainResult:
        k, e, nb, b = idx.shape
        steps = e * nb
        dev = x_all.device
        # real tensors, not views of the global: the optimizer moves them in place
        stacked = {n: v.detach().expand(k, *v.shape).clone() for n, v in w_global.items()}
        opt = create_client_optimizer(args, list(stacked.values()))
        flat_idx = idx.reshape(k, steps, b).long()
        flat_mask = mask.reshape(k, steps, b)
        rows = torch.arange(k, device=dev)[:, None]
        losses = []
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(int(round_idx))
            for s in range(steps):
                grads, loss = step(stacked, x_all[rows, flat_idx[:, s]],
                                   y_all[rows, flat_idx[:, s]], flat_mask[:, s], w_global)
                for n, p in stacked.items():
                    p.grad = grads[n]
                opt.step()
                losses.append(loss)
        return LocalTrainResult(stacked, torch.stack(losses, dim=1).mean(dim=1), steps)

    return local_train
