"""LLM fine-tuning trainer on one CUDA device.

Counterpart of ``fedml_tpu/train/llm/llm_trainer.py``. Builds the
transformer from the experiment arguments, trains with the optax-equivalent
chain of ``optim.py`` (LoRA: only adapters train, base weights are frozen
and get no gradient) and checkpoints the named (flax path) layout.

``model_name_or_path`` (an HF llama checkpoint directory) sets the geometry
from its ``config.json`` and overlays its weights on the base (fresh LoRA
adapters kept); ``dataset_path`` trains on local text through
``TextDataset.from_path``, with the checkpoint's ``tokenizer.json`` or one
trained on the corpus, as in the JAX package.

Telemetry as in the JAX package: the loop runs under the ``llm.train`` span
(its synchronised wall time is the tokens/s window and lands in the
``llm.tokens_per_sec`` histogram), the step is registered with devperf as
``llm_train`` with JAX's analytic FLOPs a token, and the window's wall time
is folded into its MFU against the card's peak in the compute dtype.
Mid-training ``save_steps`` checkpoints are enqueued asynchronously
(``wait=False``: the host snapshot is taken, the write runs behind the next
steps) and ``train`` returns only once every save is on disk. Each window
ends with modelwatch's guard (JAX ``:277-312``; on unless
``FEDML_MODELWATCH=0``): one pass over the state dict, leaf by leaf in f32,
gives ``[sq_norm, nan, inf]`` on the device, read after the window's own
sync; it sets ``param_norm`` in the metrics and, on any NaN or Inf or a
non-finite final loss, logs a warning and marks the flight recorder
(``modelwatch_train_guard``).

A mesh (JAX ``:75-170``, ``:248-260``): ``exp_args.mesh_shape()`` laid
over the ranks of the process group (``parallel/multihost.init_distributed``;
``tools/launch_llm.py`` starts them) as a ``RankMesh``; every trainer
runs ``parallel/fsdp.py``'s step over it, which at one position is the
one-device step. Any of ``dp``, ``fsdp``, ``tp``, ``sp`` and ``ep`` above
1 shards it (ZeRO-3 over fsdp, Megatron heads over
tp, ring attention over sp, experts over ep; ``moe_ep_axis="ep"`` when ep
is above 1), equal to the one-rank step: the global batch is
``per_device_batch_size`` times the mesh's size, every rank draws the same
batches and computes its block, the loss is CE plus the MoE aux. The
checkpoint is the whole model, gathered by every rank and written by rank
0. Each rank computes on its own device (``multihost.process_device``).
``pp`` above 1 and ``server_mesh`` raise NotImplementedError (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ...core import telemetry as tel
from ...core.telemetry import devperf, flight_recorder, modelwatch
from ...device import resolve_device
from ...models.convert import params_from_jax, params_to_jax
from ...models.lora import LORA_KEYS
from ...models.transformer import TransformerConfig, TransformerLM
from ...parallel import multihost
from ...parallel.fsdp import ShardedLM, make_train_step
from ...parallel.mesh import RankMesh
from ...utils.checkpoint import CheckpointManager, OwnedTree
from .configurations import DatasetArguments, ExperimentArguments, ModelArguments
from .optim import AdamW, warmup_cosine_decay_schedule

log = logging.getLogger(__name__)


def synthetic_token_batches(
    vocab: int, seq_len: int, batch: int, steps: int, seed: int = 0
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic markov token stream (zero-egress stand-in for HF
    dataset pipelines). Numpy only: bit-identical to the JAX package's."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.ones(vocab) * 0.05, size=vocab).cumsum(axis=1)
    for _ in range(steps):
        toks = np.zeros((batch, seq_len), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        r = rng.random((batch, seq_len))
        for t in range(1, seq_len):
            toks[:, t] = (trans[toks[:, t - 1]] < r[:, t : t + 1]).sum(axis=1)
        yield toks, np.ones_like(toks, np.float32)


def is_lora_name(name: str) -> bool:
    """True for a state-dict name of a LoRA factor (``...q_proj.lora_a``)."""
    return name.rsplit(".", 1)[-1] in LORA_KEYS


def _check_single_device(exp_args: ExperimentArguments) -> None:
    """Refuse what is not ported yet: pipeline stages and the sharded
    server mesh."""
    if int(exp_args.pp) > 1:
        raise NotImplementedError(
            f"pp={exp_args.pp}: pipeline parallelism (parallel/pipeline.py, "
            "train/llm/pp_trainer.py) is not ported to fedml_tpu_torch yet (see ROADMAP.md, "
            "Queue 1)")
    if getattr(exp_args, "server_mesh", None):
        raise NotImplementedError(
            "server_mesh: the sharded FedOpt server is not ported to fedml_tpu_torch yet (see "
            "ROADMAP.md, Queue 1)")


class LLMTrainer:
    def __init__(
        self,
        model_args: ModelArguments,
        data_args: DatasetArguments,
        exp_args: ExperimentArguments,
        device="cuda",
    ):
        self.model_args = model_args = model_args.resolve_pretrained()
        self.data_args = data_args
        self.exp_args = exp_args
        _check_single_device(exp_args)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and multihost.is_initialized():
            self.device = multihost.process_device()
        self.cfg = TransformerConfig(
            vocab_size=model_args.vocab_size,
            d_model=model_args.d_model,
            n_layers=model_args.n_layers,
            n_heads=model_args.n_heads,
            n_kv_heads=model_args.n_kv_heads,
            d_ff=model_args.d_ff,
            max_seq_len=model_args.seq_len,
            rope_theta=model_args.rope_theta,
            attention_impl=model_args.attention_impl,
            lora_rank=model_args.lora_rank,
            lora_alpha=model_args.lora_alpha,
            remat=model_args.remat,
            remat_policy=model_args.remat_policy,
            moe_experts=model_args.moe_experts,
            moe_capacity_factor=model_args.moe_capacity_factor,
            moe_ep_axis="ep" if exp_args.ep > 1 else None,
        )
        self.cfg.check_supported()
        # one position is the one-device step (also in a process of a larger
        # group, e.g. a hierarchical silo's rank)
        self.mesh = RankMesh(*exp_args.mesh_shape())
        if self.mesh.size > 1:
            log.info("LLM mesh: %s", self.mesh)
        self.schedule = warmup_cosine_decay_schedule(
            0.0, exp_args.learning_rate, exp_args.warmup_steps,
            max(exp_args.max_steps, exp_args.warmup_steps + 1))
        self.model: Optional[TransformerLM] = None
        # the model's parameters as this rank's shards (all of each at one position)
        self.sharded: Optional[ShardedLM] = None
        self.optimizer: Optional[AdamW] = None
        self._step_fn = None
        self.ckpt = CheckpointManager(exp_args.output_dir)

    # --- setup -----------------------------------------------------------
    def init_params(self, seed: Optional[int] = None, *, from_jax=None) -> TransformerLM:
        """A model on this trainer's device: random from ``seed`` (default
        exp_args.seed), or the JAX params ``from_jax`` (nested numpy dict);
        then, with ``model_name_or_path``, the checkpoint's base weights over
        it (the adapters, and anything the checkpoint lacks, kept)."""
        model = TransformerLM(self.cfg, device=self.device)
        if from_jax is not None:
            missing, unexpected = model.load_state_dict(params_from_jax(from_jax), strict=False)
            if missing or unexpected:
                raise ValueError(f"JAX params do not match the model: missing {missing}, "
                                 f"unexpected {unexpected}")
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed if seed is not None else self.exp_args.seed)
            model.reset_parameters(gen)
        if self.model_args.model_name_or_path:
            from .checkpoint_import import import_hf_checkpoint

            pretrained = import_hf_checkpoint(self.model_args.model_name_or_path, self.cfg)
            overlay_(model, params_from_jax(pretrained))
            log.info("loaded pretrained weights from %s", self.model_args.model_name_or_path)
        return model

    def _build(self, model: TransformerLM) -> None:
        """Install ``model``: its parameters become this rank's shards over
        the mesh (``ShardedLM``; at one position all of each, unchanged);
        with LoRA only the adapters require grad, so no base gradient is
        ever formed; the optimizer holds the trainable leaves only."""
        lora = self.cfg.lora_rank > 0
        flops_per_token = self._flops_per_token_hint(model)
        self.sharded = ShardedLM(model, self.mesh,
                                 trainable=(is_lora_name if lora else (lambda n: True)))
        self.model = model
        names = [n for n, p in self.sharded.local.items() if p.requires_grad]
        self.optimizer = AdamW([self.sharded.local[n] for n in names], self.schedule,
                               grad_clip=self.exp_args.grad_clip,
                               weight_decay=self.exp_args.weight_decay,
                               norm_groups=self.sharded.norm_groups(names))
        self._devperf_label = "llm_train"
        self._step_fn = devperf.instrument(
            make_train_step(self.sharded, self.optimizer), self._devperf_label,
            n_devices=self.mesh.size, flops_per_token_hint=flops_per_token,
            device=self.device, dtype=self.cfg.dtype)

    def _flops_per_token_hint(self, model: TransformerLM) -> float:
        """Analytic model FLOPs a token of a whole ``model`` (before
        ``_build`` shards it), the JAX trainer's: 6 x the matmul params
        (every param but the embedding table) plus the causal attention
        term; devperf's MFU numerator."""
        n_params = sum(p.numel() for p in model.parameters())
        n_matmul = n_params - self.cfg.vocab_size * self.cfg.d_model
        return (6.0 * n_matmul
                + 6.0 * self.cfg.n_layers * self.cfg.d_model * self.cfg.max_seq_len)

    def named_params(self) -> Dict:
        """All params as a nested numpy dict in the flax path layout (over a
        mesh, gathered whole: every rank must call it)."""
        return params_to_jax(self.sharded.full_state())

    def adapter_params(self) -> Dict:
        """The adapter subtree only (``split_lora``'s paths), without copying
        the base weights off the device."""
        return params_to_jax(self.sharded.full_state(
            [n for n in self.sharded.local if is_lora_name(n)]))

    def set_named_params(self, named: Dict) -> None:
        """Copy a named-layout tree, whole or partial (e.g. adapters only),
        into the model in place."""
        self.sharded.load_full_state(params_from_jax(named))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- loop ------------------------------------------------------------
    def train(self, batches: Optional[Iterator] = None) -> Dict[str, float]:
        """Run up to exp_args.max_steps steps over ``batches`` of (tokens,
        mask) numpy arrays (default: the synthetic stream). Returns
        final_loss, steps, tokens_per_sec over the synchronised window and
        (with modelwatch on) param_norm,
        once the final checkpoint and every mid-training save are on
        disk."""
        if self.sharded is None:
            self._build(self.init_params())
        exp = self.exp_args
        if batches is None:
            global_batch = exp.per_device_batch_size * self.mesh.size
            if self.data_args.dataset_path:
                batches = self.text_batches(global_batch, exp.max_steps)
            else:
                batches = synthetic_token_batches(
                    self.cfg.vocab_size, self.model_args.seq_len, global_batch,
                    exp.max_steps, exp.seed)
        losses, tokens_seen, step = [], 0, 0
        self._sync()
        # the span's synchronised wall time is the tokens/s window; the span
        # itself shows the whole local-training window in round traces
        with tel.timed("llm.train", max_steps=exp.max_steps) as sp:
            for step, (toks, mask) in enumerate(batches):
                # every rank passes the global batch and computes its block
                losses.append(self._step_fn(np.asarray(toks, np.int32),
                                            np.asarray(mask, np.float32)))
                tokens_seen += int(np.size(toks))
                if exp.save_steps and (step + 1) % exp.save_steps == 0:
                    # async enqueue: the host snapshot is taken now, the write
                    # runs behind the next steps and commits the watermark
                    self.save(step + 1, wait=False)
                if step + 1 >= exp.max_steps:
                    break
            # modelwatch's NaN guard and param norm: enqueued before the
            # window's sync, so reading it adds no sync of its own
            guard = self._guard() if modelwatch.enabled(exp) else None
            self._sync()
        dt = sp.duration_s
        tokens_per_sec = tokens_seen / dt if dt > 0 else 0.0
        tel.histogram("llm.tokens_per_sec").observe(tokens_per_sec)
        devperf.observe_window(self._devperf_label, dt, steps=step + 1, tokens=tokens_seen)
        metrics = {
            "final_loss": float(losses[-1]) if losses else float("nan"),
            "steps": step + 1,
            "tokens_per_sec": tokens_per_sec,
        }
        if guard is not None:
            self._guard_window(guard.cpu().numpy().astype(np.float64), metrics)
        log.info("LLM train done: %s", metrics)
        self.save(step + 1)
        # drain any mid-training save still in flight: a returned train()
        # is durable
        self.ckpt.wait_until_finished()
        return metrics

    def _guard(self) -> torch.Tensor:
        """modelwatch's ``[sq_norm, nan, inf]`` of the whole model; over a
        mesh, each set of shards summed over the axes that shard it (a
        replicated leaf counted once)."""
        by_axes: Dict[tuple, dict] = {}
        for n, t in self.sharded.local.items():
            by_axes.setdefault(self.sharded.sharded_axes(n), {})[n] = t.detach()
        total = None
        for axes, leaves in sorted(by_axes.items()):
            g = modelwatch.train_guard(leaves)
            if axes:
                g = multihost.all_reduce(g, self.mesh.group(*axes), op="guard_all_reduce")
            total = g if total is None else total + g
        return total

    @staticmethod
    def _guard_window(g: np.ndarray, metrics: Dict[str, float]) -> None:
        """``param_norm`` from the guard's ``[sq_norm, nan, inf]``, and a
        warning and a flight-recorder mark for a non-finite window."""
        metrics["param_norm"] = float(np.sqrt(max(g[0], 0.0)))
        final_loss = metrics["final_loss"]
        if int(g[1]) + int(g[2]) > 0 or not np.isfinite(final_loss):
            log.warning("modelwatch: non-finite training window (nan=%d inf=%d loss=%s)",
                        int(g[1]), int(g[2]), final_loss)
            flight_recorder.mark("modelwatch_train_guard", nan=int(g[1]), inf=int(g[2]),
                                 final_loss=float(final_loss))

    def text_batches(self, global_batch: int, steps: Optional[int] = None, *,
                     seed: Optional[int] = None):
        """The text of data_args.dataset_path, tokenized (tokenizer_path,
        else the checkpoint's tokenizer.json, else a BPE of at most
        min(vocab_size, 4096) trained on the corpus), packed to seq_len:
        (tokens, mask) batches."""
        from .data import TextDataset, load_or_train_tokenizer

        da = self.data_args
        tok_path = da.tokenizer_path
        if tok_path is None and self.model_args.model_name_or_path:
            cand = os.path.join(self.model_args.model_name_or_path, "tokenizer.json")
            if os.path.exists(cand):
                tok_path = cand
        tok = load_or_train_tokenizer(da.dataset_path, tok_path,
                                      vocab_size=min(self.cfg.vocab_size, 4096))
        if tok.vocab_size > self.cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab {tok.vocab_size} exceeds model vocab {self.cfg.vocab_size}")
        ds = TextDataset.from_path(da.dataset_path, tok, self.model_args.seq_len,
                                   text_key=da.text_key)
        return ds.batches(global_batch, steps, seed=self.exp_args.seed if seed is None else seed)

    # --- checkpointing ----------------------------------------------------
    def save(self, step: int, *, wait: bool = True) -> None:
        """Checkpoint the named layout (loadable by any later layout);
        ``wait=False`` enqueues it behind the training steps. Over a mesh
        every rank gathers and rank 0 writes."""
        named = self.named_params()  # fresh host copies: the save takes them as they are
        if self.mesh.size == 1 or multihost.is_main_process():
            self.ckpt.save(step, OwnedTree(_to_tensors(named)), wait=wait)

    def restore(self, step: Optional[int] = None) -> bool:
        if self.sharded is None:
            self._build(self.init_params())
        restored = self.ckpt.restore(step)
        if restored is None:
            return False
        self.set_named_params(_to_numpy(restored))
        return True


@torch.no_grad()
def overlay_(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` over the model's matching parameters in place; a name
    the model lacks raises KeyError, a shape it does not have ValueError."""
    own = dict(model.named_parameters())
    for name, value in state.items():
        if name not in own:
            raise KeyError(f"no parameter {name!r} in the model")
        if own[name].shape != value.shape:
            raise ValueError(f"shape mismatch for {name}: {tuple(own[name].shape)} vs "
                             f"{tuple(value.shape)}")
        own[name].copy_(value)


def _to_tensors(tree: Dict) -> Dict:
    return {k: _to_tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _to_numpy(tree: Dict) -> Dict:
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}
