"""LLM fine-tuning trainer on one CUDA device.

Counterpart of ``fedml_tpu/train/llm/llm_trainer.py``. Builds the
transformer from the experiment arguments, trains with the optax-equivalent
chain of ``optim.py`` (LoRA: only adapters train, base weights are frozen
and get no gradient) and checkpoints the named (flax path) layout.

This slice is one device: any mesh axis above 1 (dp, fsdp, tp, sp, ep, pp)
raises NotImplementedError, as do text datasets (the tokenizer is not ported)
and HF checkpoint import. Telemetry (spans, devperf, modelwatch) waits for a
later slice (ROADMAP.md).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...models.convert import params_from_jax, params_to_jax
from ...models.lora import LORA_KEYS
from ...models.transformer import TransformerConfig, TransformerLM
from ...parallel.fsdp import make_train_step
from ...utils.checkpoint import CheckpointManager
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
    axes = {n: getattr(exp_args, n) for n in ("dp", "fsdp", "tp", "sp", "ep", "pp")}
    wide = {n: v for n, v in axes.items() if int(v) > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: fedml_tpu_torch trains on one device in this slice "
            "(see ROADMAP.md, Queue 1)")


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
        )
        self.cfg.check_supported()
        self.schedule = warmup_cosine_decay_schedule(
            0.0, exp_args.learning_rate, exp_args.warmup_steps,
            max(exp_args.max_steps, exp_args.warmup_steps + 1))
        self.model: Optional[TransformerLM] = None
        self.optimizer: Optional[AdamW] = None
        self._step_fn = None
        self.ckpt = CheckpointManager(exp_args.output_dir)

    # --- setup -----------------------------------------------------------
    def init_params(self, seed: Optional[int] = None, *, from_jax=None) -> TransformerLM:
        """A model on this trainer's device: random from ``seed`` (default
        exp_args.seed), or the JAX params ``from_jax`` (nested numpy dict)."""
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
        return model

    def _build(self, model: TransformerLM) -> None:
        """Install ``model``: with LoRA only the adapters require grad, so no
        base gradient is ever formed; the optimizer holds the trainable
        tensors only."""
        lora = self.cfg.lora_rank > 0
        trainable = []
        for name, p in model.named_parameters():
            train = is_lora_name(name) if lora else True
            p.requires_grad_(train)
            if train:
                trainable.append(p)
        self.model = model
        self.optimizer = AdamW(trainable, self.schedule, grad_clip=self.exp_args.grad_clip,
                               weight_decay=self.exp_args.weight_decay)
        self._step_fn = make_train_step(model, self.optimizer)

    def named_params(self) -> Dict:
        """All params as a nested numpy dict in the flax path layout."""
        return params_to_jax(self.model)

    def adapter_params(self) -> Dict:
        """The adapter subtree only (``split_lora``'s paths), without copying
        the base weights off the device."""
        return params_to_jax({n: t for n, t in self.model.state_dict().items() if is_lora_name(n)})

    @torch.no_grad()
    def set_named_params(self, named: Dict) -> None:
        """Copy a named-layout tree, whole or partial (e.g. adapters only),
        into the model in place."""
        own = dict(self.model.named_parameters())
        for name, value in params_from_jax(named).items():
            if name not in own:
                raise KeyError(f"no parameter {name!r} in the model")
            if own[name].shape != value.shape:
                raise ValueError(f"shape mismatch for {name}: {tuple(own[name].shape)} vs "
                                 f"{tuple(value.shape)}")
            own[name].copy_(value)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- loop ------------------------------------------------------------
    def train(self, batches: Optional[Iterator] = None) -> Dict[str, float]:
        """Run up to exp_args.max_steps steps over ``batches`` of (tokens,
        mask) numpy arrays (default: the synthetic stream). Returns
        final_loss, steps and tokens_per_sec over the synchronised window."""
        if self.model is None:
            self._build(self.init_params())
        exp = self.exp_args
        if batches is None:
            if self.data_args.dataset_path:
                raise NotImplementedError(
                    "dataset_path needs the tokenizer, which is not ported to "
                    "fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")
            batches = synthetic_token_batches(
                self.cfg.vocab_size, self.model_args.seq_len, exp.per_device_batch_size,
                exp.max_steps, exp.seed)
        losses, tokens_seen, step = [], 0, 0
        self._sync()
        t0 = time.perf_counter()
        for step, (toks, mask) in enumerate(batches):
            tokens = torch.from_numpy(np.asarray(toks, np.int32)).to(self.device)
            mask_t = torch.from_numpy(np.asarray(mask, np.float32)).to(self.device)
            losses.append(self._step_fn(tokens, mask_t))
            tokens_seen += int(np.size(toks))
            if exp.save_steps and (step + 1) % exp.save_steps == 0:
                self.save(step + 1)
            if step + 1 >= exp.max_steps:
                break
        self._sync()
        dt = time.perf_counter() - t0
        metrics = {
            "final_loss": float(losses[-1]) if losses else float("nan"),
            "steps": step + 1,
            "tokens_per_sec": tokens_seen / dt if dt > 0 else 0.0,
        }
        log.info("LLM train done: %s", metrics)
        self.save(step + 1)
        return metrics

    # --- checkpointing ----------------------------------------------------
    def save(self, step: int) -> None:
        """Checkpoint the named layout (loadable by any later layout)."""
        self.ckpt.save(step, _to_tensors(self.named_params()))

    def restore(self, step: Optional[int] = None) -> bool:
        if self.model is None:
            self._build(self.init_params())
        restored = self.ckpt.restore(step)
        if restored is None:
            return False
        self.set_named_params(_to_numpy(restored))
        return True


def _to_tensors(tree: Dict) -> Dict:
    return {k: _to_tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _to_numpy(tree: Dict) -> Dict:
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}
