"""Federated LLM client trainer: only LoRA adapters cross the WAN.

Counterpart of ``fedml_tpu/train/llm/fed_llm_trainer.py`` (reference: the
FedLLM spotlight project, which fine-tunes with PEFT and exchanges adapter
weights). The client holds the full frozen base model on its device;
get/set_model_params move the adapter subtree only, as nested numpy dicts in
the flax path layout (``layer_0/attn/q_proj/lora_a``), so a 7B base ships
about 0.1% of its bytes per round and a JAX server can fold the result.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np

from ...core.alg_frame.client_trainer import ClientTrainer
from .configurations import DatasetArguments, ExperimentArguments, ModelArguments
from .data import TextDataset
from .llm_trainer import LLMTrainer, synthetic_token_batches

log = logging.getLogger(__name__)


class LLMClientTrainer(ClientTrainer):
    def __init__(self, args: Any, device="cuda"):
        self.llm = LLMTrainer(
            ModelArguments.from_args(args), DatasetArguments.from_args(args),
            ExperimentArguments.from_args(args), device=device,
        )
        if self.llm.cfg.lora_rank <= 0:
            raise ValueError("federated LLM requires lora_rank > 0 (only adapters cross the WAN)")
        super().__init__(self.llm, args)
        self.llm._build(self.llm.init_params())

    # --- adapter-only exchange -------------------------------------------
    def get_model_params(self) -> Dict:
        return self.llm.adapter_params()

    def set_model_params(self, model_parameters: Dict) -> None:
        self.llm.set_named_params(model_parameters)

    def train(self, train_data, device=None, args: Any = None) -> Dict[str, float]:
        """One federated round of local steps.

        train_data: [N, seq_len] int token blocks (an array, or an object
        whose .x is one, as the FL data plane ships them), a TextDataset, or
        None for the synthetic stream. Shards smaller than one batch wrap
        around (TextDataset.batches)."""
        args = args or self.args
        steps = int(getattr(args, "local_steps", self.llm.exp_args.max_steps))
        bs = self.llm.exp_args.per_device_batch_size
        # distinct data each round: the seed mixes the round counter, else
        # every round would replay the shard's same first steps*bs blocks
        self._round = getattr(self, "_round", 0) + 1
        seed = int(self.id or 0) * 100003 + self._round
        if isinstance(train_data, TextDataset):
            batches = train_data.batches(bs, steps, seed=seed)
        elif train_data is not None:
            blocks = np.asarray(getattr(train_data, "x", train_data), np.int32)
            if blocks.ndim != 2 or blocks.shape[1] != self.llm.model_args.seq_len:
                raise ValueError(
                    f"LLM client data must be [N, seq_len={self.llm.model_args.seq_len}] "
                    f"token blocks, got {blocks.shape}")
            batches = TextDataset(blocks).batches(bs, steps, seed=seed)
        else:
            batches = synthetic_token_batches(
                self.llm.cfg.vocab_size, self.llm.model_args.seq_len, bs, steps, seed=seed)
        self.llm.exp_args.max_steps = steps
        metrics = self.llm.train(batches)
        log.info("client %s LLM round: %s", self.id, metrics)
        return metrics
