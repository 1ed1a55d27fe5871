"""Federated LLM client trainer: only LoRA adapters cross the WAN.

Counterpart of ``fedml_tpu/train/llm/fed_llm_trainer.py`` (reference: the
FedLLM spotlight project, which fine-tunes with PEFT and exchanges adapter
weights). The client holds the full frozen base model on its device, or
over a silo's mesh of ranks its shards (``LLMTrainer``; each round's
batches are the mesh's global batch); get/set_model_params move the adapter subtree only, as nested numpy dicts in
the flax path layout (``layer_0/attn/q_proj/lora_a``), so a 7B base ships
about 0.1% of its bytes per round and a JAX server can fold the result.

The client hooks (JAX ``core/alg_frame/client_trainer.py:63-101``) run on the
adapters. Under local DP (``enable_dp`` with ``dp_solution_type`` ``ldp``,
``nbafl`` or ``dp_clip``) the adapters go to the DP frame as a state dict of
tensors on the trainer's device, and the frame's output comes back as the
flax-layout tree in JAX's flat order; DP-Clip's anchor is the round's
incoming adapters, kept before the first local step. Two hooks are refused
before the first local step, where the JAX client fails:

- ``enable_fhe`` (ROADMAP.md, Queue 3, R14): JAX's ``set_model_params``
  merges the ``Ciphertext`` leaves into the model and raises
  ``AttributeError`` after the round has trained;
- a data-poisoning attack (``label_flipping``, ``edge_case_backdoor``; R15):
  JAX's poisoning unpacks the client's data as a pair and raises
  ``TypeError``, and a causal LM reads no labels to poison.

Any other attack type is the server's (a model attack) and passes the client
untouched, as in JAX.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np
import torch

from ...core.alg_frame.client_trainer import ClientTrainer
from ...models.convert import params_to_jax, wire_order
from .configurations import DatasetArguments, ExperimentArguments, ModelArguments
from .data import TextDataset
from .llm_trainer import LLMTrainer, is_lora_name, synthetic_token_batches

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

    # --- hooks ------------------------------------------------------------
    def _refuse_hooks(self, args: Any) -> None:
        """R14 and R15: FHE and data poisoning on the FedLLM client, where
        the JAX client fails after (FHE) or at (poisoning) its round."""
        from ...core.fhe.fhe_agg import FedMLFHE
        from ...core.security.fedml_attacker import DATA_ATTACKS, FedMLAttacker, attack_type

        if getattr(args, "enable_fhe", False) or FedMLFHE.get_instance().is_fhe_enabled():
            raise ValueError(
                "enable_fhe on the FedLLM client: the JAX client merges the ciphertext "
                "leaves into its model and fails after the round has trained "
                "(AttributeError; ROADMAP.md, Queue 3, R14)")
        atk = attack_type(args)
        if atk in DATA_ATTACKS or FedMLAttacker.get_instance().is_data_poisoning_attack():
            raise ValueError(
                f"attack_type {atk or FedMLAttacker.get_instance().attack_type!r} poisons labels, "
                "which a causal LM never reads, and the JAX client fails unpacking its data "
                "(TypeError; ROADMAP.md, Queue 3, R15)")

    def _adapter_state(self) -> Dict[str, torch.Tensor]:
        """The adapters as the DP frames take them: a state dict of whole
        copies on the trainer's device (over a mesh gathered: every rank
        calls it)."""
        sharded = self.llm.sharded
        return {n: t.clone() for n, t in
                sharded.full_state([n for n in sharded.local if is_lora_name(n)]).items()}

    def on_before_local_training(self, train_data, device, args) -> Any:
        """Refuse R14/R15; under local DP keep the round's incoming
        adapters as DP-Clip's anchor."""
        if not self.enable_hooks:
            return train_data
        from ...core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy

        self._refuse_hooks(args or self.args)
        if FedMLDifferentialPrivacy.get_instance().is_local_dp_enabled():
            self._dp_global_params = self._adapter_state()
        return train_data

    def on_after_local_training(self, train_data, device, args) -> None:
        """Local DP on the trained adapters (JAX ``client_trainer.py:84-101``):
        the frame's output, in JAX's flat order, becomes the upload."""
        if not self.enable_hooks:
            return
        from ...core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy

        self._refuse_hooks(args or self.args)
        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_local_dp_enabled():
            extra = {"global_model_params": getattr(self, "_dp_global_params", None),
                     "local_sample_num": self.local_sample_number or None}
            noised = dp.add_local_noise(self._adapter_state(), extra)
            self.set_model_params(params_to_jax({k: noised[k] for k in wire_order(noised)}))

    # --- adapter-only exchange -------------------------------------------
    def get_model_params(self) -> Dict:
        return self.llm.adapter_params()

    def set_model_params(self, model_parameters: Dict) -> None:
        self.llm.set_named_params(model_parameters)

    def train(self, train_data, device=None, args: Any = None) -> Dict[str, float]:
        """One federated round of local steps.

        train_data: [N, seq_len] int token blocks (an array, or an object
        whose .x is one, as the FL data plane ships them), a TextDataset, or
        None for the synthetic stream. Shards smaller than one global batch
        (``per_device_batch_size`` times the mesh's size) wrap around
        (TextDataset.batches)."""
        args = args or self.args
        steps = int(getattr(args, "local_steps", self.llm.exp_args.max_steps))
        # the global batch: every rank of the silo's mesh draws it and takes its block
        bs = self.llm.exp_args.per_device_batch_size * self.llm.mesh.size
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
