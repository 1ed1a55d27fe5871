"""LLM experiment configuration.

Reference: ``train/llm/configurations.py:32`` (ExperimentArguments),
``:141`` (ModelArguments), ``:376`` (DatasetArguments) — HF TrainingArguments
subclasses there; plain dataclasses here with the same role: one object per
concern, buildable from the flat Arguments namespace.

A copy of ``fedml_tpu/train/llm/configurations.py``, so one args namespace
drives both packages. Import of an HF checkpoint (``model_name_or_path``)
is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Optional, Tuple


@dataclasses.dataclass
class ModelArguments:
    model_name: str = "llama"          # llama | gpt | transformer preset
    # Local HF checkpoint dir (config.json + *.safetensors [+ tokenizer.json]).
    # When set, geometry comes from its config.json and weights are imported
    # (reference configurations.py:141 model_name_or_path).
    model_name_or_path: Optional[str] = None
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1376
    seq_len: int = 512
    rope_theta: float = 10000.0
    attention_impl: str = "auto"       # auto/pallas (CUDA kernels) | xla | ring
    lora_rank: int = 8
    lora_alpha: float = 16.0
    remat: bool = True
    remat_policy: str = "full"         # full | dots (see TransformerConfig)
    moe_experts: int = 0               # 0 = dense MLP; >0 = Switch MoE
    moe_capacity_factor: float = 1.25

    @classmethod
    def from_args(cls, args: Any) -> "ModelArguments":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: getattr(args, k) for k in fields if hasattr(args, k)})

    def resolve_pretrained(self) -> "ModelArguments":
        """Geometry from a local HF checkpoint's config.json: not ported yet."""
        if not self.model_name_or_path:
            return self
        raise NotImplementedError(
            "model_name_or_path (HF checkpoint import) is not ported to "
            "fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")


@dataclasses.dataclass
class DatasetArguments:
    dataset_name: str = "synthetic_text"
    dataset_path: Optional[str] = None  # local .txt/.jsonl file or dir
    tokenizer_path: Optional[str] = None  # tokenizer.json or checkpoint dir
    text_key: str = "text"              # jsonl field holding the text
    max_seq_length: int = 512
    num_train_samples: int = 2048

    @classmethod
    def from_args(cls, args: Any) -> "DatasetArguments":
        return cls(
            dataset_name=str(getattr(args, "llm_dataset", "synthetic_text")),
            dataset_path=getattr(args, "llm_dataset_path", None),
            tokenizer_path=getattr(args, "llm_tokenizer_path", None),
            text_key=str(getattr(args, "llm_text_key", "text")),
            max_seq_length=int(getattr(args, "seq_len", 512)),
            num_train_samples=int(getattr(args, "num_train_samples", 2048)),
        )


@dataclasses.dataclass
class ExperimentArguments:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    warmup_steps: int = 10
    max_steps: int = 100
    per_device_batch_size: int = 4
    grad_clip: float = 1.0
    seed: int = 0
    # under the caller's temp dir (TMPDIR), not a fixed machine-wide path
    output_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "fedml_tpu_llm"))
    save_steps: int = 0                 # 0 = only final
    # mesh geometry (ZeRO/TP/SP replacement surface)
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1                         # expert parallelism (MoE models)
    pp: int = 1                         # pipeline stages (GPipe schedule)
    pp_microbatches: int = 2

    @classmethod
    def from_args(cls, args: Any) -> "ExperimentArguments":
        fields = {f.name for f in dataclasses.fields(cls)}
        out = cls(**{k: getattr(args, k) for k in fields if hasattr(args, k)})
        out.learning_rate = float(getattr(args, "learning_rate", out.learning_rate))
        return out

    def mesh_shape(self) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
        if self.pp > 1:
            # pipeline mode: ('dp','pp'[,'ep']) mesh; fsdp/tp/sp must be 1
            # (stage params could additionally shard over fsdp/tp in future)
            if any(n > 1 for n in (self.fsdp, self.tp, self.sp)):
                raise ValueError("pp>1 composes only with dp and ep")
            if self.ep > 1:
                return (self.dp, self.pp, self.ep), ("dp", "pp", "ep")
            return (self.dp, self.pp), ("dp", "pp")
        axes, names = [], []
        for n, name in (
            (self.dp, "dp"), (self.fsdp, "fsdp"), (self.tp, "tp"),
            (self.sp, "sp"), (self.ep, "ep"),
        ):
            if n > 1 or name in ("dp", "fsdp"):
                axes.append(n)
                names.append(name)
        return tuple(axes), tuple(names)
