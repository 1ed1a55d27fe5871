"""HF llama-family checkpoint <-> TransformerLM params: counterpart of
``fedml_tpu/train/llm/checkpoint_import.py``.

Reference: the FedLLM path loads pretrained Llama-2/Pythia checkpoints by
name (``train/llm/configurations.py:141`` ``ModelArguments.model_name_or_path``,
``hf_trainer.py:28``, ``python/spotlight_prj/fedllm/README.md``). Here the
import is a pure tensor-name/layout mapping from the HF llama serialization
to the flax-layout numpy tree the JAX package's import returns; the port's
models take that tree through ``models/convert.py`` (``params_from_jax``),
so one function maps JAX's parameters and an HF checkpoint's alike.

Name map (HF -> pytree path, kernels transposed [out,in] -> [in,out]):

    model.embed_tokens.weight                      embed/embedding        (no T)
    model.layers.{i}.self_attn.{q,k,v}_proj.weight layer_{i}/attn/*_proj/kernel  (T + rope perm for q,k)
    model.layers.{i}.self_attn.o_proj.weight       layer_{i}/attn/o_proj/kernel  (T)
    model.layers.{i}.mlp.{gate,up,down}_proj.weight layer_{i}/mlp/*_proj/kernel  (T)
    model.layers.{i}.input_layernorm.weight        layer_{i}/attn_norm/scale
    model.layers.{i}.post_attention_layernorm.weight layer_{i}/mlp_norm/scale
    model.norm.weight                              final_norm/scale
    lm_head.weight                                 lm_head/kernel         (T)

RoPE convention: HF llama stores q/k projections for the rotate_half
convention (pair = (j, j+d/2)); models/transformer.py uses the interleaved
convention (pair = (2j, 2j+1)). ``_rope_perm`` reorders each head's output
rows so the two produce identical attention — the same permutation HF's own
Meta->HF conversion script applies, inverted.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

import torch

from ...models.transformer import TransformerConfig
from .safetensors_io import load_checkpoint_tensors, save_safetensors


def _f32(x) -> np.ndarray:
    """A leaf (numpy array, or a tensor of any dtype) as a float32 array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _rope_perm(n_heads: int, head_dim: int, inverse: bool = False) -> np.ndarray:
    """Row permutation mapping rotate_half head layout -> interleaved."""
    half = head_dim // 2
    perm_one = np.empty(head_dim, dtype=np.int64)
    for j in range(half):
        perm_one[2 * j] = j          # interleaved even slot <- first half
        perm_one[2 * j + 1] = j + half  # odd slot <- second half
    if inverse:
        inv = np.empty_like(perm_one)
        inv[perm_one] = np.arange(head_dim)
        perm_one = inv
    return np.concatenate([perm_one + h * head_dim for h in range(n_heads)])


def config_from_hf(model_dir: str, **overrides: Any) -> TransformerConfig:
    """Build a TransformerConfig from an HF config.json (llama family)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    base = dict(
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        d_ff=hf["intermediate_size"],
        max_seq_len=hf.get("max_position_embeddings", 2048),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
    )
    base.update(overrides)
    return TransformerConfig(**base)


def import_hf_checkpoint(
    model_dir: str, cfg: Optional[TransformerConfig] = None, dtype: Any = np.float32
) -> Dict[str, Any]:
    """Load an HF llama safetensors checkpoint into the TransformerLM param
    tree in the flax layout: the {'embed': ..., 'layer_i': ..., ...} dict of
    numpy arrays the JAX package's import returns (BF16 tensors widened to
    ``dtype``, float32 by default, exactly)."""
    cfg = cfg or config_from_hf(model_dir)
    raw = load_checkpoint_tensors(model_dir)

    def get(name: str) -> np.ndarray:
        if name not in raw:
            raise KeyError(f"checkpoint missing tensor {name!r} (have {len(raw)} tensors)")
        arr = _f32(raw[name])  # a view of the file's buffer, or a fresh widening of bf16
        return arr if np.dtype(dtype) == np.float32 else arr.astype(dtype)

    q_perm = _rope_perm(cfg.n_heads, cfg.head_dim)
    kv_perm = _rope_perm(cfg.n_kv_heads, cfg.head_dim)

    params: Dict[str, Any] = {
        "embed": {"embedding": get("model.embed_tokens.weight")},
        "final_norm": {"scale": get("model.norm.weight")},
    }
    if "lm_head.weight" in raw:
        params["lm_head"] = {"kernel": get("lm_head.weight").T}
    else:  # tied embeddings (e.g. tinyllama variants)
        params["lm_head"] = {"kernel": get("model.embed_tokens.weight").T}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        params[f"layer_{i}"] = {
            "attn": {
                "q_proj": {"kernel": get(p + "self_attn.q_proj.weight")[q_perm].T},
                "k_proj": {"kernel": get(p + "self_attn.k_proj.weight")[kv_perm].T},
                "v_proj": {"kernel": get(p + "self_attn.v_proj.weight").T},
                "o_proj": {"kernel": get(p + "self_attn.o_proj.weight").T},
            },
            "mlp": {
                "gate_proj": {"kernel": get(p + "mlp.gate_proj.weight").T},
                "up_proj": {"kernel": get(p + "mlp.up_proj.weight").T},
                "down_proj": {"kernel": get(p + "mlp.down_proj.weight").T},
            },
            "attn_norm": {"scale": get(p + "input_layernorm.weight")},
            "mlp_norm": {"scale": get(p + "post_attention_layernorm.weight")},
        }
    return params


def export_hf_checkpoint(params: Dict[str, Any], cfg: TransformerConfig, model_dir: str,
                         dtype: Any = np.float32) -> None:
    """Write the flax-layout param tree back to HF llama layout (single
    shard), in ``dtype``: float32 as the JAX package writes, or
    ``torch.bfloat16`` (rounded to nearest even), the dtype HF ships llama
    checkpoints in.

    Exact inverse of import_hf_checkpoint (LoRA adapters, if present, must be
    merged into kernels first — models/lora.py)."""
    os.makedirs(model_dir, exist_ok=True)
    q_inv = _rope_perm(cfg.n_heads, cfg.head_dim, inverse=True)
    kv_inv = _rope_perm(cfg.n_kv_heads, cfg.head_dim, inverse=True)
    out: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": _f32(params["embed"]["embedding"]),
        "model.norm.weight": _f32(params["final_norm"]["scale"]),
        "lm_head.weight": _f32(params["lm_head"]["kernel"]).T,
    }
    for i in range(cfg.n_layers):
        lay = params[f"layer_{i}"]
        p = f"model.layers.{i}."
        out[p + "self_attn.q_proj.weight"] = _f32(lay["attn"]["q_proj"]["kernel"]).T[q_inv]
        out[p + "self_attn.k_proj.weight"] = _f32(lay["attn"]["k_proj"]["kernel"]).T[kv_inv]
        out[p + "self_attn.v_proj.weight"] = _f32(lay["attn"]["v_proj"]["kernel"]).T
        out[p + "self_attn.o_proj.weight"] = _f32(lay["attn"]["o_proj"]["kernel"]).T
        out[p + "mlp.gate_proj.weight"] = _f32(lay["mlp"]["gate_proj"]["kernel"]).T
        out[p + "mlp.up_proj.weight"] = _f32(lay["mlp"]["up_proj"]["kernel"]).T
        out[p + "mlp.down_proj.weight"] = _f32(lay["mlp"]["down_proj"]["kernel"]).T
        out[p + "input_layernorm.weight"] = _f32(lay["attn_norm"]["scale"])
        out[p + "post_attention_layernorm.weight"] = _f32(lay["mlp_norm"]["scale"])
    if dtype is not torch.bfloat16 and np.dtype(dtype) != np.float32:
        raise ValueError(f"export dtype must be float32 or torch.bfloat16, got {dtype!r}")
    # the layout changes (transposes) as torch copies, which use every core
    out = {k: torch.from_numpy(v).to(dtype if dtype is torch.bfloat16 else torch.float32,
                                     memory_format=torch.contiguous_format)
           for k, v in out.items()}
    save_safetensors(out, os.path.join(model_dir, "model.safetensors"), metadata={"format": "pt"})
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(
            {
                "architectures": ["LlamaForCausalLM"],
                "model_type": "llama",
                "vocab_size": cfg.vocab_size,
                "hidden_size": cfg.d_model,
                "num_hidden_layers": cfg.n_layers,
                "num_attention_heads": cfg.n_heads,
                "num_key_value_heads": cfg.n_kv_heads,
                "intermediate_size": cfg.d_ff,
                "max_position_embeddings": cfg.max_seq_len,
                "rope_theta": cfg.rope_theta,
                "rms_norm_eps": 1e-5,
            },
            f,
            indent=2,
        )
