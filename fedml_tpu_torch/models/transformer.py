"""Llama-family causal transformer for the FedLLM path (training forward).

Counterpart of ``fedml_tpu/models/transformer.py``: RMSNorm + rotary + GQA +
SwiGLU, f32 parameters with compute in ``cfg.dtype`` (bf16 by default), one
``torch.utils.checkpoint`` per block for remat, and a pluggable attention:
the hand-written CUDA flash kernels (ops/flash_attention.py) or the plain
einsum math (``xla_attention``).

Module and parameter names mirror the flax tree (``layer_0.attn.q_proj``,
``embed.embedding``, ``lora_a``/``lora_b``) so models/convert.py maps one to
the other by path. Dense weights are stored as ``nn.Linear`` does,
``[out, in]``; LoRA factors keep the JAX shapes ``A [in, r]``, ``B [r, out]``.

This slice is one device, dense and not quantised: ring attention, MoE,
int8 weights and the decode (serving) modes raise NotImplementedError (see
ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1376
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"   # full | dots
    # auto (the CUDA kernels on a CUDA device, plain math elsewhere) | xla
    # (plain math) | pallas (the kernels; their plain versions on the CPU) | ring
    attention_impl: str = "auto"
    lora_rank: int = 0           # 0 = no adapters
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_ep_axis: Any = None
    moe_local_experts: Any = None
    decode: bool = False
    kv_page_size: int = 0
    kv_num_pages: int = 0
    weight_quant: str = "none"   # none | int8

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def from_args(cls, args: Any) -> "TransformerConfig":
        return cls(
            vocab_size=int(getattr(args, "vocab_size", 32000)),
            d_model=int(getattr(args, "d_model", 512)),
            n_layers=int(getattr(args, "n_layers", 4)),
            n_heads=int(getattr(args, "n_heads", 8)),
            n_kv_heads=int(getattr(args, "n_kv_heads", getattr(args, "n_heads", 8))),
            d_ff=int(getattr(args, "d_ff", 1376)),
            max_seq_len=int(getattr(args, "seq_len", 2048)),
            attention_impl=str(getattr(args, "attention_impl", "auto")),
            lora_rank=int(getattr(args, "lora_rank", 0) or 0),
            lora_alpha=float(getattr(args, "lora_alpha", 16.0)),
            remat=bool(getattr(args, "remat", True)),
            remat_policy=str(getattr(args, "remat_policy", "full")),
        )

    @classmethod
    def llama2_7b(cls, **over) -> "TransformerConfig":
        """Llama-2-7B geometry (the Cheetah/FedLLM benchmark model)."""
        base = dict(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=32,
            d_ff=11008, max_seq_len=4096,
        )
        base.update(over)
        return cls(**base)

    def check_supported(self) -> None:
        """Raise NotImplementedError on what this slice of the port lacks."""
        if self.attention_impl == "ring":
            raise _unsupported("attention_impl='ring' (sequence-parallel ring attention)")
        if self.attention_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.moe_experts > 0:
            raise _unsupported("moe_experts > 0 (the MoE MLP)")
        if self.weight_quant != "none":
            raise _unsupported(f"weight_quant={self.weight_quant!r}")
        if self.decode or self.kv_page_size > 0:
            raise _unsupported("decode mode (the KV-cache serving path)")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got {self.remat_policy!r}")


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply RoPE to [B, T, H, D] given positions [B, T]. Rotates interleaved
    pairs (x[..., ::2], x[..., 1::2]); the math is f32, cast back to x's dtype."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[..., None].to(torch.float32) * inv_freq  # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class RMSNorm(nn.Module):
    """f32 math, eps 1e-5, the f32 scale applied before the cast back."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        normed = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.scale).to(x.dtype)


def _lora_target(name: Optional[str], cfg: TransformerConfig) -> bool:
    return name is not None and any(t in name for t in cfg.lora_targets)


class LoRALinear(nn.Module):
    """Dense with an optional low-rank adapter: x.W + (alpha/r)·((x.A).B),
    everything in the activation dtype. The adapter exists only where the
    layer's name contains one of ``cfg.lora_targets``."""

    def __init__(self, in_dim: int, features: int, cfg: TransformerConfig, name: str,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.empty(features, in_dim, device=device))
        r = cfg.lora_rank
        self.has_lora = r > 0 and _lora_target(name, cfg)
        if self.has_lora:
            self.lora_a = nn.Parameter(torch.empty(in_dim, r, device=device))
            self.lora_b = nn.Parameter(torch.zeros(r, features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults in distribution: lecun-normal kernel (std
        1/sqrt(in)), A ~ N(0, 0.02), B = 0."""
        with torch.no_grad():
            self.weight.normal_(0.0, self.weight.shape[1] ** -0.5, generator=generator)
            if self.has_lora:
                self.lora_a.normal_(0.0, 0.02, generator=generator)
                self.lora_b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        if self.has_lora:
            scale = self.cfg.lora_alpha / self.cfg.lora_rank
            y = y + scale * ((x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype))
        return y


def repeat_kv(k: torch.Tensor, v: torch.Tensor, n_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """GQA: repeat kv heads up to n_heads (no-op when already equal)."""
    n_kv = k.shape[2]
    if n_kv != n_heads:
        rep = n_heads // n_kv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def xla_attention(q, k, v, causal: bool = True, mask: Optional[torch.Tensor] = None):
    """Plain einsum attention on [B, T, H, D] (the JAX module's name, kept so
    readers find its counterpart): scale after QK^T in f32, mask fill -1e30,
    probabilities cast to q's dtype before PV."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if mask is None and causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
    if mask is not None:
        logits = torch.where(mask[None, None] if mask.dim() == 2 else mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = LoRALinear(cfg.d_model, cfg.n_heads * hd, cfg, "q_proj", device)
        self.k_proj = LoRALinear(cfg.d_model, cfg.n_kv_heads * hd, cfg, "k_proj", device)
        self.v_proj = LoRALinear(cfg.d_model, cfg.n_kv_heads * hd, cfg, "v_proj", device)
        self.o_proj = LoRALinear(cfg.n_heads * hd, cfg.d_model, cfg, "o_proj", device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = x.shape
        hd = cfg.head_dim
        q = self.q_proj(x).view(B, T, cfg.n_heads, hd)
        k = self.k_proj(x).view(B, T, cfg.n_kv_heads, hd)
        v = self.v_proj(x).view(B, T, cfg.n_kv_heads, hd)
        q = rotary_embedding(q, positions, cfg.rope_theta)
        k = rotary_embedding(k, positions, cfg.rope_theta)
        impl = cfg.attention_impl
        if impl == "auto":
            impl = "pallas" if x.is_cuda else "xla"
        if impl == "pallas":
            # GQA-native: the kernels map query heads to kv heads themselves
            from ..ops.flash_attention import flash_attention

            out = flash_attention(q, k, v, causal=True)
        else:
            k, v = repeat_kv(k, v, cfg.n_heads)
            out = xla_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(B, T, cfg.n_heads * hd))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.gate_proj = LoRALinear(cfg.d_model, cfg.d_ff, cfg, "gate_proj", device)
        self.up_proj = LoRALinear(cfg.d_model, cfg.d_ff, cfg, "up_proj", device)
        self.down_proj = LoRALinear(cfg.d_ff, cfg.d_model, cfg, "down_proj", device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, dim, device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding)


def _dots_policy(ctx, op, *args, **kwargs):
    """remat_policy='dots': keep matmul outputs, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class TransformerLM(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        cfg.check_supported()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, device)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", Block(cfg, device))
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        # untied head (llama style); no adapter: "lm_head" matches no target
        self.lm_head = LoRALinear(cfg.d_model, cfg.vocab_size, cfg, "lm_head", device)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layers)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` with flax's default distributions
        (embedding N(0, 1/d_model), norms 1)."""
        with torch.no_grad():
            self.embed.embedding.normal_(0.0, self.cfg.d_model ** -0.5, generator=generator)
            for m in self.modules():
                if isinstance(m, LoRALinear):
                    m.reset_parameters(generator)
                elif isinstance(m, RMSNorm):
                    m.scale.fill_(1.0)

    def _run_block(self, block: Block, x, positions):
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return block(x, positions)
        if self.cfg.remat_policy == "dots":
            from functools import partial

            from torch.utils.checkpoint import create_selective_checkpoint_contexts

            return checkpoint(block, x, positions, use_reentrant=False,
                              context_fn=partial(create_selective_checkpoint_contexts,
                                                 _dots_policy))
        return checkpoint(block, x, positions, use_reentrant=False)

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed(tokens).to(cfg.dtype)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        for block in self.layers:
            x = self._run_block(block, x, positions)
        x = self.final_norm(x)
        return self.lm_head(x).to(torch.float32)
