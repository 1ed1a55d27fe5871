"""Llama-family causal transformer for the FedLLM path: training forward and
the KV-cache decode modes of serving.

Counterpart of ``fedml_tpu/models/transformer.py``: RMSNorm + rotary + GQA +
SwiGLU, f32 parameters with compute in ``cfg.dtype`` (bf16 by default), one
``torch.utils.checkpoint`` per block for remat, and a pluggable attention:
the hand-written CUDA flash kernels (ops/flash_attention.py) or the plain
einsum math (``xla_attention``).

Module and parameter names mirror the flax tree (``layer_0.attn.q_proj``,
``embed.embedding``, ``lora_a``/``lora_b``) so models/convert.py maps one to
the other by path. Dense weights are stored as ``nn.Linear`` does,
``[out, in]``; LoRA factors keep the JAX shapes ``A [in, r]``, ``B [r, out]``.

Decode (``cfg.decode``, the serving model): there is no flax "cache"
collection. The cache is an explicit nested dict that mirrors the flax
collection's paths, ``cache["layer_i"]["attn"]`` = ``{"k", "v", "idx"}``
(``init_cache``), passed to ``forward(..., cache=cache)`` and UPDATED IN
PLACE (k/v written at the write index, idx advanced). Three modes, as in
JAX: a contiguous ``[B, max_seq_len, kv, hd]`` cache with a shared write
index (prefill, single-token steps, the left-pad ``attn_start`` mask); its
per-row ``cache_idx`` slot mode; and, when ``block_tables`` are passed, a
page pool ``[kv_num_pages, kv_page_size, kv, hd]`` (``init_cache`` of a
config with ``kv_page_size > 0``) addressed through them. One decode model
serves all three, so the paged engine's contiguous prefill and its paged
steps share one set of weights. Every decode mode runs the plain masked ``xla_attention``,
never the flash kernels. A decode model called without a cache runs the
plain causal forward of the same weights (the non-cached reference).

A decode model holds its dense weights, embedding and LoRA factors in
``cfg.dtype``, cast once when loaded (``generation.decode_model``); RMSNorm
scales stay f32. The JAX model casts its f32 kernels to the activation dtype
on every call; the f32 -> bf16 cast rounds to nearest even either way, so
both multiply the same bf16 values, and decode reads half the bytes per
token.

Weight-only int8 (``weight_quant="int8"``, serving/quant.py): each dense
holds ``kernel_q`` int8 ``[out, in]`` and ``kernel_scale`` f32 ``[out]``
(buffers) in place of ``weight``, and its product runs through the int8
GEMM (ops/int8_matmul.py: the CUDA kernel on the card, its plain version
on the CPU), as JAX's ``dot_general`` on the int8 operand. Its backward is
not ported: an int8 forward whose input needs a gradient raises
NotImplementedError, as JAX serves int8 only on the decode path.

This slice is one device and dense: ring attention and MoE raise
NotImplementedError (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import int8_matmul as int8_ops


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
        if self.weight_quant not in ("none", "int8"):
            raise ValueError(f"weight_quant must be 'none' or 'int8', got {self.weight_quant!r}")
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


def _weight_dtype(cfg: TransformerConfig) -> torch.dtype:
    """f32 master weights for training; ``cfg.dtype`` for a decode model."""
    return cfg.dtype if cfg.decode else torch.float32


class LoRALinear(nn.Module):
    """Dense with an optional low-rank adapter: x.W + (alpha/r)·((x.A).B),
    everything in the activation dtype. The adapter exists only where the
    layer's name contains one of ``cfg.lora_targets``. Under
    ``weight_quant="int8"`` W is ``kernel_q`` (int8 ``[out, in]``) times
    ``kernel_scale`` (f32 ``[out]``), JAX's zeros and ones until loaded."""

    def __init__(self, in_dim: int, features: int, cfg: TransformerConfig, name: str,
                 device=None):
        super().__init__()
        self.cfg = cfg
        dtype = _weight_dtype(cfg)
        self.int8 = cfg.weight_quant == "int8"
        if self.int8:
            self.register_buffer("kernel_q", torch.zeros(features, in_dim, device=device,
                                                         dtype=torch.int8))
            self.register_buffer("kernel_scale", torch.ones(features, device=device))
            self._int8_checked = None  # the weights check_weights last passed
        else:
            self.weight = nn.Parameter(torch.empty(features, in_dim, device=device, dtype=dtype))
        r = cfg.lora_rank
        self.has_lora = r > 0 and _lora_target(name, cfg)
        if self.has_lora:
            self.lora_a = nn.Parameter(torch.empty(in_dim, r, device=device, dtype=dtype))
            self.lora_b = nn.Parameter(torch.zeros(r, features, device=device, dtype=dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults in distribution: lecun-normal kernel (std
        1/sqrt(in)), A ~ N(0, 0.02), B = 0."""
        with torch.no_grad():
            if not self.int8:
                self.weight.normal_(0.0, self.weight.shape[1] ** -0.5, generator=generator)
            if self.has_lora:
                self.lora_a.normal_(0.0, 0.02, generator=generator)
                self.lora_b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8:
            if torch.is_grad_enabled() and x.requires_grad:
                raise NotImplementedError(
                    "the int8 GEMM's backward is not ported to fedml_tpu_torch yet (see "
                    "ROADMAP.md, Queue 1): run int8 weights without a gradient, as decoding does")
            kq, ks = self.kernel_q, self.kernel_scale
            if x.is_cuda:
                # the weights are checked for the kernel once, not on every call
                key = (id(kq), id(ks), kq.data_ptr(), ks.data_ptr())
                if key != self._int8_checked:
                    int8_ops.check_weights(kq, ks)
                    self._int8_checked = key
            # x . kernel_q^T accumulated in f32, times the f32 scale, then
            # one cast to x's dtype (JAX's dot_general on the int8 operand)
            y = int8_ops.int8_matmul(x, kq, ks, weights_checked=True)
        else:
            # a no-op for a decode model, whose weights already are x's dtype
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


def pick_attention(impl: str, on_cuda: bool, head_dim: int, dtype: torch.dtype) -> str:
    """The attention a training forward runs: ``"auto"`` takes the flash
    kernels ("pallas") on CUDA and the plain masked attention ("xla") on
    the CPU; an explicit choice stands. On CUDA, a head dim or dtype the
    kernels do not take (``ops.flash_attention.kernels_take``: a head dim
    that is not a multiple of 8 or is above 256, a dtype other than bf16,
    float16 and f32) raises ``NotImplementedError``: the port has no kernel
    instance for it, and it does not swap in the plain attention unasked
    (``attention_impl="xla"`` asks for it)."""
    if impl != "auto":
        return impl
    if not on_cuda:
        return "xla"
    from ..ops.flash_attention import kernel_rule, kernels_take

    if not kernels_take(head_dim, dtype):
        raise NotImplementedError(
            f"the flash kernels have no instance for head dim {head_dim}, {dtype} (they take "
            f"{kernel_rule()}); what they refuse is listed in ROADMAP.md. "
            f"attention_impl='xla' runs the plain attention")
    return "pallas"


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = LoRALinear(cfg.d_model, cfg.n_heads * hd, cfg, "q_proj", device)
        self.k_proj = LoRALinear(cfg.d_model, cfg.n_kv_heads * hd, cfg, "k_proj", device)
        self.v_proj = LoRALinear(cfg.d_model, cfg.n_kv_heads * hd, cfg, "v_proj", device)
        self.o_proj = LoRALinear(cfg.n_heads * hd, cfg.d_model, cfg, "o_proj", device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                attn_start: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None,
                cache_idx: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = x.shape
        hd = cfg.head_dim
        q = self.q_proj(x).view(B, T, cfg.n_heads, hd)
        k = self.k_proj(x).view(B, T, cfg.n_kv_heads, hd)
        v = self.v_proj(x).view(B, T, cfg.n_kv_heads, hd)
        q = rotary_embedding(q, positions, cfg.rope_theta)
        k = rotary_embedding(k, positions, cfg.rope_theta)
        if cache is not None:
            if block_tables is not None:
                out = self._paged_decode_attention(q, k, v, cache, cache_idx, block_tables)
            else:
                out = self._decode_attention(q, k, v, cache, attn_start, cache_idx)
            return self.o_proj(out.reshape(B, T, cfg.n_heads * hd))
        impl = pick_attention(cfg.attention_impl, x.is_cuda, hd, q.dtype)
        if impl == "pallas":
            # GQA-native: the kernels map query heads to kv heads themselves
            from ..ops.flash_attention import flash_attention

            out = flash_attention(q, k, v, causal=True)
        else:
            k, v = repeat_kv(k, v, cfg.n_heads)
            out = xla_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(B, T, cfg.n_heads * hd))

    def _decode_attention(self, q, k, v, cache: dict,
                          attn_start: Optional[torch.Tensor] = None,
                          cache_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """KV-cache attention over a contiguous cache ``{"k", "v": [B, S, kv,
        hd], "idx": int32 scalar}``: prefill (T = prompt length) and
        single-token steps write k/v at the shared index ``idx`` (then
        advance it by T), and queries attend to everything written so far.
        The index stays on the device, so a decode loop never waits on it.

        ``attn_start`` [B] (optional): first VALID cache slot per row —
        batched serving LEFT-pads shorter prompts so all rows share the
        write index, and each row masks out its pad prefix.

        ``cache_idx`` [B] (optional, T must be 1): PER-ROW write index, the
        slot engine's mode. Row b's k/v land at ``cache_idx[b]`` and its
        query attends to positions ``<= cache_idx[b]``; the shared index is
        neither read nor advanced. Garbage beyond a row's index (a rewound
        prefill's padding, a freed slot's leftovers) is invisible to it."""
        ck, cv, cidx = cache["k"], cache["v"], cache["idx"]
        B, T = q.shape[:2]
        S = ck.shape[1]
        ar = torch.arange(S, device=q.device)
        if cache_idx is not None:
            if T != 1:
                raise ValueError(f"cache_idx decode requires T=1 steps, got T={T}")
            cache_idx = cache_idx.long()
            rows = torch.arange(B, device=q.device)
            ck[rows, cache_idx] = k[:, 0].to(ck.dtype)
            cv[rows, cache_idx] = v[:, 0].to(cv.dtype)
            # [B, 1, 1, S]: row b sees exactly its own written prefix
            valid = (ar[None, :] <= cache_idx[:, None])[:, None, None]
        else:
            q_pos = cidx + torch.arange(T, device=q.device)  # absolute position of each query
            ck.index_copy_(1, q_pos, k.to(ck.dtype))
            cv.index_copy_(1, q_pos, v.to(cv.dtype))
            cidx.add_(T)
            valid = ar[None, :] <= q_pos[:, None]  # [T, S] causal+written
            if attn_start is not None:
                # [B, 1, T, S]: rows additionally exclude their pad prefix
                valid = (valid[None] & (ar[None, None, :] >= attn_start[:, None, None]))[:, None]
        k_all, v_all = repeat_kv(ck, cv, self.cfg.n_heads)
        return xla_attention(q, k_all, v_all, mask=valid)

    def _paged_decode_attention(self, q, k, v, cache: dict,
                                cache_idx: Optional[torch.Tensor],
                                block_tables: Optional[torch.Tensor]) -> torch.Tensor:
        """Block-table KV attention over a physical page pool ``{"k", "v":
        [num_pages, page, kv, hd]}`` (the paged engine's mode,
        serving/paged_kv.py). Row ``b``'s logical position ``l`` lives at page
        ``block_tables[b, l // page]``, slot ``l % page``. The block tables
        [B, max_blocks] and the per-row write index ``cache_idx`` [B] are
        runtime data.

        Write: the new k/v token goes to (bt[b, idx // page], idx % page).
        The allocator never makes a shared prefix page the write target, so
        copy-on-write never needs a copy.

        Read: gather each row's pages back into logical order and mask
        positions > cache_idx[b]. Unallocated entries point at the trash
        page 0; their positions lie beyond the row's index, so the mask
        hides their garbage."""
        cfg = self.cfg
        ck, cv = cache["k"], cache["v"]
        ps = ck.shape[1]
        B, T = q.shape[:2]
        if T != 1:
            raise ValueError(f"paged decode requires T=1 steps, got T={T}")
        if cache_idx is None:
            raise ValueError("paged decode requires cache_idx and block_tables")
        if ck.shape[0] < 2:
            raise ValueError("kv_num_pages must be >= 2 (page 0 is the trash page)")
        cache_idx, block_tables = cache_idx.long(), block_tables.long()
        page = block_tables.gather(1, (cache_idx // ps)[:, None])[:, 0]  # [B]
        off = cache_idx % ps
        ck[page, off] = k[:, 0].to(ck.dtype)
        cv[page, off] = v[:, 0].to(cv.dtype)
        S_l = block_tables.shape[1] * ps  # logical context length
        k_rows = ck[block_tables].reshape(B, S_l, cfg.n_kv_heads, cfg.head_dim)
        v_rows = cv[block_tables].reshape(B, S_l, cfg.n_kv_heads, cfg.head_dim)
        k_all, v_all = repeat_kv(k_rows, v_rows, cfg.n_heads)
        # [B, 1, 1, S_l]: row b sees exactly its own written prefix
        valid = (torch.arange(S_l, device=q.device)[None, :] <= cache_idx[:, None])[:, None, None]
        return xla_attention(q, k_all, v_all, mask=valid)


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

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                attn_start: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None,
                cache_idx: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), positions, attn_start,
                          None if cache is None else cache["attn"], cache_idx, block_tables)
        return x + self.mlp(self.mlp_norm(x))


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, device=None, dtype=torch.float32):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, dim, device=device, dtype=dtype))

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
        self.embed = Embed(cfg.vocab_size, cfg.d_model, device, _weight_dtype(cfg))
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

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
                attn_start: Optional[torch.Tensor] = None,
                cache_idx: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                *, cache: Optional[dict] = None) -> torch.Tensor:
        """Logits [B, T, vocab] in f32. With ``cache`` (decode models only;
        ``init_cache``) this is a decode-mode call that updates the cache in
        place; ``block_tables`` selects the paged mode
        (``Attention._paged_decode_attention``), ``attn_start`` and
        ``cache_idx`` the contiguous ones (``Attention._decode_attention``)."""
        cfg = self.cfg
        if cache is not None and not cfg.decode:
            raise ValueError("a cache needs a decode model (cfg.decode=True; "
                             "generation.decode_model)")
        x = self.embed(tokens).to(cfg.dtype)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        for i, block in enumerate(self.layers):
            if cache is not None:
                x = block(x, positions, attn_start, cache[f"layer_{i}"], cache_idx, block_tables)
            else:
                x = self._run_block(block, x, positions)
        x = self.final_norm(x)
        return self.lm_head(x).to(torch.float32)


def init_cache(cfg: TransformerConfig, batch: int, device=None) -> dict:
    """A zeroed decode cache for ``cfg``, with the flax cache collection's
    paths and shapes: ``cache["layer_i"]["attn"]`` holds ``k`` and ``v``
    ([batch, max_seq_len, kv, hd], or the page pool [kv_num_pages,
    kv_page_size, kv, hd] when ``cfg.kv_page_size > 0``) in ``cfg.dtype``, and
    the shared write index ``idx`` (int32 scalar; unused by the slot and
    paged modes, kept so every cache has the same leaves)."""
    if cfg.kv_page_size > 0:
        shape = (cfg.kv_num_pages, cfg.kv_page_size, cfg.n_kv_heads, cfg.head_dim)
    else:
        shape = (batch, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {f"layer_{i}": {"attn": {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }} for i in range(cfg.n_layers)}
