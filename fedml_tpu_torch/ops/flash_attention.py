"""Flash attention for CUDA: forward and backward kernels, GQA-native.

Counterpart of ``fedml_tpu/ops/flash_attention.py``. The three Pallas TPU
kernels become hand-written CUDA C++ kernels for Hopper (``csrc/``):

* ``flash_fwd``: one block per (query head, q tile) streams the K/V tiles of
  its KV head; online softmax in f32; writes O and the per-row logsumexp.
* ``flash_bwd_dq``: dQ per (query head, q tile) streams the K/V tiles of its
  KV head, rebuilding ``p = exp(s - lse)`` from the saved logsumexp.
* ``flash_bwd_dkv``: dK/dV per (KV head, k tile); the query heads of the
  group are a loop inside the block (the TPU's sequential grid axis), summed
  in f32 registers and written once.

In bf16 all three run on the tensor cores (``wgmma`` fed by TMA,
warp-specialised, ``csrc/flash_sm90.cuh``); in f32 they run f32 FMAs from
shared memory (tensor cores would need TF32). Each kernel's compiled tiles
are listed in ``TILES``.

The [T, T] score matrix never reaches device memory. K/V are consumed at
their own head count: query head ``h`` reads KV head ``h // (Hq // Hkv)``.
Causal k tiles past the diagonal (forward, dQ) and q tiles above it (dK/dV)
are skipped. The kernels mask the ragged tail themselves, so every ``T``
runs through them on the card.

Each kernel has a plain PyTorch version beside it (``flash_*_reference``) of
the same math on the same ``[B*H, T, D]`` layout. A wrapper takes the plain
version only for CPU tensors; for CUDA tensors it launches the kernel or
raises. ``lse`` is ``[B*Hq, T]`` f32 (the TPU's lane-padded stats layout has
no counterpart here).
"""

from __future__ import annotations

import math
import os
import warnings

import torch

NEG_INF = -1e30

# The compiled (block_q, block_k) tile pairs of each kernel, by dtype: the one
# record of the instances in csrc/ (flash_fwd.cu fwd_dispatch, flash_bwd_dq.cu
# dq_dispatch, flash_bwd_dkv.cu dkv_dispatch, flash_common.cuh dispatch_tiles
# for the SIMT kernels). The first pair is the kernel's default. block_q/block_k
# name the rows of a q and a k tile; the plain versions are untiled and ignore
# them.
_SIMT_TILES = ((64, 64), (64, 32), (32, 64), (32, 32))
TILES = {
    "flash_fwd": {torch.bfloat16: ((128, 128),), torch.float32: _SIMT_TILES},
    "flash_bwd_dq": {torch.bfloat16: ((128, 128),), torch.float32: _SIMT_TILES},
    "flash_bwd_dkv": {torch.bfloat16: ((64, 128),), torch.float32: _SIMT_TILES},
}
HEAD_DIMS = (64, 128)
MAX_HEAD_ROWS = 65535  # B*H is the f32 SIMT kernels' grid.y, which CUDA caps here
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Tile overrides for callers that pass none (the JAX module's
# FEDML_FLASH_BLOCK_Q/K), both set to one compiled pair. A choice that names
# no compiled pair of a kernel is ignored for that kernel with a warning
# rather than crashing a training run over a bad env var.
_BLOCK_Q_ENV = "FEDML_FLASH_BLOCK_Q"
_BLOCK_K_ENV = "FEDML_FLASH_BLOCK_K"

# Launches of each kernel; a wrapper adds one where it launches its kernel
# and nowhere else. The plain versions are not counted.
launch_counts = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _env_block(name: str) -> int | None:
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return -1  # names no tile: warns below


def resolve_blocks(kernel: str, dtype: torch.dtype, block_q: int | None = None,
                   block_k: int | None = None) -> tuple[int, int]:
    """The (block_q, block_k) tiles a launch of ``kernel`` on ``dtype`` uses.
    An explicit pair must be one of the kernel's compiled pairs, else
    ValueError. With none, the pair FEDML_FLASH_BLOCK_Q/K name is taken if it
    is compiled; otherwise the override warns and the default runs, so the
    override only has an effect on kernels with more than one compiled pair
    (the f32 SIMT kernels, not the bf16 wgmma kernels)."""
    pairs = TILES[kernel][dtype]
    if block_q is None and block_k is None:
        env = (_env_block(_BLOCK_Q_ENV), _env_block(_BLOCK_K_ENV))
        if env in pairs:
            return env
        if env != (None, None):
            warnings.warn(f"{_BLOCK_Q_ENV}/{_BLOCK_K_ENV}={env} names no {kernel} tile for "
                          f"{dtype} (compiled: {pairs}); using default {pairs[0]}")
        return pairs[0]
    if (block_q, block_k) not in pairs:
        raise ValueError(f"block_q={block_q}, block_k={block_k} names no compiled {kernel} "
                         f"tile for {dtype}: {pairs}")
    return block_q, block_k


# --- plain versions on [B*H, T, D] -------------------------------------------

def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in the plain versions' working type: f32 for bf16 and f32 inputs, as
    the kernels accumulate, and f64 for f64 inputs (a reference free of f32
    rounding, for tests of the f32 kernels)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _kv_index(bhq: int, hq: int, hkv: int, device) -> torch.Tensor:
    """Row of k/v [B*Hkv] read by each row of q [B*Hq]."""
    i = torch.arange(bhq, device=device)
    return (i // hq) * hkv + (i % hq) // (hq // hkv)


def _causal_mask(t: int, device) -> torch.Tensor:
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()


def _scores(q, k, *, hq: int, hkv: int, causal: bool):
    """s = (q.k^T) * D^-1/2 in f32 (k gathered per query head), masked."""
    kk = k[_kv_index(q.shape[0], hq, hkv, q.device)]
    s = torch.matmul(_acc(q), _acc(kk).transpose(1, 2)) * q.shape[-1] ** -0.5
    mask = _causal_mask(q.shape[1], q.device) if causal else None
    return s, mask


def flash_fwd_reference(q, k, v, *, causal: bool, hq: int, hkv: int):
    """Plain version of the forward kernel: -> (o like q, lse [BHq, T] f32)."""
    s, mask = _scores(q, k, hq=hq, hkv=hkv, causal=causal)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    vv = v[_kv_index(q.shape[0], hq, hkv, q.device)]
    # p in the input dtype for P.V with f32 accumulation, as the kernel does
    o = torch.matmul(_acc(p.to(v.dtype)), _acc(vv)) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def _probs_and_ds(q, k, v, do, lse, delta, *, causal: bool, hq: int, hkv: int):
    s, mask = _scores(q, k, hq=hq, hkv=hkv, causal=causal)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    vv = v[_kv_index(q.shape[0], hq, hkv, q.device)]
    dp = torch.matmul(_acc(do), _acc(vv).transpose(1, 2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, causal: bool, hq: int, hkv: int):
    """Plain version of the dQ kernel: -> dq like q."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal=causal, hq=hq, hkv=hkv)
    kk = k[_kv_index(q.shape[0], hq, hkv, q.device)]
    dq = torch.matmul(_acc(ds.to(k.dtype)), _acc(kk)) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def flash_bwd_dq_rounding_floor(q, k, v, do, lse, *, causal: bool, hq: int, hkv: int):
    """Per row of dQ ([BHq, T] f32): how far two right f32 evaluations of
    that row may lie apart by summation order alone. Each dp = dO.v is a
    D-term f32 dot product, rounded by about 2^-24 sqrt(D) sum_d |dO_d v_d|
    (the usual estimate for a sum in any order); carried through p and K to
    the row it is || D^-1/2 sum_j p_j (2^-24 sqrt(D) sum_d |dO_d| |v_jd|) |k_j| ||.
    It is the whole size of a row whose ds cancels: causal row 0, whose p is
    1 and whose delta is its one dp, is 0 in exact arithmetic and rounding
    noise of this size in f32."""
    d = q.shape[-1]
    idx = _kv_index(q.shape[0], hq, hkv, q.device)
    s, mask = _scores(q, k, hq=hq, hkv=hkv, causal=causal)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    abs_dp = torch.matmul(_acc(do).abs(), _acc(v[idx]).abs().transpose(1, 2))
    bound = torch.matmul(p * abs_dp, _acc(k[idx]).abs()) * d ** -0.5
    return 2.0 ** -24 * math.sqrt(d) * bound.norm(dim=-1)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, causal: bool, hq: int, hkv: int):
    """Plain version of the dK/dV kernel: -> (dk like k, dv like v), summed in
    f32 over the query heads of each group."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal=causal, hq=hq, hkv=hkv)
    dv = torch.matmul(_acc(p.to(do.dtype)).transpose(1, 2), _acc(do))
    dk = torch.matmul(_acc(ds.to(q.dtype)).transpose(1, 2), _acc(q)) * q.shape[-1] ** -0.5
    # query rows b*Hq + hk*G + g all belong to kv row b*Hkv + hk
    shape = (k.shape[0], hq // hkv) + tuple(k.shape[1:])
    return dk.view(shape).sum(1).to(k.dtype), dv.view(shape).sum(1).to(v.dtype)


# --- kernel wrappers -----------------------------------------------------------

def kernels_take(batch: int, hq: int, head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernels have an instance for attention of this shape
    and dtype: head dim in ``HEAD_DIMS``, dtype in ``KERNEL_DTYPES``, B*Hq
    at most ``MAX_HEAD_ROWS``."""
    return head_dim in HEAD_DIMS and dtype in KERNEL_DTYPES and batch * hq <= MAX_HEAD_ROWS


def check_kernel_inputs(q, k, v, *, hq: int, hkv: int) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash kernels take [B*H, T, D] tensors")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernels take one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if hq <= 0 or hkv <= 0 or hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    bhq, t, d = q.shape
    if not kernels_take(bhq // hq, hq, d, q.dtype):
        raise ValueError(f"flash kernels take head dims {HEAD_DIMS}, a dtype of {KERNEL_DTYPES} "
                         f"and B*Hq <= {MAX_HEAD_ROWS} (the grid limit), got head dim {d}, "
                         f"{q.dtype}, B*Hq={bhq}")
    if bhq % hq or k.shape != (bhq // hq * hkv, t, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} for hq={hq}, hkv={hkv}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def _check_stats(q, *stats) -> None:
    for x in stats:
        if x.dtype != torch.float32 or x.shape != q.shape[:2] or not x.is_contiguous():
            raise ValueError(f"row stats must be contiguous f32 {tuple(q.shape[:2])}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"row stats on {x.device}, q on {q.device}")


def _on_cuda(q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return True


def _kernels():
    from ._build import kernels

    return kernels()


def flash_fwd(q, k, v, *, causal: bool, hq: int, hkv: int,
              block_q: int | None = None, block_k: int | None = None):
    """-> (o [BHq, T, D] like q, lse [BHq, T] f32)."""
    if not _on_cuda(q):
        return flash_fwd_reference(q, k, v, causal=causal, hq=hq, hkv=hkv)
    check_kernel_inputs(q, k, v, hq=hq, hkv=hkv)
    bq, bk = resolve_blocks("flash_fwd", q.dtype, block_q, block_k)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):  # launch on q's card, not the current one
        _kernels().fwd(q, k, v, o, lse, causal, hq, hkv, bq, bk)
    launch_counts["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, hq: int, hkv: int,
                 block_q: int | None = None, block_k: int | None = None):
    """-> dq [BHq, T, D] like q."""
    if not _on_cuda(q):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=causal, hq=hq, hkv=hkv)
    check_kernel_inputs(q, k, v, hq=hq, hkv=hkv)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("dO must be a contiguous tensor shaped and typed like q")
    _check_stats(q, lse, delta)
    bq, bk = resolve_blocks("flash_bwd_dq", q.dtype, block_q, block_k)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernels().bwd_dq(q, k, v, do, lse, delta, dq, causal, hq, hkv, bq, bk)
    launch_counts["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, hq: int, hkv: int,
                  block_q: int | None = None, block_k: int | None = None):
    """-> (dk like k, dv like v)."""
    if not _on_cuda(q):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=causal, hq=hq, hkv=hkv)
    check_kernel_inputs(q, k, v, hq=hq, hkv=hkv)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("dO must be a contiguous tensor shaped and typed like q")
    _check_stats(q, lse, delta)
    bq, bk = resolve_blocks("flash_bwd_dkv", q.dtype, block_q, block_k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _kernels().bwd_dkv(q, k, v, do, lse, delta, dk, dv, causal, hq, hkv, bq, bk)
    launch_counts["flash_bwd_dkv"] += 1
    return dk, dv


# --- autograd wiring (on the [BH, T, D] layout) --------------------------------

class _FlashAttention(torch.autograd.Function):
    """The JAX module's ``_flash_r`` + ``defvjp``: the forward saves
    (q, k, v, o, lse); the backward feeds the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, hq, hkv, block_q, block_k):
        o, lse = flash_fwd(q, k, v, causal=causal, hq=hq, hkv=hkv,
                           block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = dict(causal=causal, hq=hq, hkv=hkv, block_q=block_q, block_k=block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # delta = rowsum(dO * O): one elementwise reduce outside the kernels
        delta = (_acc(do) * _acc(o)).sum(-1)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **ctx.cfg)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """[B, T, Hq, D], [B, T, Hkv, D] x2 -> [B, T, Hq, D]. GQA-native: Hkv may
    divide Hq; K/V are consumed at their own head count (no repeat). On CUDA
    tensors each kernel runs with (block_q, block_k) tiles, which must name
    one of its compiled pairs (``TILES``); None takes FEDML_FLASH_BLOCK_Q/K
    or each kernel's own default. On CPU tensors the plain versions run and
    the blocks are unused."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    # at B=1 the reshape is a strided view, which the kernels do not take
    qr = q.transpose(1, 2).reshape(B * Hq, T, D).contiguous()
    kr = k.transpose(1, 2).reshape(B * Hkv, T, D).contiguous()
    vr = v.transpose(1, 2).reshape(B * Hkv, T, D).contiguous()
    out = _FlashAttention.apply(qr, kr, vr, causal, Hq, Hkv, block_q, block_k)
    return out.reshape(B, Hq, T, D).transpose(1, 2)
