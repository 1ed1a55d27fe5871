"""Flash attention for CUDA: forward and backward kernels, GQA-native.

Counterpart of ``fedml_tpu/ops/flash_attention.py``. The three Pallas TPU
kernels become hand-written CUDA C++ kernels for Hopper (``csrc/``):

* ``flash_fwd``: one block per (query head, q tile) streams the K/V tiles of
  its KV head; online softmax in f32; writes O and the per-row logsumexp.
* ``flash_bwd_dq``: dQ per (query head, q tile), rebuilding
  ``p = exp(s - lse)`` from the saved logsumexp.
* ``flash_bwd_dkv``: dK/dV per (KV head, k tile); the query heads of the
  group are a loop inside the block (the TPU's sequential grid axis), summed
  in f32 registers and written once.

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

import os
import warnings

import torch

NEG_INF = -1e30

# CUDA tile sizes compiled into the kernels (csrc/flash_common.cuh
# dispatch_tiles). block_q/block_k name the rows of a q and a k tile; the
# plain versions are untiled and ignore them.
TILE_SIZES = (32, 64)
DEFAULT_BLOCK = 64
HEAD_DIMS = (64, 128)
MAX_HEAD_ROWS = 65535  # B*H is the kernels' grid.y, which CUDA caps here
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Block-size overrides for callers that pass none (the JAX module's
# FEDML_FLASH_BLOCK_Q/K). A value that is not one of TILE_SIZES is ignored
# with a warning rather than crashing a training run over a bad env var.
_BLOCK_Q_ENV = "FEDML_FLASH_BLOCK_Q"
_BLOCK_K_ENV = "FEDML_FLASH_BLOCK_K"

# Launches of each kernel; a wrapper adds one where it launches its kernel
# and nowhere else. The plain versions are not counted.
launch_counts = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _env_block(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        val = -1
    if val not in TILE_SIZES:
        warnings.warn(f"{name}={raw!r} is not one of the CUDA tile sizes "
                      f"{TILE_SIZES}; using default {default}")
        return default
    return val


def resolve_blocks(block_q: int | None = None, block_k: int | None = None) -> tuple[int, int]:
    """The (block_q, block_k) CUDA tiles a launch uses: explicit values must
    be one of TILE_SIZES; None takes the env override, else the default."""
    if block_q is None:
        block_q = _env_block(_BLOCK_Q_ENV, DEFAULT_BLOCK)
    if block_k is None:
        block_k = _env_block(_BLOCK_K_ENV, DEFAULT_BLOCK)
    for name, val in (("block_q", block_q), ("block_k", block_k)):
        if val not in TILE_SIZES:
            raise ValueError(f"{name}={val} is not a CUDA tile size {TILE_SIZES}")
    return block_q, block_k


# --- plain versions on [B*H, T, D] -------------------------------------------

def _kv_index(bhq: int, hq: int, hkv: int, device) -> torch.Tensor:
    """Row of k/v [B*Hkv] read by each row of q [B*Hq]."""
    i = torch.arange(bhq, device=device)
    return (i // hq) * hkv + (i % hq) // (hq // hkv)


def _causal_mask(t: int, device) -> torch.Tensor:
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()


def _scores(q, k, *, hq: int, hkv: int, causal: bool):
    """s = (q.k^T) * D^-1/2 in f32 (k gathered per query head), masked."""
    kk = k[_kv_index(q.shape[0], hq, hkv, q.device)]
    s = torch.matmul(q.float(), kk.float().transpose(1, 2)) * q.shape[-1] ** -0.5
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
    o = torch.matmul(p.to(v.dtype).float(), vv.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def _probs_and_ds(q, k, v, do, lse, delta, *, causal: bool, hq: int, hkv: int):
    s, mask = _scores(q, k, hq=hq, hkv=hkv, causal=causal)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    vv = v[_kv_index(q.shape[0], hq, hkv, q.device)]
    dp = torch.matmul(do.float(), vv.float().transpose(1, 2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, causal: bool, hq: int, hkv: int):
    """Plain version of the dQ kernel: -> dq like q."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal=causal, hq=hq, hkv=hkv)
    kk = k[_kv_index(q.shape[0], hq, hkv, q.device)]
    dq = torch.matmul(ds.to(k.dtype).float(), kk.float()) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, causal: bool, hq: int, hkv: int):
    """Plain version of the dK/dV kernel: -> (dk like k, dv like v), summed in
    f32 over the query heads of each group."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal=causal, hq=hq, hkv=hkv)
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(1, 2), q.float()) * q.shape[-1] ** -0.5
    # query rows b*Hq + hk*G + g all belong to kv row b*Hkv + hk
    shape = (k.shape[0], hq // hkv) + tuple(k.shape[1:])
    return dk.view(shape).sum(1).to(k.dtype), dv.view(shape).sum(1).to(v.dtype)


# --- kernel wrappers -----------------------------------------------------------

def check_kernel_inputs(q, k, v, *, hq: int, hkv: int) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash kernels take [B*H, T, D] tensors")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernels take one dtype of {KERNEL_DTYPES}, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hq <= 0 or hkv <= 0 or hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    bhq, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernels take head dims {HEAD_DIMS}, got {d}")
    if bhq > MAX_HEAD_ROWS:
        raise ValueError(f"B*Hq={bhq} exceeds the kernels' grid limit {MAX_HEAD_ROWS}")
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
    bq, bk = resolve_blocks(block_q, block_k)
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
    bq, bk = resolve_blocks(block_q, block_k)
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
    bq, bk = resolve_blocks(block_q, block_k)
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
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **ctx.cfg)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """[B, T, Hq, D], [B, T, Hkv, D] x2 -> [B, T, Hq, D]. GQA-native: Hkv may
    divide Hq; K/V are consumed at their own head count (no repeat). On CUDA
    tensors the kernels run with (block_q, block_k) tiles, None taking
    FEDML_FLASH_BLOCK_Q/K or the default; on CPU tensors the plain
    versions run and the blocks are unused."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    qr = q.transpose(1, 2).reshape(B * Hq, T, D)
    kr = k.transpose(1, 2).reshape(B * Hkv, T, D)
    vr = v.transpose(1, 2).reshape(B * Hkv, T, D)
    out = _FlashAttention.apply(qr, kr, vr, causal, Hq, Hkv, block_q, block_k)
    return out.reshape(B, Hq, T, D).transpose(1, 2)
