"""Ring attention: sequence parallelism over the ``sp`` axis of the mesh.
Counterpart of ``fedml_tpu/parallel/ring_attention.py``.

The sequence is sharded contiguously over ``sp``: each rank holds one block
of queries, keys and values, the key/value blocks travel around the ring
(:func:`multihost.ppermute`, the ring shift) and an online-softmax
accumulator keeps the result exact (Liu et al. 2023). Across blocks,
causality is a mask: a query chunk attends an earlier chunk fully, its own
chunk causally, a later one not at all (a chunk that can never be attended
is skipped, which leaves the accumulator exactly as JAX's masked update
does).

Layouts, as in JAX: ``"zigzag"`` (the default) reshuffles each rank's
contiguous block into global chunks ``idx`` and ``2n-1-idx`` of ``2n``
half-blocks (two ring shifts, ``_zigzag_split``), runs the ring on them,
and shuffles the result back (``_zigzag_merge``), so every rank does the
same causal work and the front-queries x back-keys quarter is always
skipped; ``"contiguous"`` is the classic ring, and the fallback when the
local block is odd. Outside attention the sequence stays contiguous.

``torch.distributed`` point-to-point is not differentiable. JAX takes its
gradient from shard_map, where a ring shift's transpose is the reverse
shift. Here :class:`_RingAttention` is one ``autograd.Function``: its
backward recomputes each block's probabilities from the saved row
logsumexp, accumulates dQ at home and sends dK/dV around the ring with
their key/value block, so after ``n`` shifts each rank holds the gradient
of its own block (and the zigzag reshuffles' transposes are their
inverses).

The active mesh (:class:`active_mesh`, :func:`get_active_mesh`) is how
model code finds the mesh without it being threaded through the modules,
as in JAX; the port's mesh is a ``parallel.mesh.RankMesh``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import multihost as mh

NEG_INF = -1e30

_ACTIVE_MESH = None


class active_mesh:
    """Context manager making ``mesh`` the active mesh (None clears it)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev


def get_active_mesh():
    return _ACTIVE_MESH


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype: f32 for 16- and 32-bit inputs (JAX's
    ``preferred_element_type``), float64 for float64 ones."""
    return torch.promote_types(dtype, torch.float32)


def _dot_qk(qc, kc, scale: float):
    """[B, Tq, H, D] x [B, Tk, H, D] -> [B, H, Tq, Tk] in the wide dtype; the
    operands are widened exactly, so a 16-bit input's products accumulate in
    f32."""
    w = _wide(qc.dtype)
    return torch.einsum("bqhd,bkhd->bhqk", qc.to(w), kc.to(w)) * scale


def _online_update(m, l, acc, logits, allow, v_cur):
    """One online-softmax step (max, correction, accumulate); masked entries
    contribute exactly zero."""
    logits = torch.where(allow, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None]) * allow.to(logits.dtype)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p.to(v_cur.dtype).to(logits.dtype), v_cur.to(logits.dtype))
    return m_new, l_new, acc_new


def _allow(a: int, b: int, tq: int, tk: int, device) -> Optional[torch.Tensor]:
    """The mask of query chunk ``a`` against key chunk ``b`` (global chunk
    ids): None when no entry can be attended."""
    if a > b:
        return torch.ones(tq, tk, dtype=torch.bool, device=device)
    if a == b:
        return torch.ones(tq, tk, dtype=torch.bool, device=device).tril()
    return None


def _chunk_ids(layout: str, rank: int, n: int) -> List[int]:
    return [rank, 2 * n - 1 - rank] if layout == "zigzag" else [rank]


def _zigzag_split(x, group, n: int):
    """Contiguous block [B, Tl, ...] -> (front, back) halves in zigzag
    ownership: rank d ends up holding global chunks d and 2n-1-d (two ring
    shifts, each a bijection)."""
    idx = torch.distributed.get_rank(group)
    C = x.shape[1] // 2
    h0, h1 = x[:, :C], x[:, C:]  # global chunk ids 2*idx, 2*idx+1

    def dest(c: int) -> int:
        return c if c < n else 2 * n - 1 - c

    r0 = mh.ppermute(h0, [(s, dest(2 * s)) for s in range(n)], group, op="ring_zigzag")
    r1 = mh.ppermute(h1, [(s, dest(2 * s + 1)) for s in range(n)], group, op="ring_zigzag")
    # the front chunk (id d) is the even one iff d is even
    return (r0, r1) if idx % 2 == 0 else (r1, r0)


def _zigzag_merge(front, back, group, n: int):
    """Inverse of :func:`_zigzag_split`: chunks d and 2n-1-d back to their
    contiguous owners, concatenated into [B, Tl, ...]."""
    idx = torch.distributed.get_rank(group)
    even = idx % 2 == 0
    send_even, send_odd = (front, back) if even else (back, front)

    def even_id(d: int) -> int:
        return d if d % 2 == 0 else 2 * n - 1 - d

    def odd_id(d: int) -> int:
        return d if d % 2 == 1 else 2 * n - 1 - d

    r0 = mh.ppermute(send_even, [(d, even_id(d) // 2) for d in range(n)], group, op="ring_zigzag")
    r1 = mh.ppermute(send_odd, [(d, odd_id(d) // 2) for d in range(n)], group, op="ring_zigzag")
    return torch.cat([r0, r1], dim=1)


def _rotate(tensors, group, n: int):
    """Every rank's tensors to the next rank of the ring, in one shift."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    got = mh.ppermute(flat, [(d, (d + 1) % n) for d in range(n)], group, op="ring_shift")
    return [part.view_as(t) for part, t in zip(got.split([t.numel() for t in tensors]), tensors)]


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, layout):
        n = torch.distributed.get_world_size(group)
        idx = torch.distributed.get_rank(group)
        scale = q.shape[-1] ** -0.5
        if layout == "zigzag":
            qs = list(_zigzag_split(q, group, n))
            ks = list(_zigzag_split(k, group, n))
            vs = list(_zigzag_split(v, group, n))
        else:
            qs, ks, vs = [q], [k], [v]
        B, H, D = q.shape[0], q.shape[2], q.shape[3]
        q_ids = _chunk_ids(layout, idx, n)
        w = _wide(q.dtype)
        state = [(torch.full((B, H, c.shape[1]), NEG_INF, device=q.device, dtype=w),
                  torch.zeros(B, H, c.shape[1], device=q.device, dtype=w),
                  torch.zeros(B, H, c.shape[1], D, device=q.device, dtype=w)) for c in qs]
        k_cur, v_cur = ks, vs
        for step in range(n):
            j = (idx - step) % n
            for a, (qa, qid) in enumerate(zip(qs, q_ids)):
                for kb, vb, kid in zip(k_cur, v_cur, _chunk_ids(layout, j, n)):
                    allow = _allow(qid, kid, qa.shape[1], kb.shape[1], q.device)
                    if allow is None:
                        continue
                    m, l, acc = state[a]
                    state[a] = _online_update(m, l, acc, _dot_qk(qa, kb, scale),
                                              allow[None, None], vb)
            if step < n - 1:
                rot = _rotate(k_cur + v_cur, group, n)
                k_cur, v_cur = rot[:len(ks)], rot[len(ks):]
        outs, lses = [], []
        for m, l, acc in state:
            outs.append((acc / torch.clamp(l, min=1e-20)[..., None]).permute(0, 2, 1, 3))
            lses.append(m + torch.log(l))
        outs_t = [o.to(q.dtype) for o in outs]
        out = _zigzag_merge(*outs_t, group, n) if layout == "zigzag" else outs_t[0]
        ctx.save_for_backward(*qs, *ks, *vs, *outs_t, *lses)
        ctx.group, ctx.layout, ctx.nc = group, layout, len(qs)
        return out

    @staticmethod
    def backward(ctx, dout):
        group, layout, nc = ctx.group, ctx.layout, ctx.nc
        saved = ctx.saved_tensors
        qs, ks, vs = list(saved[:nc]), list(saved[nc:2 * nc]), list(saved[2 * nc:3 * nc])
        outs, lses = saved[3 * nc:4 * nc], saved[4 * nc:5 * nc]
        n = torch.distributed.get_world_size(group)
        idx = torch.distributed.get_rank(group)
        scale = qs[0].shape[-1] ** -0.5
        w = _wide(qs[0].dtype)
        douts = list(_zigzag_split(dout, group, n)) if layout == "zigzag" else [dout]
        # D_a = rowsum(dO * O) [B, H, Tc]
        deltas = [(do.to(w) * o.to(w)).sum(-1).permute(0, 2, 1) for do, o in zip(douts, outs)]
        dqs = [torch.zeros(q.shape, dtype=w, device=q.device) for q in qs]
        k_cur, v_cur = ks, vs
        dk_cur = [torch.zeros(k.shape, dtype=w, device=k.device) for k in ks]
        dv_cur = [torch.zeros(v.shape, dtype=w, device=v.device) for v in vs]
        q_ids = _chunk_ids(layout, idx, n)
        for step in range(n):
            j = (idx - step) % n
            for a, (qa, qid) in enumerate(zip(qs, q_ids)):
                for b, kid in enumerate(_chunk_ids(layout, j, n)):
                    kb, vb = k_cur[b], v_cur[b]
                    allow = _allow(qid, kid, qa.shape[1], kb.shape[1], qa.device)
                    if allow is None:
                        continue
                    s = _dot_qk(qa, kb, scale)
                    p = torch.exp(torch.where(allow, s, NEG_INF) - lses[a][..., None]) * allow.to(w)
                    do = douts[a].to(w)
                    dv_cur[b] = dv_cur[b] + torch.einsum("bhqk,bqhd->bkhd", p, do)
                    dp = torch.einsum("bqhd,bkhd->bhqk", do, vb.to(w))
                    ds = p * (dp - deltas[a][..., None])
                    dqs[a] = dqs[a] + torch.einsum("bhqk,bkhd->bqhd", ds, kb.to(w)) * scale
                    dk_cur[b] = dk_cur[b] + torch.einsum("bhqk,bqhd->bkhd", ds,
                                                         qa.to(w)) * scale
            # the dK/dV of a block travel with it; after n shifts each rank
            # holds its own block's
            rot = _rotate(k_cur + v_cur + dk_cur + dv_cur, group, n)
            k_cur, v_cur = rot[:nc], rot[nc:2 * nc]
            dk_cur, dv_cur = rot[2 * nc:3 * nc], rot[3 * nc:]
        cast = lambda ts, like: [t.to(like.dtype) for t in ts]  # noqa: E731
        if layout == "zigzag":
            dq = _zigzag_merge(*cast(dqs, qs[0]), group, n)
            dk = _zigzag_merge(*cast(dk_cur, ks[0]), group, n)
            dv = _zigzag_merge(*cast(dv_cur, vs[0]), group, n)
        else:
            dq, dk, dv = dqs[0].to(qs[0].dtype), dk_cur[0].to(ks[0].dtype), dv_cur[0].to(vs[0].dtype)
        return dq, dk, dv, None, None


def ring_attention(q, k, v, mesh, axis_name: str = "sp", layout: str = "zigzag"):
    """Causal attention of this rank's contiguous block of the sequence
    (q/k/v ``[B, T_local, H, D]``, the same head count: callers repeat the
    KV heads) against every earlier position, over the ring of ``mesh``'s
    ``axis_name`` group. Returns this block's output. ``layout="zigzag"``
    balances the causal work; it falls back to ``"contiguous"`` when the
    local block is odd."""
    if layout not in ("zigzag", "contiguous"):
        raise ValueError(f"unknown ring layout {layout!r}")
    if layout == "zigzag" and q.shape[1] % 2:
        layout = "contiguous"  # zigzag needs an even local block
    group = mesh.group(axis_name)
    if group is None:
        from ..models.transformer import xla_attention

        return xla_attention(q, k, v, causal=True)
    return _RingAttention.apply(q, k, v, group, layout)


def ring_attention_inner(q, k, v):
    """Model-facing entry (``attention_impl="ring"``): the active mesh's
    ``sp`` ring; exact plain attention when no mesh with an ``sp`` axis
    above 1 is active (one rank, tests), as in JAX."""
    mesh = get_active_mesh()
    if mesh is not None and mesh.axis_size("sp") > 1:
        return ring_attention(q, k, v, mesh)
    from ..models.transformer import xla_attention

    return xla_attention(q, k, v, causal=True)
