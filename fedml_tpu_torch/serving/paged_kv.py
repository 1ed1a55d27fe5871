"""Paged KV cache: a block-pool allocator + the paged decode functions.

Counterpart of ``fedml_tpu/serving/paged_kv.py``. The slot engine gives
every slot a full [max_seq_len] KV row, so device memory is sized for the
worst-case sequence times ``num_slots`` and common system prompts are
stored once PER REQUEST. This module replaces the row pool with a
vLLM-style page pool:

- the physical cache is [kv_num_pages, kv_page_size, kv, hd] per layer —
  ONE pool shared by every in-flight request; page 0 is a reserved trash
  page (never allocated) so unowned block-table entries have a harmless
  scatter/gather target;
- each request owns a BLOCK TABLE (host list of page ids, padded with 0)
  mapping logical position ``l`` to page ``table[l // page_size]``; the
  tables ride the engine's chunked decode step as runtime data;
- pages are REFCOUNTED and prompt prefixes are hash-consed on token-chunk
  (page) boundaries: requests sharing a system prompt map the same
  physical pages. Only FULL prompt chunks are registered, so the first
  writable position (the prompt tail / decode stream) always lands in a
  page with refcount 1 and copy-on-write never needs a copy;
- a free-list allocator with an admission watermark: when free pages run
  low, LRU prefix retentions are evicted first, and admission defers (the
  request stays queued) rather than corrupt in-flight decode.

Prefill reuses the contiguous path (``generation._prefill``) at B=1 and
scatters the finished row into pages (``_paged_admit``). A prefix HIT skips
recomputing the shared prompt: gather the shared pages back into a
contiguous row (``_paged_gather``), rewind the write index to the shared
length, and run one multi-token decode-mode pass over just the suffix
(``_suffix_prefill``), in 16-token suffix buckets like fresh prefills.
The device functions update the pool in place; the allocator is host-side
bookkeeping (a copy of the JAX package's).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import telemetry as tel
from ..models.transformer import TransformerConfig, TransformerLM, init_cache
from ..train.llm.generation import _rewind_cache, _sample

#: reserved trash page: scatter target for every unowned block-table entry
TRASH_PAGE = 0


def paged_config(cfg: TransformerConfig, *, page_size: int,
                 num_pages: int) -> TransformerConfig:
    """The paged twin of a config: the page pool's geometry."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if cfg.max_seq_len % page_size != 0:
        raise ValueError(
            f"max_seq_len {cfg.max_seq_len} must be a multiple of "
            f"page_size {page_size} (block tables cover whole pages)")
    if num_pages < 2:
        raise ValueError(
            f"num_pages must be >= 2 (page {TRASH_PAGE} is reserved trash), "
            f"got {num_pages}")
    return dataclasses.replace(
        cfg, kv_page_size=int(page_size), kv_num_pages=int(num_pages))


def row_config(cfg: TransformerConfig) -> TransformerConfig:
    """The contiguous (per-row cache) twin of a paged config — prefill and
    suffix-prefill run here, then scatter into the pool."""
    return dataclasses.replace(cfg, kv_page_size=0, kv_num_pages=0)


def _num_blocks(cfg: TransformerConfig) -> int:
    return cfg.max_seq_len // cfg.kv_page_size


def paged_pool_init(cfg: TransformerConfig, device=None) -> dict:
    """The empty page-pool cache of a paged config: per layer ``k``, ``v``
    [num_pages, page_size, kv, hd] and the unused scalar ``idx``."""
    return init_cache(cfg, 0, device)


def _leaves(cache: dict):
    """(layer key, "k" | "v") of every K/V leaf of a cache."""
    return [(layer, kv) for layer in cache for kv in ("k", "v")]


def _paged_admit(cfg: TransformerConfig, pool: dict, row_cache: dict, write_ids: np.ndarray,
                 first_logits: torch.Tensor, generator: torch.Generator,
                 temperature: float) -> int:
    """Scatter one finished contiguous row cache into the pool at the page
    ids ``write_ids`` (one entry per logical block; blocks the request does
    NOT own — shared prefix pages, the unallocated tail — carry TRASH_PAGE
    and are not written) and sample the request's first token (one host
    sync per admission)."""
    ps = cfg.kv_page_size
    blocks = np.nonzero(write_ids != TRASH_PAGE)[0]
    if len(blocks):
        dev = first_logits.device
        src = torch.as_tensor(blocks, device=dev)
        dst = torch.as_tensor(write_ids[blocks].astype(np.int64), device=dev)
        for layer, kv in _leaves(pool):
            leaf = pool[layer]["attn"][kv]
            pages = row_cache[layer]["attn"][kv][0].view((-1, ps) + leaf.shape[2:])
            leaf[dst] = pages[src]
    return int(_sample(first_logits[None], generator, temperature)[0])


def _paged_gather(pool: dict, block_table: np.ndarray, prefix_len: int) -> dict:
    """Gather one request's pages back into a contiguous [1, S, kv, hd] row
    (the suffix-prefill staging buffer), write index rewound to the shared
    prefix length. Blocks beyond the prefix point at the trash page; their
    garbage is overwritten by the suffix pass before any query can attend
    to it (the ``_rewind_cache`` argument)."""
    layer0 = next(iter(pool.values()))["attn"]["k"]
    table = torch.as_tensor(block_table.astype(np.int64), device=layer0.device)
    row = {}
    for layer in pool:
        leaves = pool[layer]["attn"]
        row[layer] = {"attn": {
            kv: leaves[kv][table].reshape((1, -1) + leaves[kv].shape[2:]) for kv in ("k", "v")}}
        row[layer]["attn"]["idx"] = torch.zeros((), dtype=torch.int32, device=layer0.device)
    return _rewind_cache(row, prefix_len)


def _suffix_prefill(model: TransformerLM, row_cache: dict, suffix_padded: torch.Tensor,
                    prefix_len: int, true_total: int) -> torch.Tensor:
    """One multi-token decode-mode pass over just the SUFFIX of a prompt
    whose prefix pages were served from the prefix cache — the compute skip
    that makes prefix sharing a TTFT win, not only a memory win. The suffix
    is right-padded to a 16-token bucket; the cache index is rewound to the
    true total afterwards. Returns the first-token logits [vocab]."""
    T_b = suffix_padded.shape[1]
    positions = prefix_len + torch.arange(T_b, device=suffix_padded.device)[None, :]
    logits = model(suffix_padded, positions, cache=row_cache)
    _rewind_cache(row_cache, true_total)
    return logits[0, true_total - prefix_len - 1]


# ---------------------------------------------------------------------------
# host-side allocator: free list + refcounts + prefix trie
# ---------------------------------------------------------------------------


class _PrefixNode:
    """One hash-consed prompt chunk: a trie edge labeled by ``chunk`` (a
    full page of token ids) holding the physical page that stores it. The
    node keeps one RETENTION reference on its page; live requests mapping
    the page add their own."""

    __slots__ = ("chunk", "page", "parent", "children", "tick")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: Optional["_PrefixNode"]):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.tick = 0


class PagedKVAllocator:
    """Free-list page allocator with refcounts, prefix hash-consing, and an
    admission watermark (all host-side bookkeeping; the device never sees
    anything but page-id arrays).

    Thread-safe: the engine worker allocates/frees while other threads read
    ``stats()``. Page ``TRASH_PAGE`` is pinned out of circulation forever.
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 watermark_frac: float = 0.05):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is trash)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # pages below this stay in reserve: admission defers instead of
        # draining the pool to zero (in-flight decode never waits on alloc
        # because every request reserves its full budget at admit)
        self.watermark = max(1, int((num_pages - 1) * watermark_frac))
        self._lock = threading.Lock()
        self._free: List[int] = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._ref = [0] * num_pages
        self._ref[TRASH_PAGE] = 1  # pinned
        self._root: Dict[Tuple[int, ...], _PrefixNode] = {}
        self._nodes: List[_PrefixNode] = []
        self._tick = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._evictions = 0
        self._alloc_fail = 0

    # -- page lifecycle ----------------------------------------------------

    def alloc(self, n: int, *, reserve: bool = True) -> Optional[List[int]]:
        """Take ``n`` fresh pages (refcount 1 each), evicting LRU prefix
        retentions if the free list runs short. Returns None — admission
        defers — when the pool cannot cover ``n`` plus the watermark
        reserve without touching pages live requests still map."""
        with self._lock:
            floor = self.watermark if reserve else 0
            if len(self._free) < n + floor:
                self._evict_locked(n + floor - len(self._free))
            if len(self._free) < n + floor:
                self._alloc_fail += 1
                tel.counter("serving.kv.alloc_deferred").add(1)
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._ref[p] = 1
            return pages

    def incref(self, pages: Sequence[int]) -> None:
        with self._lock:
            for p in pages:
                if p == TRASH_PAGE:
                    continue
                if self._ref[p] <= 0:
                    raise RuntimeError(f"incref on dead page {p}")
                self._ref[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; pages reaching zero return to the
        free list. Double-frees fail loudly — a silent one would hand the
        same page to two requests and corrupt both caches."""
        with self._lock:
            for p in pages:
                if p == TRASH_PAGE:
                    continue
                if self._ref[p] <= 0:
                    raise RuntimeError(f"double-free of page {p}")
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    self._free.append(p)

    # -- prefix hash-consing -----------------------------------------------

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        n_full = len(tokens) // ps
        return [tuple(tokens[i * ps:(i + 1) * ps]) for i in range(n_full)]

    def match_prefix(self, tokens: Sequence[int]) -> List[int]:
        """Longest hash-consed prefix of ``tokens`` (full pages only).
        Returns the shared page ids with one reference taken per page for
        the caller (release via ``free`` with the rest of its table)."""
        with self._lock:
            pages: List[int] = []
            level = self._root
            for chunk in self._chunks(tokens):
                node = level.get(chunk)
                if node is None:
                    break
                self._tick += 1
                node.tick = self._tick
                self._ref[node.page] += 1
                pages.append(node.page)
                level = node.children
            if pages:
                self._prefix_hits += 1
                tel.counter("serving.kv.prefix_hits").add(1)
            else:
                self._prefix_misses += 1
                tel.counter("serving.kv.prefix_misses").add(1)
            return pages

    def register_prefix(self, tokens: Sequence[int],
                        block_ids: Sequence[int]) -> None:
        """Hash-cons the prompt's full chunks, retaining one reference on
        each newly published page (already-registered chunks just refresh
        their LRU tick — including ones this request matched at admit).
        Only FULL chunks are registered, so a registered page is never a
        write target (see module docstring)."""
        with self._lock:
            chunks = self._chunks(tokens)
            level = self._root
            parent: Optional[_PrefixNode] = None
            for i, chunk in enumerate(chunks):
                node = level.get(chunk)
                if node is None:
                    page = block_ids[i]
                    if page == TRASH_PAGE or self._ref[page] <= 0:
                        break  # caller's table disagrees; don't publish junk
                    node = _PrefixNode(chunk, page, parent)
                    self._ref[page] += 1  # retention reference
                    level[chunk] = node
                    self._nodes.append(node)
                self._tick += 1
                node.tick = self._tick
                parent = node
                level = node.children

    def _evict_locked(self, need: int) -> None:
        """Reclaim up to ``need`` pages by dropping LRU prefix retentions
        whose pages no live request maps (refcount 1 = retention only).
        Inner trie nodes are only evictable once their children are gone —
        eviction order is leaves-first by last-use tick."""
        reclaimed = 0
        while reclaimed < need:
            victim = None
            for node in self._nodes:
                if node.children or self._ref[node.page] != 1:
                    continue
                if victim is None or node.tick < victim.tick:
                    victim = node
            if victim is None:
                return
            self._nodes.remove(victim)
            level = victim.parent.children if victim.parent else self._root
            level.pop(victim.chunk, None)
            self._ref[victim.page] -= 1
            if self._ref[victim.page] == 0:
                self._free.append(victim.page)
                reclaimed += 1
            self._evictions += 1
            tel.counter("serving.kv.prefix_evictions").add(1)

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            shared = sum(1 for n in self._nodes if self._ref[n.page] > 1)
            return {
                "kv_pages_total": self.num_pages - 1,  # trash excluded
                "kv_pages_free": len(self._free),
                "kv_pages_shared": shared,
                "kv_prefix_nodes": len(self._nodes),
                "kv_watermark_pages": self.watermark,
                "kv_prefix_hits": self._prefix_hits,
                "kv_prefix_misses": self._prefix_misses,
                "kv_prefix_evictions": self._evictions,
                "kv_alloc_deferred": self._alloc_fail,
            }

    def check_leaks(self) -> dict:
        """Test hook: with no live requests, every non-free page must be
        either trash or a retained prefix page (refcount exactly 1)."""
        with self._lock:
            retained = {n.page for n in self._nodes}
            leaked = [
                p for p in range(1, self.num_pages)
                if self._ref[p] > 0 and (p not in retained or self._ref[p] != 1)
            ]
            free_set = set(self._free)
            double = [p for p in free_set if self._ref[p] != 0]
            return {"leaked": leaked, "bad_free": double,
                    "accounted": len(free_set) + len(retained) + 1
                    == self.num_pages and not (free_set & retained)}
