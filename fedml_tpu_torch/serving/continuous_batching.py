"""Continuous batching: a slotted decode engine over the KV cache.

Counterpart of ``fedml_tpu/serving/continuous_batching.py``:

- a fixed pool of ``num_slots`` KV-cache rows is the decode batch, and ONE
  chunked step (``_cb_step``: ``chunk`` tokens per call) runs for as long
  as any slot is live — requests join and leave at token boundaries
  without restarting anyone else's decode;
- prefill is disaggregated: each request prefills alone at B=1 through
  the 16-token-bucketed prefill (``generation._prefill_padded``), then its
  cache row is copied into a free slot — a long prompt never stalls
  in-flight generation for more than its own prefill;
- per-row state stays runtime data: slot lengths ride the transformer's
  ``cache_idx`` decode mode (per-row scatter writes + per-row validity
  masks), each slot samples from its own ``torch.Generator`` seeded from
  its request's seed (so a seeded request's tokens depend neither on its
  slot nor on its neighbours), and EOS is checked on the host between
  chunks.

A chunk syncs with the host once, when its [B, chunk] tokens come back; the
tokens inside it stay on the device. A slot that stops mid-chunk (EOS or
budget) generates garbage until the chunk ends; the host discards it and
the freed slot's cache leftovers lie beyond the next occupant's index.

The worker thread runs under ``torch.inference_mode()`` on the engine's
device. Any error in it (a device error, an out-of-memory) fails every
pending request — queued, being admitted, or decoding — with that error,
and the engine refuses further work: after a device error it never
carries on.

Telemetry: TTFT/TPOT histograms, token/request counters, and a ``stats()``
snapshot (slot occupancy, queue depth) that the inference runner exports
as Prometheus gauges and ``/statusz`` fields (the paged engine adds its
page, prefix-cache and per-tenant gauges through ``prom_gauges``). Each
chunk is folded into devperf at its token sync, which already waits on the
card: program ``cb_step`` (``paged_step`` for the paged engine), its FLOPs
counted by :func:`decode_flops` (JAX's decode steps read XLA's count;
ROADMAP.md, Queue 3, P3).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import telemetry as tel
from ..core.pipeline.executor import PipelinedExecutor, PipelineError, StageSpec
from ..core.telemetry import devperf, tsdb
from ..models.transformer import TransformerConfig, TransformerLM, init_cache
from ..train.llm.generation import _eos_tuple, _prefill_padded, _sample, decode_model
from .admission import DEFAULT_TENANT, AdmissionController, AdmissionError
from .admission import REASON_QUEUE_FULL, count_reject
from .paged_kv import (
    TRASH_PAGE,
    PagedKVAllocator,
    _paged_admit,
    _paged_gather,
    _suffix_prefill,
    paged_config,
    paged_pool_init,
    row_config,
)

log = logging.getLogger(__name__)


def _on_device(dev: torch.device) -> contextlib.ExitStack:
    """What every engine thread runs under: inference mode, and ``dev`` as
    the current CUDA device (a new thread starts on device 0)."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.inference_mode())
    if dev.type == "cuda":
        stack.enter_context(torch.cuda.device(dev))
    return stack


def _sample_rows(logits: torch.Tensor, temps: np.ndarray,
                 gens: List[Optional[torch.Generator]], rows: List[int]) -> torch.Tensor:
    """argmax for every row; each row in ``rows`` (the slots at temperature
    > 0) instead draws from its own generator at its own temperature."""
    out = logits.argmax(-1)
    if rows:
        drawn = torch.cat([_sample(logits[b:b + 1], gens[b], float(temps[b])) for b in rows])
        out[torch.tensor(rows, device=logits.device)] = drawn
    return out


def matmul_params(model: TransformerLM) -> int:
    """The decode model's matmul weights: every parameter and int8
    ``kernel_q`` buffer but the embedding table (the LLM trainer's count)."""
    n = sum(p.numel() for p in model.parameters())
    n += sum(b.numel() for name, b in model.named_buffers() if name.endswith("kernel_q"))
    return n - model.cfg.vocab_size * model.cfg.d_model


def decode_flops(cfg: TransformerConfig, n_matmul: int, lengths: np.ndarray,
                 active: np.ndarray, C: int) -> float:
    """Analytic FLOPs of one chunk: each live slot's C tokens take 2 x the
    matmul params, and each attends over its context (the cached tokens and
    itself), QK^T and PV at 2 x d_model FLOPs a position a layer."""
    ctx = lengths[active].astype(np.float64)
    n = float(active.sum()) * C
    # sum over slots and steps c of (length + c + 1) positions
    positions = float((ctx * C).sum()) + n * (C + 1) / 2.0
    return 2.0 * n_matmul * n + 4.0 * cfg.n_layers * cfg.d_model * positions


def _cb_step(model: TransformerLM, cache: dict, tok: np.ndarray, lengths: np.ndarray,
             temps: np.ndarray, gens: List[Optional[torch.Generator]], active: np.ndarray,
             C: int, block_tables: Optional[np.ndarray] = None) -> np.ndarray:
    """The engine's one hot path: C single-token steps over all B slots
    (the paged engine passes its block tables). Per-request state is
    runtime data: host mirrors in, [B, C] tokens out (the chunk's one host
    sync)."""
    dev = model.embed.embedding.device
    S = model.cfg.max_seq_len
    B = len(tok)
    rows = [b for b in range(B) if active[b] and temps[b] > 0]
    tok_t = torch.as_tensor(tok, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    act = torch.as_tensor(active, device=dev)
    bt = None if block_tables is None else torch.as_tensor(block_tables, device=dev)
    out = torch.empty((B, C), dtype=torch.long, device=dev)
    for c in range(C):
        # clamp: a slot past its budget (mid-chunk EOS / inactive) rewrites
        # the last cache slot (or, paged, the trash page) with garbage the
        # host never reads, instead of scattering out of bounds
        idx = len_t.clamp_max(S - 1)
        logits = model(tok_t[:, None], idx[:, None], cache_idx=idx, block_tables=bt,
                       cache=cache)
        tok_t = torch.where(act, _sample_rows(logits[:, -1], temps, gens, rows), 0)
        len_t = len_t + act
        out[:, c] = tok_t
    return out.cpu().numpy()


class RequestHandle:
    """Future for one submitted request. ``result()`` blocks for the full
    token list; ``text`` is filled when the engine has a tokenizer."""

    def __init__(self):
        self._ev = threading.Event()
        self._tokens: Optional[List[int]] = None
        self._exc: Optional[BaseException] = None
        self.text: Optional[str] = None
        self.ttft_s: Optional[float] = None
        self.tpot_s: Optional[float] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._ev.wait(timeout=timeout):
            raise TimeoutError("continuous-batching request timed out")
        if self._exc is not None:
            raise self._exc
        if self._tokens is None:
            raise RuntimeError("request finished without tokens")
        return self._tokens

    def _finish(self, tokens: List[int]) -> None:
        self._tokens = tokens
        self._ev.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()


@dataclasses.dataclass
class _Pending:
    prompt: List[int]
    max_new: int
    temperature: float
    seed: int
    eos_ids: Optional[Tuple[int, ...]]
    handle: RequestHandle
    t_submit: float
    tenant: str = "default"
    wfq_tag: float = 0.0  # weighted-fair-queueing virtual finish tag


@dataclasses.dataclass
class _Active:
    pending: _Pending
    budget: int  # max_new clamped to cache capacity at admit
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_first: float = 0.0
    generated: int = 0  # device tokens produced, kept OR discarded


class ContinuousBatchingEngine:
    """Slotted continuous-batching decode engine (see module docstring).

    ``submit()`` is thread-safe and non-blocking (FIFO admission when a
    slot frees); ``generate()`` is the blocking convenience. One engine
    owns one cache pool and one worker thread; ``params`` (anything
    ``generation.decode_model`` takes) become one decode model on
    ``device``, shared read-only."""

    #: devperf registry label for the decode step this engine drives
    _devperf_label = "cb_step"

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        *,
        num_slots: int = 8,
        chunk: int = 8,
        max_queue: int = 4096,
        device="cuda",
    ):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self._model = decode_model(cfg, params, device=device)
        self._dev = self._model.embed.embedding.device
        self._cfg = cfg
        self._B = int(num_slots)
        self._C = int(chunk)
        self._max_queue = int(max_queue)
        self._n_matmul = matmul_params(self._model)
        devperf.instrument(_cb_step, self._devperf_label, device=self._dev,
                           dtype=self._model.cfg.dtype)

        with _on_device(self._dev):
            self._cache = self._build_cache()

        # per-slot host mirrors, uploaded once per chunk
        self._slots: List[Optional[_Active]] = [None] * self._B
        self._tok = np.zeros((self._B,), np.int64)
        self._lengths = np.zeros((self._B,), np.int64)
        self._temps = np.zeros((self._B,), np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * self._B

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: "collections.deque[_Pending]" = collections.deque()
        self._stopping = False
        self._error: Optional[BaseException] = None
        self._requests_done = 0
        self._tokens_out = 0  # KEPT tokens (post-EOS/budget truncation)
        # bounded recent samples: exact TTFT/TPOT percentiles
        self._recent_ttft: "collections.deque[float]" = collections.deque(maxlen=8192)
        self._recent_tpot: "collections.deque[float]" = collections.deque(maxlen=8192)
        self._worker = threading.Thread(
            target=self._loop, name="cb-engine", daemon=True
        )
        self._worker.start()

    def _build_cache(self) -> dict:
        """Slot pool cache: [B, S, kv, hd] per layer (the paged engine
        overrides this with the page pool)."""
        return init_cache(self._model.cfg, self._B, self._dev)

    # -- public API --------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id=None,
        tenant: str = "default",
    ) -> RequestHandle:
        handle = RequestHandle()
        prompt = [int(t) for t in prompt]
        eos_ids = _eos_tuple(eos_id)
        if len(prompt) < 1:
            handle._fail(ValueError("prompt must contain at least one token"))
            return handle
        if max_new_tokens < 1:
            handle._fail(
                ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
            )
            return handle
        if len(prompt) + 1 > self._cfg.max_seq_len:
            handle._fail(
                ValueError(
                    f"prompt {len(prompt)} leaves no decode room in "
                    f"max_seq_len {self._cfg.max_seq_len}"
                )
            )
            return handle
        if min(prompt) < 0 or max(prompt) >= self._cfg.vocab_size:
            # an id past the embedding would read out of bounds on the card
            handle._fail(ValueError(f"token ids must lie in [0, {self._cfg.vocab_size})"))
            return handle
        item = _Pending(
            prompt, int(max_new_tokens), float(temperature), int(seed),
            eos_ids, handle, time.perf_counter(), tenant=str(tenant),
        )
        with self._work:
            if self._stopping:
                handle._fail(self._stopped_error())
                return handle
            if len(self._queue) >= self._max_queue:
                self._reject_queue_full(item)
                return handle
            self._on_enqueue(item)
            self._queue.append(item)
            tel.counter("serving.cb.requests").add(1)
            self._work.notify()
        return handle

    def _stopped_error(self) -> RuntimeError:
        if self._error is not None:
            return RuntimeError(f"engine stopped after a worker error: {self._error!r}")
        return RuntimeError("engine is shutting down")

    def _reject_queue_full(self, item: _Pending) -> None:
        item.handle._fail(RuntimeError("admission queue full"))

    def _on_enqueue(self, item: _Pending) -> None:
        """Hook (called under the lock): the paged engine stamps the WFQ
        virtual finish tag here."""

    def generate(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id=None,
        timeout: Optional[float] = 600.0,
        tenant: str = "default",
    ) -> List[int]:
        return self.submit(
            prompt, max_new_tokens, temperature=temperature, seed=seed,
            eos_id=eos_id, tenant=tenant,
        ).result(timeout=timeout)

    def stats(self) -> dict:
        """Gauge snapshot (cheap; lock-guarded)."""
        with self._lock:
            active = sum(1 for s in self._slots if s is not None)
            return {
                "slots_total": self._B,
                "slots_active": active,
                "slot_occupancy": active / self._B,
                "queue_depth": len(self._queue),
                "chunk": self._C,
                "requests_done": self._requests_done,
                "tokens_out": self._tokens_out,
            }

    def latency_percentiles(self) -> dict:
        """Exact percentiles over the recent-sample windows (seconds)."""

        def pct(samples, qs):
            if not samples:
                return {f"p{int(q * 100)}": None for q in qs}
            xs = sorted(samples)
            return {
                f"p{int(q * 100)}": xs[min(len(xs) - 1, int(q * len(xs)))]
                for q in qs
            }

        with self._lock:
            ttft = list(self._recent_ttft)
            tpot = list(self._recent_tpot)
        return {
            "ttft_s": pct(ttft, (0.5, 0.99)),
            "tpot_s": pct(tpot, (0.5, 0.99)),
        }

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the worker; queued and in-flight requests fail fast (the
        callers' futures unblock) rather than hang."""
        with self._work:
            self._stopping = True
            self._work.notify()
        self._worker.join(timeout=timeout)

    # -- worker ------------------------------------------------------------

    def _loop(self) -> None:
        with _on_device(self._dev):
            while True:
                with self._work:
                    while (
                        not self._stopping
                        and not self._queue
                        and all(s is None for s in self._slots)
                    ):
                        self._work.wait()
                    if self._stopping:
                        self._fail_pending_locked(RuntimeError("engine is shutting down"))
                        return
                try:
                    self._admit_all()
                    if any(s is not None for s in self._slots):
                        self._step_chunk()
                except Exception as e:  # noqa: BLE001 - engine thread boundary:
                    # fail every rider with the error rather than die silently
                    # with their futures hanging, and stop: after a device
                    # error the card's state is not to be trusted
                    log.exception("continuous-batching worker failed; stopping the engine")
                    with self._work:
                        self._error = e
                        self._stopping = True
                        self._fail_pending_locked(e)
                    return

    def _fail_pending_locked(self, err: BaseException) -> None:
        """Fail every queued and in-flight request (caller holds the lock)."""
        for item in self._queue:
            item.handle._fail(err)
        self._queue.clear()
        for i, s in enumerate(self._slots):
            if s is not None:
                s.pending.handle._fail(err)
                self._release_slot(i, s)
                self._slots[i] = None

    def _admit_all(self) -> None:
        cfg = self._cfg
        while True:
            with self._lock:
                try:
                    free = self._slots.index(None)
                except ValueError:
                    return
                if not self._queue:
                    return
                item = self._queue.popleft()
            P = len(item.prompt)
            # clamp to capacity: decode writes land at P..P+budget-2 (the
            # first token is sampled from prefill logits, never written
            # ahead), so budget = S - P keeps every KEPT token's write
            # in-bounds; the step's idx clamp absorbs mid-chunk overrun
            budget = min(item.max_new, cfg.max_seq_len - P)
            try:
                with tel.timed("serving.cb.prefill", prompt_len=P):
                    row_cache, first_logits = _prefill_padded(self._model, item.prompt,
                                                              self._dev)
                    for layer, leaves in self._cache.items():
                        for kv in ("k", "v"):
                            leaves["attn"][kv][free].copy_(row_cache[layer]["attn"][kv][0])
                    gen = torch.Generator(device=self._dev).manual_seed(item.seed)
                    # one host sync per admission, not per decode step
                    tok0 = int(_sample(first_logits, gen, item.temperature)[0])
            except Exception as e:  # noqa: BLE001 - the popped request is in
                # no queue and no slot: fail it here, then stop the engine
                item.handle._fail(e)
                raise
            now = time.perf_counter()
            active = _Active(item, budget, [tok0], now, generated=1)
            self._tok[free] = tok0
            self._lengths[free] = P
            self._temps[free] = item.temperature
            self._gens[free] = gen
            ttft = now - item.t_submit
            active.pending.handle.ttft_s = ttft
            self._recent_ttft.append(ttft)
            tel.histogram("serving.cb.ttft_seconds").observe(ttft)
            tel.counter("serving.cb.admissions").add(1)
            with self._lock:
                self._slots[free] = active
            self._finish_if_done(free, now)

    def _block_tables(self) -> Optional[np.ndarray]:
        """The paged engine's block tables for the step; none here."""
        return None

    def _step_chunk(self) -> None:
        with self._lock:
            active_mask = np.asarray(
                [s is not None for s in self._slots], bool
            )
        n_live = int(active_mask.sum())
        with tel.timed("serving.cb.chunk", slots=n_live) as sp:
            toks = _cb_step(self._model, self._cache, self._tok, self._lengths,
                            self._temps, self._gens, active_mask, self._C,
                            self._block_tables())  # [B, C]
        devperf.observe_step(self._devperf_label, sp.duration_s, tokens=n_live * self._C,
                             flops=decode_flops(self._model.cfg, self._n_matmul, self._lengths,
                                                active_mask, self._C))
        self._tok = toks[:, -1].copy()
        self._lengths = self._lengths + active_mask * self._C
        now = time.perf_counter()
        tel.counter("serving.cb.tokens_generated").add(n_live * self._C)
        for b in range(self._B):
            with self._lock:
                s = self._slots[b]
            if s is None:
                continue
            s.generated += self._C
            for t in toks[b]:
                t = int(t)
                s.tokens.append(t)
                if s.pending.eos_ids is not None and t in s.pending.eos_ids:
                    break
                if len(s.tokens) >= s.budget:
                    break
            self._finish_if_done(b, now)

    def _finish_if_done(self, b: int, now: float) -> bool:
        """Free slot ``b`` if its request hit EOS or its token budget; the
        slot's cache leftovers lie beyond the next occupant's index."""
        with self._lock:
            s = self._slots[b]
        if s is None:
            return False
        eos = s.pending.eos_ids
        hit_eos = eos is not None and any(t in eos for t in s.tokens)
        if not hit_eos and len(s.tokens) < s.budget:
            return False
        if hit_eos:
            cut = next(i for i, t in enumerate(s.tokens) if t in eos)
            s.tokens = s.tokens[: cut + 1]
        else:
            s.tokens = s.tokens[: s.budget]
        if len(s.tokens) > 1:
            tpot = (now - s.t_first) / (len(s.tokens) - 1)
            s.pending.handle.tpot_s = tpot
            self._recent_tpot.append(tpot)
            tel.histogram("serving.cb.tpot_seconds").observe(tpot)
        # EOS/budget mid-chunk waste, measured instead of silent: the slot
        # kept burning decode FLOPs until the chunk boundary; the paged
        # engine also reclaims the request's KV pages here (_release_slot)
        wasted = s.generated - len(s.tokens)
        if wasted > 0:
            tel.counter("serving.wasted_tokens").add(wasted)
        self._release_slot(b, s)
        with self._lock:
            self._slots[b] = None
            self._requests_done += 1
            self._tokens_out += len(s.tokens)
        s.pending.handle._finish(s.tokens)
        return True

    def _release_slot(self, b: int, s: _Active) -> None:
        """Hook: free per-slot resources at the chunk boundary where the
        host learns the request is done. The slot engine has nothing to
        free (the row's leftovers are masked out for the next occupant)."""


# ---------------------------------------------------------------------------
# paged engine: block-table KV over a shared page pool (serving/paged_kv.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _AdmitWork:
    """One request moving through the prefill -> transfer -> admit pipeline
    (created by ``_collect_wave`` holding its slot + page reservations)."""

    item: _Pending
    slot: int
    budget: int
    n_shared: int             # leading blocks served from the prefix cache
    shared_pages: List[int]   # one reference held per page
    private_pages: List[int]  # one reference held per page
    row_cache: object = None
    first_vec: object = None  # [vocab] logits for the first sampled token
    tok0: int = 0
    gen: object = None        # the request's torch.Generator
    admitted: bool = False


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching over a PAGED KV cache (see serving/paged_kv.py).

    Same public surface as :class:`ContinuousBatchingEngine` plus:

    - device memory scales with admitted tokens, not ``num_slots *
      max_seq_len``: each request reserves ``ceil((prompt + budget) /
      page_size)`` pages at admit (reservation up front means decode never
      runs out of pages mid-flight), and requests sharing a hash-consed
      prompt prefix map the same physical pages;
    - admission runs as a prefill -> transfer -> admit
      :class:`PipelinedExecutor` wave, so request i+1's prefill overlaps
      request i's pool scatter on the host;
    - a finished request's pages are reclaimed at the chunk boundary
      where the host learns about EOS (``serving.wasted_tokens`` counts
      the discarded mid-chunk tail);
    - an optional :class:`AdmissionController` gates the front door:
      submit-time token budgets + shed, dequeue-time weighted fair
      queueing + SLO-pressure deferral (serving/admission.py).
    """

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        *,
        num_slots: int = 8,
        chunk: int = 8,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        watermark_frac: float = 0.05,
        max_queue: int = 4096,
        admission: Optional[AdmissionController] = None,
        device="cuda",
    ):
        base = row_config(cfg)
        if num_pages is None:
            # drop-in default: same KV capacity as the slot engine (+trash);
            # deployments shrink this to realize the memory win
            num_pages = num_slots * (base.max_seq_len // page_size) + 1
        self._paged_cfg = paged_config(
            base, page_size=page_size, num_pages=num_pages)
        self._ps = int(page_size)
        self._n_blocks = base.max_seq_len // self._ps
        self._alloc = PagedKVAllocator(
            num_pages, page_size, watermark_frac=watermark_frac)
        self._admission = admission
        self._tables = np.full((num_slots, self._n_blocks), TRASH_PAGE,
                               np.int64)
        self._tenant_ttft: dict = {}
        super().__init__(params, base, num_slots=num_slots, chunk=chunk,
                         max_queue=max_queue, device=device)

    # -- cache + step wiring ------------------------------------------------

    _devperf_label = "paged_step"

    def _build_cache(self) -> dict:
        return paged_pool_init(self._paged_cfg, self._dev)

    def _block_tables(self) -> Optional[np.ndarray]:
        return self._tables

    # -- admission-gated submit ---------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id=None,
        tenant: str = DEFAULT_TENANT,
    ) -> RequestHandle:
        if self._admission is not None:
            prompt = [int(t) for t in prompt]
            reason = self._admission.check(
                tenant, len(prompt) + int(max_new_tokens))
            if reason is not None:
                handle = RequestHandle()
                handle._fail(AdmissionError(tenant, reason))
                return handle
        return super().submit(
            prompt, max_new_tokens, temperature=temperature, seed=seed,
            eos_id=eos_id, tenant=tenant)

    def _on_enqueue(self, item: _Pending) -> None:
        if self._admission is not None:
            item.wfq_tag = self._admission.stamp(
                item.tenant, len(item.prompt) + item.max_new)

    def _reject_queue_full(self, item: _Pending) -> None:
        count_reject(item.tenant, REASON_QUEUE_FULL)
        item.handle._fail(AdmissionError(item.tenant, REASON_QUEUE_FULL))

    # -- pipelined admission ------------------------------------------------

    def _admit_all(self) -> None:
        while True:
            wave = self._collect_wave()
            if not wave:
                with self._lock:
                    starved = (bool(self._queue)
                               and all(s is None for s in self._slots))
                if starved:
                    # every queued tenant is deferred (or the pool is
                    # draining) and nothing is in flight: don't spin the
                    # worker loop hot while backpressure holds
                    time.sleep(0.005)
                return
            with tel.timed("serving.paged.admit_wave", n=len(wave)):
                self._run_wave(wave)

    def _pick_locked(self) -> Optional[_Pending]:
        """Next request to admit (caller holds the engine lock): FIFO
        without a controller, else the smallest WFQ virtual-finish tag
        among tenants that are not deferred."""
        if self._admission is None:
            return self._queue.popleft() if self._queue else None
        best = None
        eligible_cache: dict = {}
        for item in self._queue:
            ok = eligible_cache.get(item.tenant)
            if ok is None:
                ok = self._admission.eligible(item.tenant)
                eligible_cache[item.tenant] = ok
            if ok and (best is None or item.wfq_tag < best.wfq_tag):
                best = item
        if best is None:
            return None
        self._queue.remove(best)
        self._admission.on_dequeue(best.wfq_tag)
        return best

    def _collect_wave(self) -> List[_AdmitWork]:
        cfg = self._cfg
        wave: List[_AdmitWork] = []
        taken: set = set()
        while True:
            with self._lock:
                free = next((i for i, s in enumerate(self._slots)
                             if s is None and i not in taken), None)
                if free is None or not self._queue:
                    return wave
                item = self._pick_locked()
            if item is None:  # every queued tenant is deferred right now
                return wave
            P = len(item.prompt)
            budget = min(item.max_new, cfg.max_seq_len - P)
            n_req = -(-(P + budget) // self._ps)
            shared = self._alloc.match_prefix(item.prompt)
            # never map the block holding the prompt's LAST token from the
            # prefix cache: the suffix pass needs >= 1 real token for the
            # first-logits read, and when P is page-aligned decode writes
            # begin in exactly that block (shared pages are never written)
            n_shared_max = (P - 1) // self._ps
            if len(shared) > n_shared_max:
                self._alloc.free(shared[n_shared_max:])
                shared = shared[:n_shared_max]
            private = self._alloc.alloc(n_req - len(shared))
            if private is None:
                self._alloc.free(shared)
                with self._lock:
                    busy = any(s is not None for s in self._slots)
                    if busy or wave:
                        # pages free as in-flight requests finish: defer
                        self._queue.appendleft(item)
                        return wave
                # nothing in flight, nothing admitted, eviction already
                # tried: this request can never fit — fail it, not the pool
                item.handle._fail(RuntimeError(
                    f"prompt {P} + budget {budget} needs "
                    f"{n_req - len(shared)} KV pages; the pool cannot free "
                    "enough (raise num_pages or lower max_new_tokens)"))
                continue
            wave.append(_AdmitWork(item, free, budget, len(shared),
                                   shared, private))
            taken.add(free)

    def _staged(self, fn):
        """A stage function that runs on its own pipeline thread."""

        def run(w: _AdmitWork) -> _AdmitWork:
            with _on_device(self._dev):
                return fn(w)

        return run

    def _run_wave(self, wave: List[_AdmitWork]) -> None:
        pipe = PipelinedExecutor(
            [StageSpec("prefill", self._staged(self._stage_prefill), maxsize=2),
             StageSpec("transfer", self._staged(self._stage_transfer), maxsize=2),
             StageSpec("admit", self._staged(self._stage_admit), maxsize=2)],
            name="paged_admit")
        try:
            pipe.run(wave)
        except PipelineError as e:
            # fail the riders that never reached the admit stage and return
            # their reservations; then stop the engine (the worker loop
            # fails the admitted riders with the same error)
            log.exception("paged admission wave failed")
            for w in wave:
                if w.admitted:
                    continue
                self._alloc.free(w.shared_pages + w.private_pages)
                w.item.handle._fail(e)
            raise

    def _stage_prefill(self, w: _AdmitWork) -> _AdmitWork:
        """Stage 1: produce a contiguous row cache + first-token logits —
        a full bucketed prefill on a prefix MISS, or gather-shared-pages +
        one suffix pass on a HIT (the prefix compute skip)."""
        cfg = self._cfg
        item = w.item
        P = len(item.prompt)
        prefix_len = w.n_shared * self._ps
        with tel.timed("serving.cb.prefill", prompt_len=P, shared=prefix_len):
            if w.n_shared == 0:
                row_cache, first = _prefill_padded(self._model, item.prompt, self._dev)
                w.first_vec = first[0]
            else:
                table = np.full((self._n_blocks,), TRASH_PAGE, np.int64)
                table[:w.n_shared] = w.shared_pages
                # shared pages are never rewritten, so reading them while the
                # transfer stage scatters other requests' pages is exact
                row_cache = _paged_gather(self._cache, table, prefix_len)
                suffix = item.prompt[prefix_len:]
                T_suf = len(suffix)
                T_b = min(-(-T_suf // 16) * 16, cfg.max_seq_len - prefix_len)
                ids = torch.tensor([suffix + [0] * (T_b - T_suf)], dtype=torch.long,
                                   device=self._dev)
                w.first_vec = _suffix_prefill(self._model, row_cache, ids, prefix_len, P)
        w.row_cache = row_cache
        return w

    def _stage_transfer(self, w: _AdmitWork) -> _AdmitWork:
        """Stage 2: scatter the row's PROMPT blocks into the request's
        private pages (shared blocks stay untouched) and sample the first
        token. This is the page handoff, the only stage that writes the
        decode pool."""
        item = w.item
        P = len(item.prompt)
        write_ids = np.full((self._n_blocks,), TRASH_PAGE, np.int64)
        first_blk = w.n_shared
        last_blk = -(-P // self._ps)  # exclusive: block of the last token
        write_ids[first_blk:last_blk] = w.private_pages[:last_blk - first_blk]
        w.gen = torch.Generator(device=self._dev).manual_seed(item.seed)
        w.tok0 = _paged_admit(self._paged_cfg, self._cache, w.row_cache, write_ids,
                              w.first_vec, w.gen, item.temperature)
        w.row_cache = None  # the staging row is done with: free it now
        return w

    def _stage_admit(self, w: _AdmitWork) -> _AdmitWork:
        """Stage 3: host bookkeeping — publish the block table, mirrors,
        and the slot; register the prompt's full chunks in the prefix
        cache so the NEXT request with this system prompt shares pages."""
        item = w.item
        b = w.slot
        now = time.perf_counter()
        table = np.full((self._n_blocks,), TRASH_PAGE, np.int64)
        n_own = w.n_shared + len(w.private_pages)
        table[:w.n_shared] = w.shared_pages
        table[w.n_shared:n_own] = w.private_pages
        self._tok[b] = w.tok0
        self._lengths[b] = len(item.prompt)
        self._temps[b] = item.temperature
        self._gens[b] = w.gen
        self._tables[b] = table
        ttft = now - item.t_submit
        item.handle.ttft_s = ttft
        self._recent_ttft.append(ttft)
        tel.histogram("serving.cb.ttft_seconds").observe(ttft)
        tel.counter("serving.cb.admissions").add(1)
        self._observe_tenant_ttft(item.tenant, ttft)
        n_prompt_blocks = len(item.prompt) // self._ps  # FULL chunks only
        self._alloc.register_prefix(
            item.prompt, [int(p) for p in table[:n_prompt_blocks]])
        with self._lock:
            self._slots[b] = _Active(item, w.budget, [w.tok0], now,
                                     generated=1)
        w.admitted = True
        self._finish_if_done(b, now)
        return w

    # -- page reclamation ---------------------------------------------------

    def _release_slot(self, b: int, s: _Active) -> None:
        """Chunk-boundary reclamation: drop the request's reference on
        every page its table maps and point the row at the trash page so
        the slot's remaining mid-chunk scatters can't touch reused pages."""
        pages = [int(p) for p in self._tables[b] if p != TRASH_PAGE]
        self._tables[b, :] = TRASH_PAGE
        if pages:
            self._alloc.free(pages)

    def _observe_tenant_ttft(self, tenant: str, ttft: float) -> None:
        dq = self._tenant_ttft.get(tenant)
        if dq is None:
            dq = self._tenant_ttft.setdefault(
                tenant, collections.deque(maxlen=1024))
        dq.append(ttft)
        store = tsdb.active()
        if store is not None:
            # per-tenant TTFT history, for a tenant's SLO
            store.record_observation(
                "serving.tenant.ttft_seconds." + tenant, ttft)

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        out = super().stats()
        a = self._alloc.stats()
        with self._lock:
            live = int(sum(int(self._lengths[i])
                           for i, s in enumerate(self._slots)
                           if s is not None))
        pages_used = a["kv_pages_total"] - a["kv_pages_free"]
        out.update(a)
        out.update({
            "kv_page_size": self._ps,
            "kv_pages_in_use": pages_used,
            "kv_tokens_live": live,
            # pages per live token: the memory-efficiency headline
            # (multiply by page bytes for bytes/token; the slot engine's
            # analogue is slots*max_seq_len/live, always >= paged's)
            "kv_pages_per_token": pages_used / live if live else 0.0,
        })
        if self._admission is not None:
            out["admission"] = self._admission.stats()
        return out

    def prom_gauges(self) -> list:
        """(name, labels, value) triples for a /metrics exporter."""
        out = []
        st = self._alloc.stats()
        out.append(("serving_kv_pages", {"state": "free"},
                    float(st["kv_pages_free"])))
        out.append(("serving_kv_pages", {"state": "used"},
                    float(st["kv_pages_total"] - st["kv_pages_free"])))
        out.append(("serving_kv_pages", {"state": "watermark"},
                    float(st["kv_watermark_pages"])))
        out.append(("serving_kv_prefix_nodes", None,
                    float(st["kv_prefix_nodes"])))
        with self._lock:
            tenants = [(t, sorted(dq)) for t, dq in self._tenant_ttft.items()
                       if dq]
        for t, xs in tenants:
            p99 = xs[min(len(xs) - 1, int(0.99 * len(xs)))]
            out.append(("serving_tenant_ttft_p99_seconds", {"tenant": t},
                        float(p99)))
        if self._admission is not None:
            out.extend(self._admission.prom_gauges())
        return out
