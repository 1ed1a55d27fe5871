"""Device-performance observability: the program cost registry.

Counterpart of ``fedml_tpu/core/telemetry/devperf.py``. The JAX module
lowers and compiles each instrumented step ahead of time and reads XLA's
``cost_analysis()``; torch has no such executable, so here
:func:`instrument` registers the step with its caller's analytic FLOP
count (``flops_source: "caller_analytic"``), the device's kind and the
compute dtype, and returns the callable unchanged. A flop counter is not
used: PyTorch's ``FlopCounterMode`` has no formula for the port's
hand-written kernels and would miss the attention. Callers fold MEASURED
wall time in via :func:`observe_step` / :func:`observe_window` at the
places that already wait on the card: the LLM trainer's synchronised
``llm.train`` window, the serving engines' chunk token sync. A decode
window passes its own FLOPs (``flops=``: 2 x matmul params a token plus the
attention over each token's context), where JAX reads XLA's count
(ROADMAP.md, Queue 3, P3).

Each fold updates the program's achieved FLOP/s and its MFU against the
dense peak of its device and dtype (``core/distributed/device_specs.py``:
the H100 rows), and emits:

- counters ``program.flops.<label>`` / ``program.steps.<label>`` ->
  ``fedml_program_flops_total{program=}`` / ``fedml_program_steps_total{program=}``;
- tsdb gauges ``devperf.mfu.<label>`` (the SLO engine's ``mfu_collapse``
  row keys on the glob), recorded only while a tsdb store is installed;
- ride-along prom gauges ``fedml_device_mfu{program=}`` /
  ``fedml_device_flops_per_sec{program=}`` via :func:`prom_gauges`.

A fold on a CUDA program also records the card's allocated bytes now and at
their peak (``torch.cuda.memory_allocated`` / ``max_memory_allocated``),
read without resetting the peak counters other code reads.

:class:`HbmSampler` is the memory side: a daemon thread reads every
card's ``torch.cuda.memory_stats()`` (``allocated_bytes.all.current`` and
``.peak``, against ``get_device_properties().total_memory``) on a fixed
cadence into live and high-water gauges (``fedml_device_hbm_bytes{device=}``
/ ``fedml_device_hbm_high_water_bytes{device=}``) and the tsdb series
``devperf.hbm_high_water_frac`` that the ``hbm_high_water`` SLO watches. On
the CPU it samples nothing, as the JAX sampler reads nothing there.

Everything accounts its own cost into ``overhead_ns``. ``FEDML_DEVPERF=0``
disables the layer (:func:`instrument` returns the fn unregistered, folds
and the sampler no-op).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..distributed import device_specs
from . import prom, tsdb
from .core import get_telemetry

log = logging.getLogger(__name__)

__all__ = [
    "CompiledProgramRegistry",
    "HbmSampler",
    "device_kind",
    "device_memory_stats",
    "enabled",
    "get_registry",
    "instrument",
    "observe_step",
    "observe_window",
    "prom_gauges",
    "reset",
    "snapshot",
    "start_hbm_sampler",
    "statusz_snapshot",
    "stop_hbm_sampler",
]

_ENV_DISABLE = "FEDML_DEVPERF"
_ENV_HBM_INTERVAL = "FEDML_DEVPERF_HBM_INTERVAL_S"

FLOPS_SOURCE_ANALYTIC = "caller_analytic"

# fedml_program_* counter families: one value per instrumented step label
prom.register_prefix_family(
    "program.flops.", ("program",),
    "device FLOPs executed per instrumented compiled program")
prom.register_prefix_family(
    "program.steps.", ("program",),
    "measured step count per instrumented compiled program")


def enabled() -> bool:
    return os.environ.get(_ENV_DISABLE, "1") != "0"


class ProgramRecord:
    """Mutable per-program row; all mutation happens under the registry
    lock, readers get dict copies via :meth:`as_dict`. The JAX record's
    fields, with ``flops_xla``, ``bytes_accessed`` and the roofline fields
    always None (there is no XLA cost analysis to fill them), plus
    ``dtype``, the compute dtype whose peak MFU divides by, and ``device``,
    the torch device the fold reads memory on (not exported)."""

    __slots__ = (
        "label", "n_devices", "device_kind", "dtype", "device", "captured", "aot",
        "flops_xla", "flops_hint", "flops_per_token_hint", "flops_source",
        "bytes_accessed", "memory", "peak_flops_per_sec",
        "op_intensity", "ridge", "roofline_verdict",
        "calls", "steps", "tokens", "device_seconds",
        "last_step_wall_s", "last_flops_per_sec", "last_mfu",
    )

    def __init__(self, label: str, n_devices: int,
                 flops_hint: Optional[float],
                 flops_per_token_hint: Optional[float]):
        self.label = label
        self.n_devices = max(1, int(n_devices))
        self.device_kind = ""
        self.dtype: Optional[str] = None
        self.device: Any = None
        self.captured = False
        self.aot = False
        self.flops_xla: Optional[float] = None
        self.flops_hint = flops_hint
        self.flops_per_token_hint = flops_per_token_hint
        self.flops_source: Optional[str] = None
        self.bytes_accessed: Optional[float] = None
        self.memory: Dict[str, int] = {}
        self.peak_flops_per_sec: Optional[float] = None
        self.op_intensity: Optional[float] = None
        self.ridge: Optional[float] = None
        self.roofline_verdict: Optional[str] = None
        self.calls = 0
        self.steps = 0
        self.tokens = 0
        self.device_seconds = 0.0
        self.last_step_wall_s: Optional[float] = None
        self.last_flops_per_sec: Optional[float] = None
        self.last_mfu: Optional[float] = None

    def step_flops(self, tokens_per_step: Optional[float]) -> Optional[float]:
        """FLOPs per step: the per-token hint times the tokens a step, else
        the per-step hint (MFU is defined on model FLOPs)."""
        if self.flops_per_token_hint is not None and tokens_per_step:
            return self.flops_per_token_hint * tokens_per_step
        if self.flops_hint is not None:
            return self.flops_hint
        return self.flops_xla

    def as_dict(self) -> Dict[str, Any]:
        return {
            "label": self.label,
            "n_devices": self.n_devices,
            "device_kind": self.device_kind,
            "dtype": self.dtype,
            "captured": self.captured,
            "aot": self.aot,
            "flops_xla": self.flops_xla,
            "flops_hint": self.flops_hint,
            "flops_per_token_hint": self.flops_per_token_hint,
            "flops_source": self.flops_source,
            "bytes_accessed": self.bytes_accessed,
            "memory": dict(self.memory),
            "peak_flops_per_sec": self.peak_flops_per_sec,
            "op_intensity": self.op_intensity,
            "ridge_flops_per_byte": self.ridge,
            "roofline_verdict": self.roofline_verdict,
            "calls": self.calls,
            "steps": self.steps,
            "tokens": self.tokens,
            "device_seconds": self.device_seconds,
            "last_step_wall_s": self.last_step_wall_s,
            "achieved_flops_per_sec": self.last_flops_per_sec,
            "mfu": self.last_mfu,
        }


class CompiledProgramRegistry:
    """Per-process program table + HBM watermarks + self-accounted cost.

    Leaf lock: nothing is called while ``_lock`` is held except record
    mutation; telemetry/tsdb emission happens in the module-level fold
    functions after the lock is released.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: Dict[str, ProgramRecord] = {}
        self._hbm: Dict[str, Dict[str, Optional[float]]] = {}
        self.overhead_ns = 0

    # --- registration -----------------------------------------------------
    def register(self, label: str, *, n_devices: int = 1,
                 flops_hint: Optional[float] = None,
                 flops_per_token_hint: Optional[float] = None) -> ProgramRecord:
        with self._lock:
            rec = self._programs.get(label)
            if rec is None:
                rec = ProgramRecord(label, n_devices, flops_hint,
                                    flops_per_token_hint)
                self._programs[label] = rec
            else:
                rec.n_devices = max(1, int(n_devices))
                if flops_hint is not None:
                    rec.flops_hint = flops_hint
                if flops_per_token_hint is not None:
                    rec.flops_per_token_hint = flops_per_token_hint
            return rec

    def note_capture(self, label: str, *, device_kind: str,
                     flops_xla: Optional[float] = None,
                     bytes_accessed: Optional[float] = None,
                     memory: Optional[Dict[str, int]] = None,
                     aot: bool = False, dtype="bfloat16", device: Any = None) -> None:
        """Pin the program's device and peak (the JAX module does this when
        it captures the compiled executable; here, when it is instrumented).
        The JAX signature is kept; XLA's ``flops_xla``/``bytes_accessed``
        have no source here and are always None."""
        peak = device_specs.peak_flops_per_sec(device_kind, dtype)
        with self._lock:
            rec = self._programs.get(label)
            if rec is None:
                return
            rec.captured = True
            rec.aot = aot
            rec.device_kind = device_kind
            rec.dtype = device_specs.dtype_name(dtype)
            rec.device = device
            rec.flops_xla = flops_xla
            rec.bytes_accessed = bytes_accessed
            rec.memory = dict(memory or {})
            rec.peak_flops_per_sec = peak * rec.n_devices
            rec.flops_source = FLOPS_SOURCE_ANALYTIC

    # --- measurement folds -----------------------------------------------
    def fold(self, label: str, wall_s: float, steps: int,
             tokens: Optional[int], flops: Optional[float] = None
             ) -> Optional[Tuple[Optional[float], Optional[float], Optional[float]]]:
        """Fold a measured wall-time window into the program's rates;
        returns ``(flops_folded, mfu, achieved_flops_per_sec)`` (entries
        None when the program has no FLOP count), or None for unknown
        labels / degenerate windows. ``flops``, when given, is the window's
        own FLOP count and wins over the hints."""
        if wall_s <= 0 or steps <= 0:
            return None
        with self._lock:
            rec = self._programs.get(label)
            if rec is None:
                return None
            tokens_per_step = (tokens / steps) if tokens else None
            step_flops = rec.step_flops(tokens_per_step)
            rec.calls += 1
            rec.steps += int(steps)
            rec.tokens += int(tokens or 0)
            rec.device_seconds += float(wall_s)
            rec.last_step_wall_s = wall_s / steps
            if flops is None:
                if step_flops is None:
                    return (None, None, None)
                flops = step_flops * steps
            achieved = flops / wall_s
            mfu = None
            if rec.peak_flops_per_sec:
                mfu = achieved / rec.peak_flops_per_sec
                rec.last_mfu = mfu
            rec.last_flops_per_sec = achieved
            return (flops, mfu, achieved)

    def note_memory(self, label: str, memory: Dict[str, int]) -> None:
        with self._lock:
            rec = self._programs.get(label)
            if rec is not None:
                rec.memory.update(memory)

    def note_hbm(self, device: str, stats: Dict[str, Optional[float]]) -> None:
        with self._lock:
            self._hbm[device] = dict(stats)

    def add_overhead(self, ns: int) -> None:
        with self._lock:
            self.overhead_ns += int(ns)

    def device_of(self, label: str) -> Any:
        """The torch device ``label`` runs on (None: unknown or not given)."""
        with self._lock:
            rec = self._programs.get(label)
            return rec.device if rec is not None else None

    # --- read surfaces ----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            programs = {k: r.as_dict() for k, r in self._programs.items()}
            hbm = {k: dict(v) for k, v in self._hbm.items()}
            overhead_ns = self.overhead_ns
        return {
            "programs": programs,
            "hbm": hbm,
            "overhead_ms": round(overhead_ns / 1e6, 3),
        }


# --- process-wide singletons --------------------------------------------------
_REGISTRY = CompiledProgramRegistry()
_SAMPLER: Optional["HbmSampler"] = None
_sampler_lock = threading.Lock()


def get_registry() -> CompiledProgramRegistry:
    return _REGISTRY


def device_kind(device=None) -> str:
    """The device-kind string the peak table matches: the card's name for
    a CUDA device (``torch.cuda.get_device_name``), ``"cpu"`` for the CPU;
    with no device, the current card's name if there is one."""
    import torch

    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def instrument(fn: Callable, label: str, *, n_devices: int = 1,
               flops_hint: Optional[float] = None,
               flops_per_token_hint: Optional[float] = None,
               device=None, dtype="bfloat16") -> Callable:
    """Register ``fn`` as program ``label`` on ``device`` computing in
    ``dtype`` and return it unchanged: there is no compiled executable to
    capture, so later calls cost nothing here. Re-instrumenting a label
    updates its hints, device and peak."""
    if not enabled():
        return fn
    t0 = time.perf_counter_ns()
    reg = get_registry()
    reg.register(label, n_devices=n_devices, flops_hint=flops_hint,
                 flops_per_token_hint=flops_per_token_hint)
    reg.note_capture(label, device_kind=device_kind(device), dtype=dtype, device=device)
    reg.add_overhead(time.perf_counter_ns() - t0)
    return fn


def _memory_of(label: str) -> Optional[Dict[str, int]]:
    """The card's allocated bytes now and at their peak, for a program on a
    CUDA device; reading the peak does not reset it."""
    dev = get_registry().device_of(label)
    if dev is None:
        return None
    import torch

    dev = torch.device(dev)
    if dev.type != "cuda":
        return None
    return {"allocated_bytes": int(torch.cuda.memory_allocated(dev)),
            "peak_allocated_bytes": int(torch.cuda.max_memory_allocated(dev))}


def observe_step(label: str, wall_s: float, *, steps: int = 1,
                 tokens: Optional[int] = None,
                 flops: Optional[float] = None) -> Optional[float]:
    """Fold a measured wall-time for ``steps`` executions of ``label`` into
    the registry and the metric surfaces; returns the resulting MFU (None
    when unknown program / no FLOP count / disabled). ``flops`` is the
    window's analytic FLOP count where no hint fits (the decode steps)."""
    if not enabled():
        return None
    t0 = time.perf_counter_ns()
    reg = get_registry()
    out = reg.fold(label, wall_s, steps, tokens, flops)
    mfu = None
    if out is not None:
        flops_done, mfu, _achieved = out
        t = get_telemetry()
        t.counter("program.steps." + label).add(int(steps))
        if flops_done is not None:
            t.counter("program.flops." + label).add(float(flops_done))
        if mfu is not None:
            store = tsdb.active()
            if store is not None:
                store.record_gauge("devperf.mfu." + label, float(mfu))
        memory = _memory_of(label)
        if memory:
            reg.note_memory(label, memory)
    reg.add_overhead(time.perf_counter_ns() - t0)
    return mfu


def observe_window(label: str, wall_s: float, steps: int, *,
                   tokens: Optional[int] = None,
                   flops: Optional[float] = None) -> Optional[float]:
    """Window form of :func:`observe_step`: a whole measured train/decode
    window of ``steps`` executions (the trainer's ``llm.train`` span)."""
    return observe_step(label, wall_s, steps=steps, tokens=tokens, flops=flops)


# --- HBM sampler --------------------------------------------------------------

def device_memory_stats() -> List[Tuple[str, Dict[str, Optional[float]]]]:
    """(device_label, stats) for every card this process has initialised;
    nothing on the CPU or before CUDA is initialised (``memory_stats``
    would otherwise start a context)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    out: List[Tuple[str, Dict[str, Optional[float]]]] = []
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i) or {}
        limit = torch.cuda.get_device_properties(i).total_memory
        if not limit:
            limit = device_specs.device_hbm_bytes(torch.cuda.get_device_name(i))
        out.append((f"cuda:{i}", {
            "bytes_in_use": st.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": st.get("allocated_bytes.all.peak"),
            "bytes_limit": limit,
        }))
    return out


class HbmSampler:
    """Fixed-cadence device-memory sampler thread (live + high-water).

    ``stats_fn`` is injectable for tests and drills; the default reads every
    card's ``torch.cuda.memory_stats()``. ``start``/``stop`` are idempotent
    and ``stop`` joins the thread (no leak), within one sleep interval.
    """

    def __init__(self, interval_s: Optional[float] = None,
                 stats_fn: Optional[Callable[[], List[Tuple[str, Dict[str, Optional[float]]]]]] = None,
                 registry: Optional[CompiledProgramRegistry] = None):
        self.interval_s = float(interval_s if interval_s is not None
                                else os.environ.get(_ENV_HBM_INTERVAL, "1.0"))
        self._stats_fn = stats_fn or device_memory_stats
        self._reg = registry or get_registry()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="devperf-hbm", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.interval_s + 5.0)
            self._thread = None

    def sample_once(self) -> int:
        """One synchronous sweep (the thread's body). Returns devices
        sampled."""
        t0 = time.perf_counter_ns()
        stats = self._stats_fn()
        high_frac: Optional[float] = None
        for device, st in stats:
            self._reg.note_hbm(device, st)
            peak, limit = st.get("peak_bytes_in_use"), st.get("bytes_limit")
            if peak is not None and limit:
                frac = float(peak) / float(limit)
                high_frac = frac if high_frac is None else max(high_frac, frac)
        if high_frac is not None:
            store = tsdb.active()
            if store is not None:
                store.record_gauge("devperf.hbm_high_water_frac",
                                   float(high_frac))
        self.samples += 1
        self._reg.add_overhead(time.perf_counter_ns() - t0)
        return len(stats)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - the sampler must survive runtime hiccups
                log.debug("devperf: hbm sample failed", exc_info=True)
            self._stop.wait(self.interval_s)


def start_hbm_sampler(interval_s: Optional[float] = None) -> Optional[HbmSampler]:
    """Start (or reuse) the process-wide HBM sampler; None when disabled."""
    if not enabled():
        return None
    global _SAMPLER
    with _sampler_lock:
        if _SAMPLER is None:
            _SAMPLER = HbmSampler(interval_s=interval_s)
        sampler = _SAMPLER
    sampler.start()
    return sampler


def stop_hbm_sampler() -> None:
    global _SAMPLER
    with _sampler_lock:
        sampler = _SAMPLER
        _SAMPLER = None
    if sampler is not None:
        sampler.stop()


# --- surfaces -----------------------------------------------------------------

def snapshot() -> Dict[str, Any]:
    """The registry's full JSON-safe state."""
    snap = _REGISTRY.snapshot()
    with _sampler_lock:
        sampler = _SAMPLER
    snap["sampler"] = {
        "running": bool(sampler is not None and sampler.running),
        "samples": int(sampler.samples) if sampler is not None else 0,
        "interval_s": sampler.interval_s if sampler is not None else None,
    }
    snap["enabled"] = enabled()
    return snap


def statusz_snapshot() -> Dict[str, Any]:
    """The `/statusz` ``devperf`` section; empty when nothing was
    registered or sampled."""
    if not enabled():
        return {}
    snap = snapshot()
    if not snap["programs"] and not snap["hbm"]:
        return {}
    return snap


def prom_gauges() -> List[tuple]:
    """``fedml_device_*`` ride-along gauges for ``prom.render``."""
    if not enabled():
        return []
    snap = _REGISTRY.snapshot()
    out: List[tuple] = []
    for label in sorted(snap["programs"]):
        p = snap["programs"][label]
        if p.get("mfu") is not None:
            out.append(("device_mfu", {"program": label}, float(p["mfu"])))
        if p.get("achieved_flops_per_sec") is not None:
            out.append(("device_flops_per_sec", {"program": label},
                        float(p["achieved_flops_per_sec"])))
    for device in sorted(snap["hbm"]):
        h = snap["hbm"][device]
        if h.get("bytes_in_use") is not None:
            out.append(("device_hbm_bytes", {"device": device},
                        float(h["bytes_in_use"])))
        if h.get("peak_bytes_in_use") is not None:
            out.append(("device_hbm_high_water_bytes", {"device": device},
                        float(h["peak_bytes_in_use"])))
    return out


def reset() -> None:
    """Tests: stop the sampler and drop every registered program and
    watermark."""
    global _REGISTRY
    stop_hbm_sampler()
    _REGISTRY = CompiledProgramRegistry()
