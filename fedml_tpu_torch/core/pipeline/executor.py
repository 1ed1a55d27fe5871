"""Micro-batched pipelined stage executor (PiPar family).

A copy of ``fedml_tpu/core/pipeline/executor.py`` (framework-free), its
flight-recorder marks and trace-context activation included.

A client's local round is four serial phases — train, compress, uplink,
fold — and the wall-clock is their sum even though they use disjoint
resources (device compute, host CPU, the WAN link, the server). This
module runs the phases as *stages* on worker threads connected by bounded
FIFO queues, so stage ``k`` of work item ``i`` overlaps stage ``k-1`` of
item ``i+1``, and the round engine's ``PipelinedExecution`` strategy
(``core/pipeline/strategy.py``) rides this executor unchanged.

Work items are opaque: the sp strategy feeds one item per cohort client,
and the paged serving engine's admission wave (prefill -> transfer ->
admit) one item per admitted request.

Measured, not assumed: every stage books busy seconds (inside the stage
fn), stall seconds (blocked on an empty input or full output queue) and
queue depth high-water; :class:`PipelineReport` folds them into the
**overlap fraction** — of the overlap a perfect schedule could achieve
(serial sum minus the bottleneck stage), how much this run realized:

    overlap_frac = (serial_s - wall_s) / (serial_s - max_stage_busy_s)

clipped to [0, 1]; 0 means fully serial, 1 means the wall-clock collapsed
to the bottleneck stage. The ``pipeline_overlap_frac`` SLO fires when a
live pipeline collapses back to serial.

Telemetry: per-item ``pipeline.<stage>`` spans nest under the caller's
round trace (the captured trace context is re-activated on every worker),
``fedml_pipeline_*`` series export stage seconds / stalls / queue depth /
overlap, and the flight recorder gets one breadcrumb per run plus one per
stage drain. A stage that raises aborts the run: every worker stops, and
:meth:`PipelinedExecutor.run` raises :class:`PipelineError`.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

from .. import telemetry as tel
from ..telemetry import flight_recorder, trace_context

# one queue.get/put timeout slice: long enough to stay off the scheduler's
# back, short enough that an abort (failed stage) unblocks everyone fast
_POLL_S = 0.05

STAGE_SECONDS = "pipeline.stage_seconds"
STAGE_STALL_SECONDS = "pipeline.stage_stall_seconds"
QUEUE_DEPTH = "pipeline.queue_depth"
OVERLAP_FRAC = "pipeline.overlap_frac"
ITEMS_COUNTER = "pipeline.items"


class PipelineError(RuntimeError):
    """A stage function raised; carries the stage name and the original."""

    def __init__(self, stage: str, cause: BaseException):
        super().__init__(f"pipeline stage {stage!r} failed: {cause!r}")
        self.stage = stage
        self.cause = cause


@dataclass
class StageSpec:
    """One pipeline stage: a name (span + stats label) and a callable that
    transforms an item. ``maxsize`` bounds the queue feeding this stage —
    backpressure, not unbounded buffering, is what keeps memory flat."""

    name: str
    fn: Callable[[Any], Any]
    maxsize: int = 2


@dataclass
class StageStats:
    """Per-stage accounting, measured on the stage's worker thread."""

    name: str
    items: int = 0
    busy_s: float = 0.0
    stall_in_s: float = 0.0   # blocked on an empty input queue
    stall_out_s: float = 0.0  # blocked on a full downstream queue
    queue_high_water: int = 0

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "items": self.items,
            "busy_s": round(self.busy_s, 6),
            "stall_in_s": round(self.stall_in_s, 6),
            "stall_out_s": round(self.stall_out_s, 6),
            "queue_high_water": self.queue_high_water,
        }


@dataclass
class PipelineReport:
    """What one :meth:`PipelinedExecutor.run` measured."""

    outputs: List[Any]
    wall_s: float
    stages: List[StageStats] = field(default_factory=list)

    @property
    def serial_s(self) -> float:
        """What the same work would cost run serially: the stage busy sum."""
        return sum(s.busy_s for s in self.stages)

    @property
    def bottleneck(self) -> str:
        return max(self.stages, key=lambda s: s.busy_s).name if self.stages else ""

    @property
    def overlap_frac(self) -> float:
        """Realized fraction of the achievable overlap (see module doc)."""
        serial = self.serial_s
        achievable = serial - max((s.busy_s for s in self.stages), default=0.0)
        if achievable <= 1e-9:
            return 0.0
        frac = (serial - self.wall_s) / achievable
        return min(1.0, max(0.0, frac))

    def as_dict(self) -> dict:
        return {
            "wall_s": round(self.wall_s, 6),
            "serial_s": round(self.serial_s, 6),
            "overlap_frac": round(self.overlap_frac, 4),
            "bottleneck": self.bottleneck,
            "items": len(self.outputs),
            "stages": [s.as_dict() for s in self.stages],
        }


class _Done:
    """End-of-stream sentinel (one shared instance)."""


_DONE = _Done()


class PipelinedExecutor:
    """Run items through the stages on one worker thread per stage.

    FIFO discipline end to end: each stage is a single worker consuming a
    FIFO queue, so items leave the pipeline in exactly the order they were
    fed — aggregation order (and therefore float summation order) is
    bit-identical to the serial loop, which is what lets the sp strategy's
    fold-at-arrival stay bit-exact with synchronous FedAvg.

    One executor instance is single-use per :meth:`run` call but may be
    reused sequentially (stats reset each run). Worker threads are daemons
    named ``pipeline-<stage>`` and re-activate the trace context captured
    at :meth:`run` entry, so stage spans nest under the caller's round
    span even though they execute off-thread.
    """

    def __init__(self, stages: Sequence[StageSpec], *, name: str = "pipeline"):
        if not stages:
            raise ValueError("a pipeline needs at least one stage")
        self.name = str(name)
        self.stages = list(stages)

    # -- bounded-queue helpers that honor the abort flag -------------------
    def _get(self, q: "queue.Queue", abort: threading.Event) -> Any:
        while not abort.is_set():
            try:
                return q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
        return _DONE

    def _put(self, q: "queue.Queue", item: Any, abort: threading.Event) -> None:
        while not abort.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    def _worker(self, idx: int, q_in: "queue.Queue", q_out: Optional["queue.Queue"],
                outputs: List[Any], stats: StageStats, abort: threading.Event,
                errors: List[PipelineError], ctx: Any) -> None:
        spec = self.stages[idx]
        with trace_context.activated(ctx):
            while True:
                t0 = time.perf_counter()
                item = self._get(q_in, abort)
                stats.stall_in_s += time.perf_counter() - t0
                if item is _DONE:
                    break
                try:
                    t1 = time.perf_counter()
                    with tel.span(f"{self.name}.{spec.name}", item=stats.items):
                        out = spec.fn(item)
                    dt = time.perf_counter() - t1
                    stats.busy_s += dt
                    stats.items += 1
                    tel.histogram(STAGE_SECONDS).observe(dt)
                except BaseException as e:  # noqa: BLE001 - reported via PipelineError
                    errors.append(PipelineError(spec.name, e))
                    abort.set()
                    break
                if q_out is not None:
                    t2 = time.perf_counter()
                    self._put(q_out, out, abort)
                    stats.stall_out_s += time.perf_counter() - t2
                    stats.queue_high_water = max(stats.queue_high_water, q_out.qsize())
                else:
                    outputs.append(out)
            if q_out is not None:
                self._put(q_out, _DONE, abort)
        flight_recorder.record_event(
            "pipeline", f"{self.name}.{spec.name}.drained",
            items=stats.items, busy_s=round(stats.busy_s, 4),
            stall_s=round(stats.stall_in_s + stats.stall_out_s, 4))

    def run(self, items: Sequence[Any]) -> PipelineReport:
        """Feed ``items`` through every stage; block until drained.

        Raises :class:`PipelineError` (first failing stage) after unwinding
        every worker — a failed stage never leaves threads blocked on the
        bounded queues."""
        items = list(items)
        ctx = trace_context.current()
        abort = threading.Event()
        errors: List[PipelineError] = []
        outputs: List[Any] = []
        stats = [StageStats(name=s.name) for s in self.stages]
        queues: List["queue.Queue"] = [queue.Queue(maxsize=max(1, s.maxsize))
                                       for s in self.stages]
        flight_recorder.mark(f"{self.name}_run",
                             stages=[s.name for s in self.stages], items=len(items))
        workers = []
        for i, _spec in enumerate(self.stages):
            q_out = queues[i + 1] if i + 1 < len(self.stages) else None
            t = threading.Thread(
                target=self._worker,
                args=(i, queues[i], q_out, outputs, stats[i], abort, errors, ctx),
                name=f"pipeline-{self.stages[i].name}",
                daemon=True,
            )
            workers.append(t)
        t_start = time.perf_counter()
        for t in workers:
            t.start()
        feed_stats = stats[0]
        for item in items:
            t0 = time.perf_counter()
            self._put(queues[0], item, abort)
            feed_stats.queue_high_water = max(feed_stats.queue_high_water,
                                              queues[0].qsize())
            # feeder block time is the first stage's input-side backpressure
            feed_stats.stall_in_s += max(0.0, time.perf_counter() - t0 - _POLL_S)
        self._put(queues[0], _DONE, abort)
        for t in workers:
            t.join()
        wall = time.perf_counter() - t_start
        report = PipelineReport(outputs=outputs, wall_s=wall, stages=stats)
        for s in stats:
            tel.histogram(STAGE_STALL_SECONDS).observe(s.stall_in_s + s.stall_out_s)
            tel.histogram(QUEUE_DEPTH).observe(float(s.queue_high_water))
        if errors:
            flight_recorder.mark(f"{self.name}_failed", stage=errors[0].stage,
                                 cause=repr(errors[0].cause))
            raise errors[0]
        tel.counter(ITEMS_COUNTER).add(len(outputs))
        tel.histogram(OVERLAP_FRAC).observe(report.overlap_frac)
        flight_recorder.mark(f"{self.name}_done",
                             wall_s=round(wall, 4),
                             overlap_frac=round(report.overlap_frac, 4),
                             bottleneck=report.bottleneck)
        return report
