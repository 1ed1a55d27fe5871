"""``PipelinedExecution`` — the round engine's pipelined client strategy.

A copy of ``fedml_tpu/core/pipeline/strategy.py`` over the port's engine,
async buffer and state dicts. Drop-in replacement for
``InProcessSequentialStrategy``: the same per-client training body (dataset
swap, optimizer control state, ``fedavg.client_train`` span, structured
round payloads), but the cohort flows through a
:class:`~fedml_tpu_torch.core.pipeline.executor.PipelinedExecutor` so client
``i+1`` trains while client ``i``'s upload compresses, ships and folds. The
train stage is one worker thread, so the clients train in cohort order, one
at a time, on the trainer's device.

Two fold modes, chosen by :func:`build_pipelined_execution`:

- **fold-at-arrival** (plain FedAvg, no middleware): each arrival is
  decompressed and submitted straight into a per-round ``AsyncAggBuffer``
  with ``publish_k == len(cohort)`` and staleness exponent 0. Every
  submission carries the buffer's current version, so every weight is
  exactly ``sample_num``, the whole window stays pending in one engine
  bucket (a cohort up to the bucket size, 16 by default), and publish routes
  through ``engine.aggregate``, the bucketed fold ``AlgFrameSink``'s plain
  path runs: bit-exact with the sequential strategy.
- **pairs mode** (structured-payload optimizers, FedOpt's server state,
  active attack, defense or DP middleware, or FHE, whose ciphertext fold
  lives in the aggregator's hooks): train and compress still overlap, but
  results are collected as ordered ``(weight, state dict)`` pairs and the
  front's ``AlgFrameSink`` folds them, as the sequential round does.

The queue between compress and fold is sized by the link-cost planner
(:func:`~fedml_tpu_torch.core.pipeline.microbatch.plan_micro_batches`):
measured uplink cost against the EWMA of measured per-client train seconds
decides how much in-flight payload is worth buffering.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import telemetry as tel
from ..engine.round_engine import (
    AggregationSink,
    ClientExecutionStrategy,
    RoundResult,
    compress_upload,
    decompress_arrival,
)
from ..telemetry import flight_recorder
from .executor import PipelinedExecutor, StageSpec
from .microbatch import MicroBatchPlan, plan_micro_batches

StateDict = Dict[str, torch.Tensor]

# server comm rank for link-cost lookups; clients are 1-based comm ranks
_SERVER_RANK = 0


def _tree_nbytes(tree: StateDict) -> int:
    return int(sum(v.nbytes for v in tree.values()))


class PipelinedExecution(ClientExecutionStrategy):
    """Pipelined sp-front client execution (see module docstring)."""

    name = "pipelined"

    def __init__(
        self,
        api: Any,
        *,
        fold_at_arrival: bool = True,
        compressor: Any = None,
        uplink_fn: Optional[Callable[[int, Any], Any]] = None,
    ):
        self.api = api
        self.fold_at_arrival = bool(fold_at_arrival)
        self.compressor = compressor
        # optional wire stage (actually send the payload); identity
        # pass-through when the front is purely in-process
        self.uplink_fn = uplink_fn
        self.last_report = None
        self.last_plan: Optional[MicroBatchPlan] = None
        # EWMA of measured per-client train seconds: the planner's
        # compute-side input for next round's queue sizing
        self._train_s_ewma: Optional[float] = None
        # fold-at-arrival state handed to PipelinedBufferSink per round
        self._round_buffer: Any = None
        self._buffer_lock = threading.Lock()

    # -- per-client training body: mirrors InProcessSequentialStrategy ------
    def _train_one(self, round_idx: int, w_global: StateDict, client_idx: int,
                   slot_idx: int) -> Tuple[int, float, Any, bool]:
        from ...constants import (
            FEDML_FEDERATED_OPTIMIZER_FEDNOVA,
            FEDML_FEDERATED_OPTIMIZER_MIME,
            FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
        )

        api = self.api
        client = api.client_list[slot_idx]
        client.update_local_dataset(
            client_idx,
            api.train_data_local_dict[client_idx],
            api.test_data_local_dict[client_idx],
            api.train_data_local_num_dict[client_idx],
        )
        if api.fed_opt == FEDML_FEDERATED_OPTIMIZER_SCAFFOLD:
            api.model_trainer.set_control_variate(api._scaffold_c)
        elif api.fed_opt == FEDML_FEDERATED_OPTIMIZER_MIME:
            api.model_trainer.set_server_momentum(api._mime_s)
        t0 = time.perf_counter()
        with tel.span("fedavg.client_train", round=round_idx, client=int(client_idx)):
            w = client.train(w_global)
        dt = time.perf_counter() - t0
        self._train_s_ewma = dt if self._train_s_ewma is None \
            else 0.7 * self._train_s_ewma + 0.3 * dt
        payload = getattr(api.model_trainer, "round_payload", None)
        if api.fed_opt in (
            FEDML_FEDERATED_OPTIMIZER_FEDNOVA,
            FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
            FEDML_FEDERATED_OPTIMIZER_MIME,
        ) and payload is not None:
            # structured round payload ((a_i, d_i) / (dw, dc) / (w, grad)):
            # never compressed — the weight-space compressors take state dicts
            return int(client_idx), float(client.get_sample_number()), payload, True
        return int(client_idx), float(client.get_sample_number()), w, False

    def _plan(self, w_global: StateDict, cohort: Sequence[int]) -> MicroBatchPlan:
        """Size the compress->fold queue from measured link + train costs."""
        plan = plan_micro_batches(
            max(1, _tree_nbytes(w_global)),
            self._train_s_ewma or 0.0,
            src=1, dst=_SERVER_RANK,
            min_chunks=1, max_chunks=max(2, len(cohort)), default_chunks=2,
        )
        self.last_plan = plan
        flight_recorder.record_event("pipeline", "microbatch_plan", **plan.as_dict())
        return plan

    def run_round(self, round_idx: int, w_global: StateDict,
                  cohort: Sequence[int]) -> RoundResult:
        plan = self._plan(w_global, cohort)
        queue_depth = max(1, min(len(cohort), plan.n_micro_batches))

        def train_stage(item: Tuple[int, int]) -> Tuple[int, float, Any, bool]:
            slot_idx, client_idx = item
            return self._train_one(round_idx, w_global, client_idx, slot_idx)

        def compress_stage(item: Tuple[int, float, Any, bool]) -> Tuple[int, float, Any]:
            cidx, n, w, is_structured = item
            if not is_structured:
                w = compress_upload(self.compressor, w)
            return cidx, n, w

        def uplink_stage(item: Tuple[int, float, Any]) -> Tuple[int, float, Any]:
            cidx, n, w = item
            if self.uplink_fn is not None:
                w = self.uplink_fn(cidx, w)
            return cidx, n, w

        if self.fold_at_arrival:
            buffer = self._make_round_buffer(len(cohort))

            def fold_stage(item: Tuple[int, float, Any]) -> Tuple[int, float]:
                cidx, n, w = item
                tree = decompress_arrival(w, cidx)
                # version == buffer.version => staleness 0 => weight is
                # exactly sample_num: the bit-exact FedAvg precondition
                buffer.submit(cidx, tree, n, client_version=buffer.version)
                return cidx, n
        else:
            ordered: List[Tuple[float, Any]] = []

            def fold_stage(item: Tuple[int, float, Any]) -> Tuple[int, float]:
                cidx, n, w = item
                ordered.append((n, decompress_arrival(w, cidx)))
                return cidx, n

        stages = [
            StageSpec("train", train_stage, maxsize=1),
            StageSpec("compress", compress_stage, maxsize=queue_depth),
            StageSpec("uplink", uplink_stage, maxsize=queue_depth),
            StageSpec("fold", fold_stage, maxsize=queue_depth),
        ]
        executor = PipelinedExecutor(stages, name="pipeline")
        report = executor.run(list(enumerate(int(c) for c in cohort)))
        self.last_report = report
        if self.fold_at_arrival:
            # pairs stay None: PipelinedBufferSink publishes the buffer
            return RoundResult(pairs=None)
        return RoundResult(pairs=ordered)

    # -- fold-at-arrival plumbing shared with PipelinedBufferSink ----------
    def _make_round_buffer(self, cohort_size: int) -> Any:
        from ..aggregation.async_buffer import AsyncAggBuffer, StalenessPolicy

        buffer = AsyncAggBuffer(
            publish_k=max(1, int(cohort_size)),
            policy=StalenessPolicy(exponent=0.0),
        )
        with self._buffer_lock:
            self._round_buffer = buffer
        return buffer

    def take_round_buffer(self) -> Any:
        with self._buffer_lock:
            buffer, self._round_buffer = self._round_buffer, None
        return buffer


class PipelinedBufferSink(AggregationSink):
    """Publish the strategy's per-round fold-at-arrival buffer.

    ``fold`` runs inside the engine's ``<prefix>.aggregate`` span after the
    strategy drained its pipeline, so every cohort submission has already
    merged; publish is the bucketed engine's normalize-first path, then the
    aggregator's after-hooks and contribution assessment run as
    ``AlgFrameSink``'s plain path runs them (identity unless middleware is
    on, and middleware routes to pairs mode instead)."""

    name = "pipelined_buffer"

    def __init__(self, strategy: PipelinedExecution, aggregator: Any = None):
        self._strategy = strategy
        self._agg = aggregator

    def fold(self, round_idx: int, w_global: StateDict, result: RoundResult) -> StateDict:
        buffer = self._strategy.take_round_buffer()
        if buffer is None:
            raise RuntimeError(
                "PipelinedBufferSink.fold without a round buffer: the strategy "
                "must run in fold_at_arrival mode under the same engine")
        new_w = buffer.publish()
        if new_w is None:  # zero merges (empty cohort): keep the old model
            return w_global
        if self._agg is not None:
            new_w = self._agg.on_after_aggregation(new_w)
            self._agg.assess_contribution()
        return new_w


def build_pipelined_execution(api: Any) -> Tuple[PipelinedExecution, AggregationSink]:
    """Pick the fold mode for the sp front (see module docstring) and return
    the matched ``(strategy, sink)`` pair for ``RoundEngine``."""
    from ...constants import (
        FEDML_FEDERATED_OPTIMIZER_FEDDYN,
        FEDML_FEDERATED_OPTIMIZER_FEDNOVA,
        FEDML_FEDERATED_OPTIMIZER_MIME,
        FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
    )
    from ...utils.compression import make_comm_compressor
    from ..engine.round_engine import AlgFrameSink, middleware_wants_client_trees
    from ..fhe.fhe_agg import FedMLFHE

    structured = api.fed_opt in (
        FEDML_FEDERATED_OPTIMIZER_FEDNOVA,
        FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
        FEDML_FEDERATED_OPTIMIZER_MIME,
        FEDML_FEDERATED_OPTIMIZER_FEDDYN,
    )
    fold_at_arrival = (
        not structured
        and getattr(api, "_fedopt_server", None) is None
        and not middleware_wants_client_trees()
        and not FedMLFHE.get_instance().is_fhe_enabled()
    )
    compressor = make_comm_compressor(api.args)
    strategy = PipelinedExecution(
        api, fold_at_arrival=fold_at_arrival, compressor=compressor)
    if fold_at_arrival:
        sink: AggregationSink = PipelinedBufferSink(strategy, api.aggregator)
    else:
        sink = AlgFrameSink(api._server_update)
    return strategy, sink
