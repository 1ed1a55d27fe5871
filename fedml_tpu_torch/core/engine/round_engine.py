"""The round loop and its strategies and sinks: the ported part of
``fedml_tpu/core/engine/round_engine.py``.

A front supplies a client-execution strategy and an aggregation sink; the
engine owns the loop: cohort sampling, the span taxonomy
(``fedavg.round`` > ``fedavg.sample`` / ``fedavg.client_train`` (one per
client, from the strategy) / ``fedavg.aggregate`` / ``fedavg.eval``), the
shared ``Context`` cohort, the eval cadence and the ``engine.rounds`` /
``engine.round_seconds`` series. Sampling reproduces the reference's
``np.random.seed(round_idx)`` + ``choice`` bit for bit.

Ported: ``sample_cohort``, ``sample_silos``, ``sample_from_pool``,
``eval_due``, ``RoundResult``, ``InProcessSequentialStrategy`` (the sp front,
with the FedNova, SCAFFOLD and Mime control state and payloads),
``GroupedSequentialStrategy`` and ``HookedAverageSink`` (the hierarchical sp
front), ``VmappedMegabatchStrategy`` and ``StackedBucketedSink`` (the
vmapped front), ``RemoteCommStrategy`` and ``run_local_round`` with its
chaos knobs (the cross-silo front, with its ``server.broadcast`` and
``client.train`` spans), ``AlgFrameSink``, ``RoundEngine.run`` with its
resume, checkpoint and finalize hooks, ``RoundCheckpointer`` (durable round
state and the SIGKILL drills), the async sinks over the FedBuff buffer and
the edge->regional->root tree (``AsyncSink``, ``AsyncBufferSink``,
``HierarchySink``, ``as_async_sink``), the uplink compressor's boundaries
(``compress_upload``, ``decompress_arrival``) and the shared round
services: ``RoundEngine.run`` activates the SLO engine (``front="engine"``,
one tick a round) and runs devperf's HBM sampler around its rounds, and
``flight_recorded`` is where fronts install the flight recorder. Not
ported yet (ROADMAP.md, Queue 1): the pipelined strategy, the link and
split-learning chaos knobs (asking for one raises) and the mlops
summaries.
"""

from __future__ import annotations

import abc
import logging
import os
import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...constants import (
    FEDML_FEDERATED_OPTIMIZER_FEDNOVA,
    FEDML_FEDERATED_OPTIMIZER_MIME,
    FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
)
from .. import telemetry as tel

log = logging.getLogger(__name__)

StateDict = Any


def sample_cohort(round_idx: int, client_num_in_total: int, client_num_per_round: int) -> List[int]:
    """Bit-exact mirror of the reference's ``_client_sampling``
    (fedavg_api.py:127): the full cohort when the pool fits, else
    ``np.random.seed(round_idx)`` + ``np.random.choice`` without replacement."""
    if client_num_in_total == client_num_per_round:
        client_indexes: Sequence[int] = [i for i in range(client_num_in_total)]
    else:
        num_clients = min(client_num_per_round, client_num_in_total)
        np.random.seed(round_idx)
        client_indexes = np.random.choice(range(client_num_in_total), num_clients, replace=False)
    log.info("client_indexes = %s", client_indexes)
    return list(client_indexes)


def sample_silos(round_idx: int, client_num_in_total: int, client_num_per_round: int) -> List[int]:
    """Silo-index variant (reference fedml_aggregator.data_silo_selection):
    when every silo participates the ordered range is returned — note the
    ``>=`` guard, unlike :func:`sample_cohort`'s ``==``."""
    if client_num_per_round >= client_num_in_total:
        return list(range(client_num_in_total))
    np.random.seed(round_idx)
    return list(np.random.choice(range(client_num_in_total), client_num_per_round, replace=False))


def sample_from_pool(round_idx: int, client_id_list_in_total: Sequence[Any], client_num_per_round: int) -> List[Any]:
    """Sample concrete client ids from an explicit pool (reference
    fedml_aggregator.client_selection; ``>=`` guard like :func:`sample_silos`
    so an over-provisioned round returns the whole pool)."""
    if client_num_per_round >= len(client_id_list_in_total):
        return list(client_id_list_in_total)
    np.random.seed(round_idx)
    return list(np.random.choice(client_id_list_in_total, client_num_per_round, replace=False))


def eval_due(round_idx: int, comm_round: int, frequency_of_the_test: int) -> bool:
    """The sp cadence: always on the final round, else every ``freq`` rounds."""
    freq = int(frequency_of_the_test)
    return round_idx == comm_round - 1 or (freq > 0 and round_idx % freq == 0)


@dataclass
class RoundResult:
    """What one round of client execution produced, in whichever of the two
    shapes the fronts use: per-client ``(weight, state dict)`` pairs, or a
    stacked megabatch ``(stacked state dict, normalised weights)`` whose
    leaves carry a leading client axis."""

    pairs: Optional[List[Tuple[float, StateDict]]] = None
    stacked: Optional[Tuple[StateDict, Any]] = None

    @property
    def k(self) -> int:
        if self.pairs is not None:
            return len(self.pairs)
        if self.stacked is not None:
            return len(self.stacked[1])
        return 0


class ClientExecutionStrategy(abc.ABC):
    """How a cohort's local training happens for one round."""

    name: str = "strategy"

    @abc.abstractmethod
    def run_round(self, round_idx: int, w_global: StateDict, cohort: Sequence[int]) -> RoundResult:
        ...


class InProcessSequentialStrategy(ClientExecutionStrategy):
    """The sp front: one ``Client`` object per slot, trained in-process one
    after the other, one ``fedavg.client_train`` span per client; the
    optimizer's server state pushed into the trainer before each local run
    (SCAFFOLD's control variate, Mime's server momentum), and the trainer's
    structured round payload (FedNova, SCAFFOLD, Mime) taken in place of the
    weights."""

    name = "in_process_sequential"

    def __init__(self, api: Any):
        self.api = api

    def run_round(self, round_idx: int, w_global: StateDict, cohort: Sequence[int]) -> RoundResult:
        api = self.api
        w_locals: List[Tuple[float, StateDict]] = []
        for idx, client in enumerate(api.client_list):
            client_idx = cohort[idx]
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
            with tel.span("fedavg.client_train", round=round_idx, client=int(client_idx)):
                w = client.train(w_global)
            payload = getattr(api.model_trainer, "round_payload", None)
            if api.fed_opt in (
                FEDML_FEDERATED_OPTIMIZER_FEDNOVA,
                FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
                FEDML_FEDERATED_OPTIMIZER_MIME,
            ) and payload is not None:
                w_locals.append((client.get_sample_number(), payload))
            else:
                w_locals.append((client.get_sample_number(), w))
        return RoundResult(pairs=w_locals)


class GroupedSequentialStrategy(ClientExecutionStrategy):
    """Hierarchical FL: partition the sampled cohort by group, run an inner
    FedAvg (``group_comm_round`` rounds) per group, return one state dict per
    group weighted by the group's sample count."""

    name = "grouped_sequential"

    def __init__(self, api: Any):
        self.api = api

    def run_round(self, round_idx: int, w_global: StateDict, cohort: Sequence[int]) -> RoundResult:
        api = self.api
        group_to_clients: Dict[int, List[int]] = {}
        for ci in cohort:
            group_to_clients.setdefault(int(api.group_indexes[ci]), []).append(int(ci))
        log.info("client_indexes of each group = %s", group_to_clients)
        pairs: List[Tuple[float, StateDict]] = []
        for gidx in sorted(group_to_clients):
            pairs.append(api._group_train(group_to_clients[gidx], w_global))
        return RoundResult(pairs=pairs)


class VmappedMegabatchStrategy(ClientExecutionStrategy):
    """The vmapped front: the cohort's shards stacked into one megabatch and
    every client's local round run as one client-batched program; weights are
    the per-client sample counts normalised in f32 numpy, and the clients'
    dropout draws come from the round index."""

    name = "vmapped_megabatch"

    def __init__(self, api: Any):
        self.api = api

    def run_round(self, round_idx: int, w_global: StateDict, cohort: Sequence[int]) -> RoundResult:
        api = self.api
        # the span holds the staging, as the sp front's holds each client's copies
        with tel.span("fedavg.client_train", round=round_idx, clients=len(cohort)):
            x, y, idx, mask = api._stack_clients(list(cohort))
            result = api._vmapped_train(w_global, x, y, idx, mask, round_idx)
        counts = np.asarray([api.train_data_local_num_dict[i] for i in cohort], dtype=np.float32)
        weights = counts / counts.sum()
        return RoundResult(stacked=(result.params, weights))


class RemoteCommStrategy(ClientExecutionStrategy):
    """Cross-silo: clients live behind a comm backend. The server half uses
    :meth:`broadcast` inside a ``server.broadcast`` span to push the global
    model; arrivals flow back through the comm manager's message handlers,
    so there is no blocking ``run_round`` (the JAX package's ``collect_fn``
    variant has no caller)."""

    name = "remote_comm"

    def __init__(self, send_fn: Callable[..., None]):
        self._send_fn = send_fn

    def broadcast(self, round_idx: int, w_global: StateDict, receiver_ids: Sequence[Any],
                  silo_indexes: Sequence[Any]) -> None:
        with tel.span("server.broadcast", round=int(round_idx), receivers=len(receiver_ids)):
            for idx, receiver_id in enumerate(receiver_ids):
                self._send_fn(receiver_id, w_global, silo_indexes[idx])

    def run_round(self, round_idx: int, w_global: StateDict, cohort: Sequence[int]) -> RoundResult:
        raise RuntimeError(
            "RemoteCommStrategy is broadcast-only: arrivals fold through the comm "
            "manager's handlers, not a blocking round loop")


def middleware_wants_client_trees() -> bool:
    """True when a model attack, a defense or DP is on: the clients' state
    dicts must go through the alg-frame hooks one by one instead of the
    fused stacked fold (JAX ``round_engine.py:271-284``)."""
    from ..dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from ..security.fedml_attacker import FedMLAttacker
    from ..security.fedml_defender import FedMLDefender

    return (FedMLAttacker.get_instance().is_model_attack()
            or FedMLDefender.get_instance().is_defense_enabled()
            or FedMLDifferentialPrivacy.get_instance().is_dp_enabled())


class AggregationSink(abc.ABC):
    """Where one round's client results fold into the next global model."""

    name: str = "sink"

    @abc.abstractmethod
    def fold(self, round_idx: int, w_global: StateDict, result: RoundResult) -> StateDict:
        ...


class AlgFrameSink(AggregationSink):
    """Delegate to the front's per-algorithm server rule (the sp
    ``_server_update``: alg-frame hooks, the fold, the FedOpt step)."""

    name = "alg_frame"

    def __init__(self, update_fn: Callable[[StateDict, List[Tuple[float, StateDict]]], StateDict]):
        self._update_fn = update_fn

    def fold(self, round_idx: int, w_global: StateDict, result: RoundResult) -> StateDict:
        return self._update_fn(w_global, result.pairs or [])


class HookedAverageSink(AggregationSink):
    """Plain hooks and the sample-weighted average (the hierarchical front's
    group fold: no FedOpt step, no contribution assessment)."""

    name = "hooked_average"

    def __init__(self, aggregator: Any):
        self._agg = aggregator

    def fold(self, round_idx: int, w_global: StateDict, result: RoundResult) -> StateDict:
        lst = self._agg.on_before_aggregation(result.pairs or [])
        new_w = self._agg.aggregate(lst)
        return self._agg.on_after_aggregation(new_w)


class StackedBucketedSink(AggregationSink):
    """The vmapped front's fold: the stacked megabatch goes straight into
    the bucketed engine's fused ``aggregate_stacked`` unless an attack,
    defense, DP or contribution middleware needs the clients one by one;
    then they are unstacked (views of the stack, weights the normalised
    fractions) and run through the hook pipeline (JAX
    ``round_engine.py:326-356``). The after-aggregation hook runs on both
    branches. Contribution is assessed after the fold, as on the sp front
    (JAX's vmapped front never assesses it; ROADMAP.md, Queue 3, R9)."""

    name = "stacked_bucketed"

    def __init__(self, aggregator: Any):
        self._agg = aggregator

    def fold(self, round_idx: int, w_global: StateDict, result: RoundResult) -> StateDict:
        from ..aggregation.bucketed import get_engine

        stacked, weights = result.stacked
        contribution = bool(getattr(self._agg.args, "enable_contribution", False))
        if self._agg.enable_hooks and (middleware_wants_client_trees() or contribution):
            w_locals = [(float(weights[k]), {name: v[k] for name, v in stacked.items()})
                        for k in range(len(weights))]
            lst = self._agg.on_before_aggregation(w_locals)
            new_w = self._agg.aggregate(lst)
        else:
            new_w = get_engine().aggregate_stacked(stacked, weights)
        new_w = self._agg.on_after_aggregation(new_w)
        if contribution:
            self._agg.assess_contribution()
        return new_w


# ---------------------------------------------------------------------------
# async sinks: one facade over the FedBuff buffer
# ---------------------------------------------------------------------------

class AsyncSink(abc.ABC):
    """Barrier-free fold-at-arrival endpoint: the async driver and the
    cross-silo async path submit arrivals and poll for publishes through
    this facade."""

    name: str = "async_sink"
    raw: Any = None

    @abc.abstractmethod
    def submit(self, rank: int, tree: StateDict, weight: float, client_version: int) -> str:
        """Fold one arrival; returns the staleness verdict string."""

    @abc.abstractmethod
    def try_publish(self) -> Optional[Tuple[int, StateDict]]:
        """``(new_version, model)`` if a publish happened, else None."""

    @property
    @abc.abstractmethod
    def version(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def publish_k(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def high_water(self) -> int:
        ...

    def statusz(self) -> Dict[str, Any]:
        return self.raw.statusz() if hasattr(self.raw, "statusz") else {}


class AsyncBufferSink(AsyncSink):
    """The flat FedBuff buffer: a publish when ``publish_k`` merges have
    accumulated."""

    name = "async_buffer"

    def __init__(self, buffer: Any):
        self.raw = buffer

    def submit(self, rank: int, tree: StateDict, weight: float, client_version: int) -> str:
        return self.raw.submit(rank, tree, weight, client_version)

    def try_publish(self) -> Optional[Tuple[int, StateDict]]:
        if not self.raw.ready():
            return None
        model = self.raw.publish()
        if model is None:
            return None
        return int(self.raw.version), model

    @property
    def version(self) -> int:
        return int(self.raw.version)

    @property
    def publish_k(self) -> int:
        return int(self.raw.publish_k)

    @property
    def high_water(self) -> int:
        return int(self.raw.depth_high_water)


class HierarchySink(AsyncSink):
    """Edge→regional→root tree: edges publish upward on their own cadence,
    so a root publish is detected by watching the root version move."""

    name = "hierarchy"

    def __init__(self, tree: Any):
        self.raw = tree
        self._last_seen_version = int(tree.version)

    def submit(self, rank: int, tree: StateDict, weight: float, client_version: int) -> str:
        return self.raw.submit(rank, tree, weight, client_version)

    def try_publish(self) -> Optional[Tuple[int, StateDict]]:
        v = int(self.raw.version)
        if v == self._last_seen_version:
            return None
        self._last_seen_version = v
        model = self.raw.latest_model()
        if model is None:
            return None
        return v, model

    @property
    def version(self) -> int:
        return int(self.raw.version)

    @property
    def publish_k(self) -> int:
        return int(self.raw.edges[0].buffer.publish_k)

    @property
    def high_water(self) -> int:
        return max(int(n.buffer.depth_high_water) for n in self.raw.nodes())


def as_async_sink(sink: Any) -> AsyncSink:
    """Wrap a raw ``AsyncAggBuffer`` / ``HierarchyTree`` (or pass an
    :class:`AsyncSink` through untouched)."""
    if isinstance(sink, AsyncSink):
        return sink
    from ..distributed.hierarchy import HierarchyTree

    if isinstance(sink, HierarchyTree):
        return HierarchySink(sink)
    return AsyncBufferSink(sink)


class RoundCheckpointer:
    """The one implementation of round-boundary durability, shared by the sp
    front and the cross-silo server (the JAX package's, semantics kept so
    the SIGKILL-resume drills hold bit-identical stores):

    - the final round (and the chaos kills) drain in-flight async saves
      first, then save with ``wait=True``: the last round must be durable,
      never best-effort; the chaos drill models "watermark at k-1, round k
      torn";
    - sync mode steps the store by ``round_idx``; async mode keeps its own
      monotone step counter (mid-window checkpoints outnumber rounds) and
      persists the buffer's tensor state and meta sidecar next to the model;
    - ``chaos_kill_after_round`` / ``chaos_kill_after_merges`` SIGKILL the
      process right after the checkpoint enqueue (or the commit).
    """

    def __init__(self, store: Any, args: Any, *, async_mode: bool = False):
        self.store = store
        self.args = args
        self.async_mode = bool(async_mode)
        latest = store.latest_complete_round()
        self._ckpt_step = (int(latest) + 1) if latest is not None else 0

    def wait(self) -> None:
        self.store.wait()

    def save(
        self,
        round_idx: int,
        state: Dict[str, Any],
        *,
        cohort: Sequence[int] = (),
        health: Any = None,
        extra_meta: Optional[Dict[str, Any]] = None,
        final: bool = False,
        async_buffer: Any = None,
    ) -> None:
        kill_after = getattr(self.args, "chaos_kill_after_round", None)
        kill_now = kill_after is not None and int(round_idx) == int(kill_after)
        kill_after_merges = getattr(self.args, "chaos_kill_after_merges", None)
        kill_committed = False

        meta: Optional[Dict[str, Any]] = dict(extra_meta) if extra_meta is not None else None
        step = int(round_idx)
        if self.async_mode and async_buffer is not None:
            # async saves happen mid-window too (same FL round, newer buffer
            # contents), so the step is a monotone save counter and the FL
            # round travels in the meta; the buffer snapshot carries the
            # partial accumulator, the pending arrivals and the staleness clock
            state = dict(state)
            bstate = async_buffer.export_pytree_state()
            if bstate:
                state["async_buffer"] = bstate
            meta = dict(meta or {})
            meta["async_buffer"] = async_buffer.export_meta()
            meta["fl_round_idx"] = int(round_idx)
            step = self._ckpt_step
            self._ckpt_step += 1
            # async drill: SIGKILL right after the Nth merge's snapshot
            # COMMITS, so resume must rebuild a non-empty buffer
            if kill_after_merges is not None \
                    and int(async_buffer.merges_total) == int(kill_after_merges):
                kill_committed = True

        if final or kill_now or kill_committed:
            # drain any in-flight async save so this one cannot be dropped
            self.store.wait()
        self.store.save_round(
            step,
            state,
            cohort=[int(c) for c in cohort],
            health=health,
            extra_meta=meta,
            wait=final or kill_committed,
        )
        if kill_now or kill_committed:
            log.warning("chaos: SIGKILL self after round %d checkpoint enqueue", round_idx)
            os.kill(os.getpid(), signal.SIGKILL)


class RoundEngine:
    """The synchronous round loop, once. ``resume_fn(w_global) -> (w_global,
    start_round)`` runs before the first round, ``checkpoint_fn(round_idx,
    w_global, cohort, final)`` after each round's install and
    ``finalize_fn(w_global)`` after the last round."""

    def __init__(
        self,
        args: Any,
        strategy: ClientExecutionStrategy,
        sink: AggregationSink,
        *,
        sample_fn: Callable[[int], List[int]],
        install_fn: Callable[[StateDict], None],
        eval_fn: Callable[[int], Optional[Dict[str, float]]],
        resume_fn: Optional[Callable[[StateDict], Tuple[StateDict, int]]] = None,
        checkpoint_fn: Optional[Callable[[int, StateDict, List[int], bool], None]] = None,
        finalize_fn: Optional[Callable[[StateDict], None]] = None,
        round_span_attrs: Optional[Dict[str, Any]] = None,
        metrics_history: Optional[List[Dict[str, float]]] = None,
    ):
        self.args = args
        self.strategy = strategy
        self.sink = sink
        self.sample_fn = sample_fn
        self.install_fn = install_fn
        self.eval_fn = eval_fn
        self.resume_fn = resume_fn
        self.checkpoint_fn = checkpoint_fn
        self.finalize_fn = finalize_fn
        self.round_span_attrs = dict(round_span_attrs or {})
        self.metrics_history = metrics_history if metrics_history is not None else []

    def run(self, w_global: StateDict) -> StateDict:
        from ..alg_frame.context import Context
        from ..telemetry import devperf, slo

        comm_round = int(getattr(self.args, "comm_round", 10))
        start_round = 0
        if self.resume_fn is not None:
            w_global, start_round = self.resume_fn(w_global)
        freq = int(getattr(self.args, "frequency_of_the_test", 5))
        slo_engine = slo.activate(self.args, front="engine")
        devperf.start_hbm_sampler()
        try:
            for round_idx in range(start_round, comm_round):
                log.info("================ Communication round : %d", round_idx)
                t0 = time.perf_counter()
                with tel.span("fedavg.round", round=round_idx, **self.round_span_attrs):
                    with tel.span("fedavg.sample", round=round_idx):
                        cohort = self.sample_fn(round_idx)
                    Context().add("client_indexes_of_round", cohort)
                    result = self.strategy.run_round(round_idx, w_global, cohort)
                    with tel.span("fedavg.aggregate", round=round_idx, k=result.k):
                        w_global = self.sink.fold(round_idx, w_global, result)
                    self.install_fn(w_global)
                    if self.checkpoint_fn is not None:
                        self.checkpoint_fn(round_idx, w_global, cohort,
                                           round_idx == comm_round - 1)
                    if eval_due(round_idx, comm_round, freq):
                        with tel.span("fedavg.eval", round=round_idx):
                            metrics = self.eval_fn(round_idx)
                        if metrics is not None:
                            self.metrics_history.append(metrics)
                tel.counter("engine.rounds").add(1)
                tel.histogram("engine.round_seconds").observe(time.perf_counter() - t0)
                if slo_engine is not None:
                    slo_engine.maybe_tick()
        finally:
            devperf.stop_hbm_sampler()
            slo.deactivate(slo_engine)
        if self.finalize_fn is not None:
            self.finalize_fn(w_global)
        return w_global


def flight_recorded(role: str):
    """The one place fronts install the flight recorder (crash forensics:
    the last spans, comm events and marks, dumped on an unhandled error)."""
    from ..telemetry import flight_recorder

    return flight_recorder.installed(role=role)


def knob_set(v: Any) -> bool:
    """A knob counts as set unless it is None, False, 0, "" or "none"."""
    return v is not None and v is not False and not (isinstance(v, (int, float)) and v == 0) \
        and str(v).strip().lower() not in ("", "none")


def refuse_knobs(args: Any, checks: Sequence[Tuple[str, Callable[[Any], bool]]], what: str) -> None:
    """Raise NotImplementedError naming every knob of ``checks`` that
    ``args`` turns on (``(name, is_on)`` pairs); ``what`` says which feature
    they belong to."""
    on = [name for name, is_on in checks if is_on(getattr(args, name, None))]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: {what} not ported to fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")


# the chaos knobs whose subsystem is not ported: the split-learning kills and
# send failures
_DEFERRED_CHAOS_PREFIXES = ("chaos_split_",)


def refuse_chaos_knobs(args: Any) -> None:
    """Refuse the JAX package's fault-injection knobs that are not ported:
    the split-learning kills (``chaos_split_*``). The INMEMORY link throttle
    and delay (``chaos_link_throttle``, ``chaos_link_base_delay_s``), the
    straggler delay, scheduled raise, NaN poison, delta scaling, the SecAgg
    upload drop (``chaos_secagg_drop_upload_at_round``, the cross-silo
    client's) and the SIGKILL drills run."""
    refuse_knobs(args, [(k, lambda v: v is not None and v is not False)
                        for k in sorted(vars(args)) if k.startswith(_DEFERRED_CHAOS_PREFIXES)],
                 "the split-learning chaos knobs are")


def run_local_round(train_fn: Callable[[], Any], args: Any, round_idx: int, *,
                    rank: Any = None) -> Any:
    """Client-side local-round scaffolding: the ``client.train`` span plus
    the chaos knobs — ``chaos_train_delay_s`` (inflates the measured train
    time for straggler drills; only in rounds below
    ``chaos_train_delay_rounds`` when that is set), ``chaos_raise_at_round``
    (a scheduled failure exercising the crash path), ``chaos_nan_at_round``
    (NaN-poisons the trained weights at one round) and ``chaos_scale_delta``
    (multiplies the trained weights by a factor, every round or only at
    ``chaos_scale_at_round``)."""
    chaos_delay = float(getattr(args, "chaos_train_delay_s", 0) or 0)
    chaos_delay_rounds = getattr(args, "chaos_train_delay_rounds", None)
    if chaos_delay_rounds is not None and int(round_idx) >= int(chaos_delay_rounds):
        chaos_delay = 0.0  # recovery drill: stop straggling so alerts can resolve
    chaos_raise_at = getattr(args, "chaos_raise_at_round", None)
    with tel.span("client.train", round=int(round_idx)):
        if chaos_delay > 0:
            time.sleep(chaos_delay)  # chaos straggler injection, not a poll loop
        if chaos_raise_at is not None and int(chaos_raise_at) == int(round_idx):
            raise RuntimeError(f"chaos: injected failure at round {round_idx} on rank {rank}")
        out = train_fn()
    return _apply_delta_chaos(out, args, round_idx, rank)


def _apply_delta_chaos(out: Any, args: Any, round_idx: int, rank: Any) -> Any:
    """Poison or scale a trained-weights payload per the chaos knobs, as the
    JAX package does: NaN into the first element of each floating tensor,
    or each floating tensor times the factor in its own dtype. Handles both
    return conventions (a bare state dict, or ``(state dict, n_samples)``)."""
    nan_at = getattr(args, "chaos_nan_at_round", None)
    scale = float(getattr(args, "chaos_scale_delta", 0) or 0)
    scale_at = getattr(args, "chaos_scale_at_round", None)
    poison = nan_at is not None and int(nan_at) == int(round_idx)
    do_scale = scale not in (0.0, 1.0) and (
        scale_at is None or int(scale_at) == int(round_idx))
    if not poison and not do_scale:
        return out

    def _mutate(t):
        if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
            return t
        if poison:
            t = t.detach().clone(memory_format=torch.contiguous_format)
            t.view(-1)[0] = float("nan")
            return t
        return t * torch.tensor(scale, dtype=t.dtype, device=t.device)

    if isinstance(out, tuple) and len(out) == 2:
        weights, n = out
        result = ({k: _mutate(v) for k, v in weights.items()}, n)
    else:
        result = {k: _mutate(v) for k, v in out.items()}
    log.warning("chaos: %s trained weights at round %d on rank %s",
                "NaN-poisoned" if poison else f"scaled x{scale:g}", int(round_idx), rank)
    return result


def decompress_arrival(model_params: Any, sender_id: Any) -> Any:
    """Server-side arrival boundary: rehydrate a compressed uplink payload
    (identity for plain state dicts) under the ``server.decompress`` span."""
    from ...utils.compression import decompress_comm_payload, is_comm_payload

    if not is_comm_payload(model_params):
        return model_params
    with tel.span("server.decompress", sender=int(sender_id)):
        return decompress_comm_payload(model_params)


def compress_upload(compressor: Any, weights: Any) -> Any:
    """Client-side upload boundary: run the configured uplink compressor
    (its error feedback lives inside it) under the ``client.compress``
    span."""
    if compressor is None:
        return weights
    with tel.span("client.compress", kind=str(getattr(compressor, "kind", "?"))):
        return compressor.compress_tree(weights)
