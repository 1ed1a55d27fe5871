"""Event-driven asynchronous FL simulation with batched delta generation:
counterpart of ``fedml_tpu/simulation/vmapped/async_driver.py``.

A discrete-event loop advances a virtual clock over per-client completion
events (heterogeneous delays), folds each arrival into an
:class:`~fedml_tpu_torch.core.aggregation.async_buffer.AsyncAggBuffer` and
lets the buffer publish every ``publish_k`` merges. The server's cost a
publish is O(publish_k) whatever the number of clients in flight.

Delta generation is lazy and batched: a dispatch records only ``(client,
model_version)``; when the loop first needs a delta it generates the deltas
of up to ``gen_batch`` pending dispatches that share that model version in
one call of ``train_batch`` (the model is the same inside a version group,
so the client axis batches as in the synchronous vmapped simulator). Memory
stays O(gen_batch x model + versions in flight x model).

Event order is exact (arrivals in virtual-time order, one submit at a time,
staleness judged against the live version); batching only reorders the
generation, which a delta pure in (client, model version) does not see.
:func:`make_synthetic_delta_fn` is pure in (client, version): each client's
noise comes from a ``torch.Generator`` seeded from ``(seed, client,
version)``, where the JAX package folds both into a PRNG key. The vmapped
API's deltas are the client-batched local rounds, whose dropout draws
(``make_vmapped_local_train_fn``) come from the version, not the client.

``simulate_async_rounds(hierarchy_edges=E)`` drives an edge->regional->root
:class:`~...core.distributed.hierarchy.HierarchyTree` of ``E`` edges instead
of one buffer, on the template's device.
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core.aggregation.async_buffer import AsyncAggBuffer, buffer_from_args
from ...core.aggregation.bucketed import get_engine
from ...core.distributed.hierarchy import HierarchyTree
from ...core.engine.round_engine import AsyncSink, as_async_sink, knob_set
from .vmap_fedavg import VmapFedAvgAPI

log = logging.getLogger(__name__)

StateDict = Dict[str, torch.Tensor]

# train_batch(model, client_ids[int32 array], version) -> stacked state dict
# (leading axis == len(client_ids)); pure in (version, client id)
TrainBatchFn = Callable[[StateDict, np.ndarray, int], StateDict]

DEFAULT_GEN_BATCH = 1024


class DelayModel:
    """Per-client heterogeneous completion delays (numpy, as in the JAX
    package, bit for bit).

    Client ``c`` owns a base latency drawn once from a lognormal centred on
    ``mean_delay`` with spread ``heterogeneity``, and each dispatch
    multiplies it by ``min_frac + Exp(1)``. Deterministic under ``seed``."""

    def __init__(self, n_clients: int, mean_delay: float = 1.0,
                 heterogeneity: float = 0.5, min_frac: float = 0.1,
                 seed: int = 0):
        if n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {n_clients}")
        base_rng = np.random.default_rng(int(seed))
        self.base = np.asarray(
            float(mean_delay) * np.exp(base_rng.normal(0.0, float(heterogeneity), int(n_clients))),
            np.float64)
        self.min_frac = float(min_frac)
        self._rng = np.random.default_rng(int(seed) + 1)

    @classmethod
    def from_args(cls, args: Any, n_clients: int) -> "DelayModel":
        return cls(
            n_clients,
            mean_delay=float(getattr(args, "async_mean_delay", 1.0)),
            heterogeneity=float(getattr(args, "async_delay_heterogeneity", 0.5)),
            seed=int(getattr(args, "random_seed", 0)),
        )

    def draw(self, client_ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(client_ids, np.int64)
        return self.base[ids] * (self.min_frac + self._rng.exponential(1.0, size=ids.shape))


class AsyncEventSim:
    """The discrete-event async federation loop over a buffer.

    ``sink`` is an :class:`AsyncAggBuffer` or any
    :class:`~fedml_tpu_torch.core.engine.round_engine.AsyncSink`. Each
    arrival's submit and publish work is timed with ``perf_counter`` into
    ``server_seconds``, the denominator of rounds/hr, which leaves out the
    delta generation (simulated client compute). On a card the submits only
    enqueue work: a caller that wants the device's time in it synchronises
    inside the sink."""

    def __init__(self, sink: Any, train_batch: TrainBatchFn, n_clients: int,
                 initial_model: StateDict, weights: Optional[np.ndarray] = None,
                 in_flight: Optional[int] = None,
                 delay: Optional[DelayModel] = None,
                 gen_batch: int = DEFAULT_GEN_BATCH,
                 on_publish: Optional[Callable[[int, StateDict], None]] = None):
        self.sink: AsyncSink = as_async_sink(sink)
        self.train_batch = train_batch
        self.n_clients = int(n_clients)
        self.weights = (np.ones(self.n_clients, np.float64) if weights is None
                        else np.asarray(weights, np.float64))
        self.in_flight = min(int(in_flight or n_clients), self.n_clients)
        self.delay = delay or DelayModel(self.n_clients)
        self.gen_batch = max(1, int(gen_batch))
        self.on_publish = on_publish
        self._events: List[Tuple[float, int, int, int]] = []  # (t, seq, client, version)
        self._seq = 0
        self._models: Dict[int, StateDict] = {self._version(): initial_model}
        # ungenerated dispatches, grouped by the model version they train on
        self._pending_by_version: Dict[int, List[Tuple[float, int, int]]] = {}
        self._deltas: Dict[int, StateDict] = {}
        self.merges = 0
        self.publishes = 0
        self.rejected = 0
        self.staleness_samples: List[int] = []
        self.virtual_time = 0.0
        self.server_seconds = 0.0
        self.gen_dispatches = 0  # train_batch calls

    def _version(self) -> int:
        return int(self.sink.version)

    # --- dispatch / generation ---------------------------------------------
    def _dispatch(self, clients, now) -> None:
        version = self._version()
        cs = np.asarray(clients, np.int64)
        ts = np.asarray(now, np.float64)
        delays = self.delay.draw(cs)
        group = self._pending_by_version.setdefault(version, [])
        for c, t0, d in zip(cs, ts, delays):
            seq = self._seq
            self._seq += 1
            t = float(t0 + d)
            heapq.heappush(self._events, (t, seq, int(c), version))
            group.append((t, seq, int(c)))

    def _ensure_delta(self, seq: int, version: int) -> None:
        if seq in self._deltas:
            return
        pending = self._pending_by_version.get(version) or []
        # the event being processed is the earliest arrival overall, hence
        # the earliest of its version group: generating the group front to
        # back by arrival time means later flushes never regenerate
        pending.sort()
        take, rest = pending[: self.gen_batch], pending[self.gen_batch:]
        self._pending_by_version[version] = rest
        ids = np.asarray([c for _, _, c in take], np.int32)
        stacked = self.train_batch(self._models[version], ids, version)
        self.gen_dispatches += 1
        for k, (_, s, _) in enumerate(take):
            self._deltas[s] = {name: leaf[k] for name, leaf in stacked.items()}
        if not rest:
            self._pending_by_version.pop(version, None)
            self._prune_models()

    def _prune_models(self) -> None:
        """Drop model versions no ungenerated dispatch references."""
        current = self._version()
        for v in [v for v in self._models
                  if v != current and v not in self._pending_by_version]:
            del self._models[v]

    def _install_model(self, version: int, model: StateDict) -> None:
        self._models[version] = model
        self._prune_models()
        if self.on_publish is not None:
            self.on_publish(version, model)

    # --- driver ------------------------------------------------------------
    def run(self, publish_target: int, max_events: Optional[int] = None) -> Dict[str, Any]:
        """Advance virtual time until ``publish_target`` publishes
        (``max_events`` caps the loop when a hostile staleness config
        rejects everything). Returns :meth:`stats`."""
        self._dispatch(np.arange(self.in_flight, dtype=np.int64), np.zeros(self.in_flight))
        if max_events is None:
            max_events = publish_target * max(int(self.sink.publish_k), 1) * 50
        processed = 0
        while self._events and self.publishes < publish_target and processed < max_events:
            t, seq, client, version = heapq.heappop(self._events)
            self.virtual_time = t
            self._ensure_delta(seq, version)
            delta = self._deltas.pop(seq)
            staleness = max(0, self._version() - version)
            t0 = time.perf_counter()
            verdict = self.sink.submit(int(client), delta, float(self.weights[client]), int(version))
            published = self.sink.try_publish()
            self.server_seconds += time.perf_counter() - t0
            processed += 1
            if verdict == "stale_rejected":
                self.rejected += 1
            else:
                self.merges += 1
                self.staleness_samples.append(staleness)
            if published is not None:
                self.publishes += 1
                self._install_model(*published)
            # the client pulls the freshest model with its upload's reply and
            # starts its next local round at once
            self._dispatch([client], [t])
        return self.stats()

    def stats(self) -> Dict[str, Any]:
        s = np.asarray(self.staleness_samples or [0], np.float64)
        return {
            "n_clients": self.n_clients,
            "in_flight": self.in_flight,
            "merges": self.merges,
            "publishes": self.publishes,
            "stale_rejected": self.rejected,
            "virtual_time": float(self.virtual_time),
            "server_seconds": float(self.server_seconds),
            "gen_dispatches": int(self.gen_dispatches),
            "staleness_mean": float(s.mean()),
            "staleness_p50": float(np.percentile(s, 50)),
            "staleness_p99": float(np.percentile(s, 99)),
            "buffer_high_water": int(self.sink.high_water),
        }


def _client_seed(seed: int, client: int, version: int) -> int:
    """A 63-bit generator seed from ``(seed, client, version)``."""
    a, b = np.random.SeedSequence([int(seed), int(client), int(version)]).generate_state(2)
    return ((int(a) << 32) | int(b)) & 0x7FFFFFFFFFFFFFFF


def make_synthetic_delta_fn(seed: int = 0, step_scale: float = 0.01) -> TrainBatchFn:
    """A cheap, deterministic stand-in for local training: client ``c``'s
    delta on model version ``v`` is ``model + step_scale * N(0, 1)`` on the
    model's floating leaves, the noise drawn (in f32, the state dict's order)
    from a generator seeded from ``(seed, c, v)``: pure in (c, v) whatever
    the batch. A batch is one ``[B, P]`` buffer on the model's device, one
    draw a client and one scale-and-add for all of them."""

    def batch(model: StateDict, client_ids: np.ndarray, version: int) -> StateDict:
        names = [n for n, v in model.items() if v.is_floating_point()]
        dev = model[names[0]].device if names else torch.device("cpu")
        ids = [int(c) for c in np.asarray(client_ids)]
        sizes = [model[n].numel() for n in names]
        base = torch.cat([model[n].reshape(-1).float() for n in names]) if names else \
            torch.zeros(0, device=dev)
        noise = torch.empty(len(ids), base.numel(), dtype=torch.float32, device=dev)
        for i, c in enumerate(ids):
            gen = torch.Generator(device=dev).manual_seed(_client_seed(seed, c, version))
            noise[i].normal_(generator=gen)
        flat = noise.mul_(float(step_scale)).add_(base)
        out: StateDict = {}
        parts = dict(zip(names, torch.split(flat, sizes, dim=1))) if names else {}
        for name, leaf in model.items():
            if name in parts:
                out[name] = parts[name].reshape(len(ids), *leaf.shape).to(leaf.dtype)
            else:
                out[name] = leaf.expand(len(ids), *leaf.shape)
        return out

    return batch


def simulate_async_rounds(n_clients: int, publish_k: int, template: StateDict,
                          publishes: int, *, hierarchy_edges: int = 0,
                          gen_batch: int = DEFAULT_GEN_BATCH,
                          buffer: Optional[AsyncAggBuffer] = None,
                          seed: int = 0, mean_delay: float = 1.0,
                          heterogeneity: float = 0.5) -> Dict[str, Any]:
    """One synthetic async federation run: ``n_clients`` simulated clients
    with heterogeneous delays drive a fresh buffer (or ``buffer``, or an
    edge->regional->root tree on the template's device when
    ``hierarchy_edges > 0``) until ``publishes`` global model versions
    exist. Returns the sim's stats."""
    if hierarchy_edges > 0:
        sink: Any = HierarchyTree.build(
            hierarchy_edges, publish_k=publish_k, engine=get_engine(),
            initial_model=template, device=next(iter(template.values())).device)
    elif buffer is not None:
        sink = buffer
    else:
        sink = AsyncAggBuffer(publish_k=publish_k, engine=get_engine())
    sim = AsyncEventSim(
        sink, make_synthetic_delta_fn(seed=seed), n_clients,
        initial_model=template,
        delay=DelayModel(n_clients, mean_delay=mean_delay, heterogeneity=heterogeneity, seed=seed),
        gen_batch=gen_batch)
    return sim.run(publishes)


class VmapAsyncFedAvgAPI(VmapFedAvgAPI):
    """Asynchronous counterpart of :class:`VmapFedAvgAPI`: the same
    client-batched local round, with the round barrier replaced by the event
    loop and the async buffer. ``client_num_per_round`` clients stay in
    flight; ``comm_round`` counts publishes (model versions), as the
    cross-silo server's async mode does. Evaluation runs on publish at the
    ``frequency_of_the_test`` cadence. ``hierarchy_edges`` is refused: the
    JAX package's API does not read it, and the tree runs through
    :func:`simulate_async_rounds` and ``HierarchyTree``."""

    def __init__(self, args: Any, device: Any, dataset, model):
        if knob_set(getattr(args, "hierarchy_edges", None)):
            raise NotImplementedError(
                "hierarchy_edges: the vmapped async API does not read it (nor does the JAX "
                "package's); the edge->regional->root tree runs through "
                "simulate_async_rounds(hierarchy_edges=...) and HierarchyTree")
        super().__init__(args, device, dataset, model)

    def train(self) -> Dict[str, float]:
        args = self.args
        n_total = int(args.client_num_in_total)
        in_flight = min(int(args.client_num_per_round), n_total)
        publish_target = int(getattr(args, "comm_round", 10))
        w_global = self.model.params
        buffer = buffer_from_args(args, engine=get_engine())

        def train_batch(model: StateDict, client_ids: np.ndarray, version: int) -> StateDict:
            ids = [int(c) for c in client_ids]
            x, y, idx, mask = self._stack_clients(ids)
            return self._vmapped_train(model, x, y, idx, mask, int(version)).params

        weights = np.asarray(
            [float(self.train_data_local_num_dict[i]) for i in range(n_total)], np.float64)
        freq = int(getattr(args, "frequency_of_the_test", 5))

        def on_publish(version: int, model: StateDict) -> None:
            round_idx = version - 1
            self.aggregator.set_model_params(model)
            if round_idx == publish_target - 1 or (freq > 0 and round_idx % freq == 0):
                metrics = self.aggregator.test(self.test_global, self.device, args)
                metrics["round"] = round_idx
                metrics["staleness_mean"] = float(np.mean(sim.staleness_samples or [0]))
                log.info("vmap async sim publish %d: %s", version,
                         {k: round(float(v), 4) for k, v in metrics.items()})
                self.metrics_history.append(metrics)

        sim = AsyncEventSim(
            buffer, train_batch, n_total, initial_model=w_global,
            weights=weights, in_flight=in_flight,
            delay=DelayModel.from_args(args, n_total),
            gen_batch=int(getattr(args, "async_gen_batch", DEFAULT_GEN_BATCH)),
            on_publish=on_publish)
        self.stats = sim.run(publish_target)
        log.info("vmap async sim done: %s", self.stats)
        w_final = sim._models.get(sim._version(), w_global)
        self.model = dataclasses.replace(self.model, params=w_final)
        self.aggregator.set_model_params(w_final)
        return self.metrics_history[-1] if self.metrics_history else {}
