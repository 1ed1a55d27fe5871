"""Asynchronous buffered aggregation (FedBuff): counterpart of
``fedml_tpu/core/aggregation/async_buffer.py``.

Client models are accepted at any time and folded into the bucketed
engine's f32 accumulator (``BucketedAggregator.accumulate_bucket``, one flat
vector on the arrivals' device) the moment a full bucket of arrivals exists;
a new global model is published every ``publish_k`` merges instead of once
per cohort. Clients pull the latest model with each upload's reply and start
their next local round at once, so rounds/hr depends on ``publish_k``, not on
the cohort's size.

Staleness policy (Xie et al., "Asynchronous Federated Optimization"): an
arrival trained on model version ``v`` when the server is at ``V`` has
staleness ``V - v`` and weight ``sample_num * (1 + staleness) ** -exponent``.
Arrivals beyond ``max_staleness`` are refused (``stale_rejected``); a rank
the health tracker flags as a straggler gets ``straggler_grace`` times the
cut. ``policy.health`` is duck-typed (``health._clients[rank].flagged``).

Normalization contract, as in the JAX package: a publish divides the
streamed raw-weight accumulator by the streamed weight sum (one in-place
multiply). When every arrival of the window is still pending at publish
(``publish_k`` <= one bucket) the publish goes through ``engine.aggregate``
itself, so staleness exponent 0 reproduces the synchronous FedAvg fold bit
for bit. Beyond one bucket the order differs from the synchronous fold by
one rounding per element (scale after the fold, not a fold of scaled
weights).

Crash safety: :meth:`export_pytree_state` / :meth:`export_meta` snapshot
the accumulator, the un-folded pending state dicts and the staleness clock;
:meth:`restore` rebuilds them, and the merges after it are bit-identical to
an uninterrupted run.

Privacy sessions (``core/privacy``: a SecAgg ``WindowCoordinator`` or a
``DPFold``) attach through :meth:`enable_privacy`: a publish then folds
every pending arrival into the accumulator and hands the RAW streamed sum
to ``session.on_publish(acc, weight_sum, merges, template, engine)``, which
owns unmasking, noising and normalization. :meth:`discard` drops an epoch
without publishing (an aborted SecAgg window).

``async_link_admission``: :meth:`StalenessPolicy.set_link_predictor` wires
netlink's cost model in, and the admission cut stretches by the model
versions a rank's predicted upload spans.

Modelwatch (JAX ``:195-200``, ``:243-285``, ``:357-358``, ``:385-400``):
:meth:`enable_watch` attaches a watch session whose statistics ride both
fold sites of the bucketed engine; each publish finishes the session, folds
its rows into the contribution ledger (``observe_round(version, stats)``)
and starts a fresh one against the new model. With quarantine on, an
arrival with a NaN or Inf, or a streaming robust-z outlier, gets the
``outlier_rejected`` verdict and is never folded.

Not ported (ROADMAP.md, Queue 1): the mesh-sharded engine.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry as tel
from ..resilience import quorum as quorum_mod
from .bucketed import BucketedAggregator, get_engine

StateDict = Dict[str, torch.Tensor]

MERGE_COUNTER = "async.merges"        # rendered fedml_async_merges_total
PUBLISH_COUNTER = "async.publishes"   # rendered fedml_async_publishes_total
STALENESS_HISTOGRAM = "async.staleness"

DEFAULT_PUBLISH_K = 8
DEFAULT_STALENESS_EXPONENT = 0.5
DEFAULT_MAX_STALENESS = 10
DEFAULT_STRAGGLER_GRACE = 1.5


class StalenessPolicy:
    """Polynomial staleness decay and the admission cut.

    ``weight(s) = (1 + s) ** -exponent`` (exponent 0: unit weight, the
    synchronous parity configuration). ``admit`` refuses arrivals staler than
    ``max_staleness``; when a health tracker is wired in and flags the rank
    as a straggler, the cut stretches by ``straggler_grace``; with a link
    predictor wired in (``async_link_admission``) it stretches further by
    the versions the rank's predicted upload spans."""

    def __init__(self, exponent: float = DEFAULT_STALENESS_EXPONENT,
                 max_staleness: int = DEFAULT_MAX_STALENESS,
                 straggler_grace: float = DEFAULT_STRAGGLER_GRACE,
                 health: Any = None):
        if exponent < 0:
            raise ValueError(f"staleness exponent must be >= 0, got {exponent}")
        self.exponent = float(exponent)
        self.max_staleness = int(max_staleness)
        self.straggler_grace = float(straggler_grace)
        self.health = health  # a HealthTracker (duck-typed) or None
        # args.async_link_admission: rank -> predicted upload seconds (the
        # netlink cost model) + a publish-interval estimate convert measured
        # WAN transfer time into extra tolerated staleness versions
        self._link_predict = None
        self._publish_interval_fn = None
        self.link_grace_cap = 0

    @classmethod
    def from_args(cls, args: Any, health: Any = None) -> "StalenessPolicy":
        return cls(
            exponent=float(getattr(args, "async_staleness_exponent", DEFAULT_STALENESS_EXPONENT)),
            max_staleness=int(getattr(args, "async_max_staleness", DEFAULT_MAX_STALENESS)),
            straggler_grace=float(getattr(args, "async_straggler_grace", DEFAULT_STRAGGLER_GRACE)),
            health=health,
        )

    def weight(self, staleness: int) -> float:
        if staleness <= 0 or self.exponent == 0.0:
            return 1.0
        return float((1.0 + staleness) ** -self.exponent)

    def _rank_flagged(self, rank: Optional[int]) -> bool:
        if rank is None or self.health is None:
            return False
        try:
            c = self.health._clients.get(int(rank))
        except Exception:  # noqa: BLE001 - duck-typed health object
            return False
        return bool(c is not None and c.flagged)

    def set_link_predictor(self, link_predict: Any, publish_interval_fn: Any,
                           grace_cap: Optional[int] = None) -> None:
        """Wire the netlink cost model into admission (``args.async_link_admission``).

        ``link_predict(rank)`` returns predicted upload seconds (None when the
        estimate isn't confident); ``publish_interval_fn()`` the server's mean
        seconds between publishes. Their ratio is how many model versions a
        delta ages **in flight** — lateness the link explains, so the cut
        stretches by that many versions (capped at ``grace_cap``, default
        ``max_staleness``, so a wild estimate can at most double the cut)."""
        self._link_predict = link_predict
        self._publish_interval_fn = publish_interval_fn
        self.link_grace_cap = int(self.max_staleness if grace_cap is None else grace_cap)

    def _link_extra(self, rank: Optional[int]) -> int:
        if rank is None or self._link_predict is None or self._publish_interval_fn is None:
            return 0
        try:
            pred_s = self._link_predict(int(rank))
            interval_s = self._publish_interval_fn()
        except Exception:  # noqa: BLE001 - duck-typed predictor: no stretch, as in JAX
            return 0
        if not pred_s or not interval_s or interval_s <= 0:
            return 0
        return min(int(math.ceil(float(pred_s) / float(interval_s))), self.link_grace_cap)

    def admission_cut(self, rank: Optional[int] = None) -> int:
        cut = self.max_staleness
        if self._rank_flagged(rank):
            cut = int(math.ceil(cut * self.straggler_grace))
        return cut + self._link_extra(rank)

    def admit(self, staleness: int, rank: Optional[int] = None) -> bool:
        return int(staleness) <= self.admission_cut(rank)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "exponent": self.exponent,
            "max_staleness": self.max_staleness,
            "straggler_grace": self.straggler_grace,
            "health_wired": self.health is not None,
            "link_wired": self._link_predict is not None,
        }


class AsyncAggBuffer:
    """Staleness-weighted streaming merge buffer with publish-every-K.

    Thread-safe: :meth:`submit` runs on the server's receive loop while
    :meth:`statusz` and snapshots read concurrently. Arrivals append to the
    pending list; as soon as a full engine bucket of them exists (and the
    window is larger than a bucket) it folds into the f32 accumulator and
    the state dicts are dropped, so device memory stays O(bucket x model)
    whatever ``publish_k`` or the cohort."""

    def __init__(self, publish_k: int = DEFAULT_PUBLISH_K,
                 policy: Optional[StalenessPolicy] = None,
                 engine: Optional[BucketedAggregator] = None,
                 initial_version: int = 0):
        if publish_k < 1:
            raise ValueError(f"publish_k must be >= 1, got {publish_k}")
        self.publish_k = int(publish_k)
        self.policy = policy or StalenessPolicy()
        self.engine = engine or get_engine()
        self._lock = threading.Lock()
        self._pending: List[Tuple[float, StateDict]] = []
        self._pending_meta: List[Dict[str, Any]] = []  # rank/staleness per pending
        self._acc: Optional[torch.Tensor] = None  # flat f32, on the arrivals' device
        self._weight_sum = 0.0
        self._template: Optional[StateDict] = None
        self._privacy: Any = None  # a core/privacy session, or None
        # modelwatch: the publish window's stat session riding the fold
        # (enable_watch); None leaves the default path untouched
        self._watch = None
        self._watch_ranks: List[Any] = []
        self._ledger = None
        self._quarantine = False
        self.quarantined_total = 0
        self._merges_since_publish = 0
        self.version = int(initial_version)
        self.merges_total = 0
        self.publishes_total = 0
        self.stale_accepted_total = 0
        self.stale_rejected_total = 0
        self.depth_high_water = 0
        self.last_publish_weight = 0.0
        self.last_publish_merges = 0
        # staleness clock: rank -> model version of that rank's last merge
        self._client_versions: Dict[int, int] = {}
        self._staleness_sum = 0
        # mean seconds between publishes (None until two publishes)
        self.publish_interval_ewma_s: Optional[float] = None
        self._last_publish_mono: Optional[float] = None

    # --- privacy (core/privacy sessions) ------------------------------------
    def enable_privacy(self, session: Any) -> None:
        """Attach a privacy session (``WindowCoordinator`` or ``DPFold``).
        Publishes then fold ALL pending arrivals into the accumulator and
        route the raw weighted sum through ``session.on_publish(acc,
        weight_sum, merges, template, engine)``: the session owns unmasking,
        noising AND normalization."""
        with self._lock:
            self._privacy = session

    # --- modelwatch --------------------------------------------------------
    def enable_watch(self, ref: StateDict, ledger: Any = None,
                     quarantine: bool = False) -> bool:
        """Attach a modelwatch session: per-client delta stats against
        ``ref`` (the current global model) ride the fold, are fetched at
        each publish and folded into ``ledger``. With ``quarantine``,
        arriving outliers (streaming robust z against the ledger's window of
        recent norms, or any NaN/Inf) get the ``outlier_rejected`` verdict
        instead of folding. Returns False, and watches nothing, on an engine
        without a fused watch or a model with object leaves."""
        from ..telemetry import modelwatch

        if not getattr(self.engine, "supports_watch", False) or \
                modelwatch.has_object_leaves(ref):
            return False
        with self._lock:
            self._watch = modelwatch.WatchSession(ref)
            self._watch_ranks = []
            self._ledger = ledger
            self._quarantine = bool(quarantine)
        return True

    def _screen_arrival(self, rank: int, tree: StateDict) -> Optional[str]:
        """Quarantine-mode admission: one arriving tree's stat row, fetched
        (the opt-in path pays this sync; the default path never runs it),
        and a refusal for NaN/Inf deltas and robust-z outliers."""
        watch = self._watch
        if watch is None:
            return None
        from ..telemetry import modelwatch

        row = modelwatch.client_stat(tree, watch).cpu().numpy()
        sq = float(row[modelwatch.COL_SQ])
        bad = float(row[modelwatch.COL_NAN]) + float(row[modelwatch.COL_INF])
        norm = math.sqrt(sq) if sq >= 0.0 else float("nan")
        z = self._ledger.streaming_z(norm) if self._ledger is not None else 0.0
        if bad > 0 or not math.isfinite(norm) or z >= modelwatch.z_threshold():
            with self._lock:
                self.quarantined_total += 1
            tel.counter("modelwatch.quarantined").add(1)
            if self._ledger is not None:
                self._ledger.note_quarantined(rank, norm, z)
            return quorum_mod.OUTLIER_REJECTED
        if self._ledger is not None:
            self._ledger.observe_stream_norm(norm)
        return None

    # --- submit (receive-loop thread) --------------------------------------
    def submit(self, rank: int, model_params: StateDict, sample_num: float,
               client_version: Optional[int]) -> str:
        """Fold one arrival. Returns the verdict: ``accept`` (fresh),
        ``stale_accepted`` (admitted with a decayed weight),
        ``stale_rejected`` (beyond the admission cut) or ``outlier_rejected``
        (modelwatch quarantine); a rejected arrival is never folded."""
        staleness = 0 if client_version is None else max(0, self.version - int(client_version))
        if not self.policy.admit(staleness, rank):
            with self._lock:
                self.stale_rejected_total += 1
            tel.counter(quorum_mod.STALE_REJECTED_COUNTER).add(1)
            return quorum_mod.STALE_REJECTED
        if self._quarantine:
            verdict = self._screen_arrival(rank, model_params)
            if verdict is not None:
                return verdict
        weight = float(sample_num) * self.policy.weight(staleness)
        with tel.span("async.merge", rank=int(rank), staleness=int(staleness)):
            with self._lock:
                self._merge_locked(rank, model_params, weight, staleness)
                if staleness > 0:
                    self.stale_accepted_total += 1
        tel.counter(MERGE_COUNTER).add(1)
        tel.histogram(STALENESS_HISTOGRAM).observe(float(staleness))
        if staleness > 0:
            tel.counter(quorum_mod.STALE_ACCEPTED_COUNTER).add(1)
            return quorum_mod.STALE_ACCEPTED
        return quorum_mod.ACCEPT

    def _merge_locked(self, rank: int, tree: StateDict, weight: float, staleness: int) -> None:
        if self._template is None:
            self._template = tree
        self._pending.append((weight, tree))
        self._pending_meta.append({"rank": int(rank), "staleness": int(staleness)})
        self.merges_total += 1
        self._merges_since_publish += 1
        self._staleness_sum += int(staleness)
        self._client_versions[int(rank)] = self.version
        self.depth_high_water = max(self.depth_high_water, self._merges_since_publish)
        self._fold_full_buckets_locked()

    def _fold_full_buckets_locked(self) -> None:
        b = self.engine.bucket_size
        if self.publish_k <= b:
            # the whole window fits one bucket: keep the arrivals pending so
            # publish takes the engine's normalize-first path (bit-exact with
            # the synchronous fold)
            return
        while len(self._pending) >= b:
            chunk = [t for _, t in self._pending[:b]]
            w = np.asarray([w for w, _ in self._pending[:b]], dtype=np.float32)
            self._acc = self.engine.accumulate_bucket(self._acc, chunk, w, watch=self._watch)
            if self._watch is not None:
                self._watch_ranks.extend(m["rank"] for m in self._pending_meta[:b])
            self._weight_sum += float(w.sum())
            del self._pending[:b]
            del self._pending_meta[:b]

    # --- publish -----------------------------------------------------------
    def ready(self) -> bool:
        with self._lock:
            return self._merges_since_publish >= self.publish_k

    def publish(self) -> Optional[StateDict]:
        """Fold the ragged pending tail, normalize, advance the model
        version and return the new global model (None when nothing merged
        since the last publish).

        With a watch session attached, the window's stats are fetched here,
        folded into the ledger, and a fresh session (ref the new model, prev
        this window's update) is installed."""
        with tel.span("async.publish", version=self.version):
            with self._lock:
                out = self._publish_locked()
                watch, ranks = self._watch, self._watch_ranks
                version = self.version
                if watch is not None and out is not None:
                    # detached while finishing: a submit in between folds
                    # unwatched until the fresh session is in
                    self._watch = None
                    self._watch_ranks = []
            if watch is None or out is None:
                return out
        from ..telemetry import modelwatch

        watch.ranks = ranks
        stats = watch.finish(out)
        if self._ledger is not None:
            self._ledger.observe_round(version, stats)
        fresh = modelwatch.WatchSession(out, prev_update=stats.update_tree)
        with self._lock:
            if self._watch is None:  # a concurrent enable_watch wins
                self._watch = fresh
        return out

    def _publish_locked(self) -> Optional[StateDict]:
        if self._merges_since_publish == 0:
            return None
        if self._privacy is None and self._acc is None and self._pending:
            # nothing folded eagerly (the window fit one bucket): the engine's
            # own normalized fold, bit-identical to the synchronous path
            self.last_publish_weight = float(sum(w for w, _ in self._pending))
            if self._watch is not None:
                self._watch_ranks.extend(m["rank"] for m in self._pending_meta)
            out = self.engine.aggregate(list(self._pending), watch=self._watch)
        else:
            if self._pending:
                b = self.engine.bucket_size
                chunk = [t for _, t in self._pending]
                w = np.asarray([w for w, _ in self._pending], dtype=np.float32)
                real = len(chunk)
                pad = b - real
                if pad > 0:  # zero-weight pad to the bucket's shape
                    chunk = chunk + [chunk[-1]] * pad
                    w = np.concatenate([w, np.zeros((pad,), np.float32)])
                if self._watch is not None:
                    self._watch_ranks.extend(m["rank"] for m in self._pending_meta)
                self._acc = self.engine.accumulate_bucket(self._acc, chunk, w,
                                                          watch=self._watch, watch_real=real)
                self._weight_sum += float(w.sum())
            self.last_publish_weight = float(self._weight_sum)
            if self._privacy is not None:
                # privacy mode: the session consumes the RAW streamed sum
                # (secagg reduces it mod 2^b and the masks cancel exactly; the
                # DP session scales and noises it) and owns normalization
                out = self._privacy.on_publish(
                    self._acc, self._weight_sum, self._merges_since_publish,
                    self._template, self.engine)
            else:
                # the JAX package's jitted scale: one in-place multiply of
                # the accumulator by 1/W, rounded to f32 first as there
                self._acc.mul_(float(np.float32(1.0 / self._weight_sum)))
                out = self.engine.finalize(self._acc, self._template)
        self.last_publish_merges = self._merges_since_publish
        self._acc = None
        self._weight_sum = 0.0
        self._pending = []
        self._pending_meta = []
        self._merges_since_publish = 0
        self._staleness_sum = 0
        self.version += 1
        self.publishes_total += 1
        now = time.monotonic()
        if self._last_publish_mono is not None:
            dt = now - self._last_publish_mono
            self.publish_interval_ewma_s = dt if self.publish_interval_ewma_s is None \
                else 0.7 * self.publish_interval_ewma_s + 0.3 * dt
        self._last_publish_mono = now
        tel.counter(PUBLISH_COUNTER).add(1)
        return out

    def discard(self) -> int:
        """Throw away the accumulated epoch WITHOUT publishing: no version
        bump, no publish counter, no privacy hook. The escalation path for
        an unrecoverable SecAgg window: its streamed sum still carries
        un-cancellable stray masks, so normalizing it would emit garbage.
        Returns how many merges were dropped."""
        with self._lock:
            dropped = self._merges_since_publish
            self._acc = None
            self._weight_sum = 0.0
            self._pending = []
            self._pending_meta = []
            self._merges_since_publish = 0
            self._staleness_sum = 0
            self._watch_ranks = []
        return dropped

    # --- introspection -----------------------------------------------------
    def depth(self) -> int:
        with self._lock:
            return self._merges_since_publish

    def statusz(self) -> Dict[str, Any]:
        with self._lock:
            n = self._merges_since_publish
            return {
                "version": self.version,
                "publish_k": self.publish_k,
                "depth": n,
                "depth_high_water": self.depth_high_water,
                "pending_unfolded": len(self._pending),
                "merges_total": self.merges_total,
                "publishes_total": self.publishes_total,
                "stale_accepted_total": self.stale_accepted_total,
                "stale_rejected_total": self.stale_rejected_total,
                "mean_staleness": (self._staleness_sum / n) if n else 0.0,
                "publish_interval_ewma_s": self.publish_interval_ewma_s,
                "modelwatch": self._watch is not None,
                "modelwatch_quarantine": self._quarantine,
                "quarantined_total": self.quarantined_total,
                "policy": self.policy.as_dict(),
                "client_versions": dict(self._client_versions),
            }

    def prom_gauges(self) -> List[tuple]:
        """``(name, labels, value)`` triples for a Prometheus render."""
        with self._lock:
            return [
                ("async_buffer_depth", {}, float(self._merges_since_publish)),
                ("async_buffer_high_water", {}, float(self.depth_high_water)),
                ("async_model_version", {}, float(self.version)),
            ]

    # --- persistence (round-state snapshots) ---------------------------------
    def export_pytree_state(self) -> Dict[str, Any]:
        """The tensor half of a snapshot: ``acc``, a copy of the flat f32
        accumulator (the next fold adds to the live one in place), and
        ``pending``, the un-folded arrivals in submit order."""
        with self._lock:
            state: Dict[str, Any] = {}
            if self._acc is not None:
                state["acc"] = self._acc.detach().clone()
            if self._pending:
                state["pending"] = [t for _, t in self._pending]
            return state

    def export_meta(self) -> Dict[str, Any]:
        """The JSON half: the staleness clock and the scalars. ``weight_sum``
        is a Python float, which JSON round-trips exactly."""
        with self._lock:
            return {
                "version": self.version,
                "publish_k": self.publish_k,
                "weight_sum": float(self._weight_sum),
                "merges_since_publish": self._merges_since_publish,
                "merges_total": self.merges_total,
                "publishes_total": self.publishes_total,
                "stale_accepted_total": self.stale_accepted_total,
                "stale_rejected_total": self.stale_rejected_total,
                "staleness_sum": self._staleness_sum,
                "depth_high_water": self.depth_high_water,
                "has_acc": self._acc is not None,
                "pending_weights": [float(w) for w, _ in self._pending],
                "pending_meta": [dict(m) for m in self._pending_meta],
                "client_versions": {str(r): int(v) for r, v in self._client_versions.items()},
            }

    def state_template(self, model_template: StateDict, meta: Dict[str, Any]) -> Dict[str, Any]:
        """The restore template matching a snapshot's meta: a zero flat f32
        accumulator over ``model_template``'s elements, and one template per
        pending arrival."""
        tmpl: Dict[str, Any] = {}
        if meta.get("has_acc"):
            n = sum(v.numel() for v in model_template.values())
            dev = next(iter(model_template.values())).device
            tmpl["acc"] = torch.zeros(n, dtype=torch.float32, device=dev)
        n_pending = len(meta.get("pending_weights") or [])
        if n_pending:
            tmpl["pending"] = [model_template for _ in range(n_pending)]
        return tmpl

    def restore(self, state: Dict[str, Any], meta: Dict[str, Any],
                template: Optional[StateDict] = None) -> None:
        """Rebuild the buffer from a snapshot: the accumulator, the pending
        state dicts with their weights, and the staleness clock."""
        with self._lock:
            self.version = int(meta.get("version", 0))
            self._weight_sum = float(meta.get("weight_sum", 0.0))
            self._merges_since_publish = int(meta.get("merges_since_publish", 0))
            self.merges_total = int(meta.get("merges_total", 0))
            self.publishes_total = int(meta.get("publishes_total", 0))
            self.stale_accepted_total = int(meta.get("stale_accepted_total", 0))
            self.stale_rejected_total = int(meta.get("stale_rejected_total", 0))
            self._staleness_sum = int(meta.get("staleness_sum", 0))
            self.depth_high_water = int(meta.get("depth_high_water", 0))
            self._client_versions = {
                int(r): int(v) for r, v in (meta.get("client_versions") or {}).items()}
            self._acc = state.get("acc") if meta.get("has_acc") else None
            weights = [float(w) for w in (meta.get("pending_weights") or [])]
            trees = list(state.get("pending") or [])
            if len(weights) != len(trees):
                raise ValueError(
                    f"buffer snapshot torn: {len(weights)} pending weights vs "
                    f"{len(trees)} pending trees")
            self._pending = list(zip(weights, trees))
            self._pending_meta = [dict(m) for m in (meta.get("pending_meta") or
                                                    [{} for _ in trees])]
            if template is not None:
                self._template = template
            elif trees:
                self._template = trees[0]


def buffer_from_args(args: Any, health: Any = None,
                     engine: Optional[BucketedAggregator] = None) -> AsyncAggBuffer:
    """The cross-silo server's and the vmapped driver's construction path:
    ``publish_k`` from ``args.async_publish_k``, the staleness policy from
    the ``async_*`` knobs."""
    return AsyncAggBuffer(
        publish_k=int(getattr(args, "async_publish_k", DEFAULT_PUBLISH_K)),
        policy=StalenessPolicy.from_args(args, health=health),
        engine=engine,
    )
