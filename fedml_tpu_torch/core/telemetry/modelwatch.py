"""Training-dynamics observability at the aggregation fold boundary:
counterpart of ``fedml_tpu/core/telemetry/modelwatch.py``.

Statistics about the model updates, computed where they are folded:

- **per client**: the global and per-dtype-group L2 norm of the delta
  (``client params - running aggregate``), NaN/Inf counts, the cosine to the
  running aggregate and the update-to-weight ratio ``|delta| / |w|``;
- **per publish**: the published aggregate's update norm, NaN/Inf count and
  cosine drift against the previous published update direction.

The math rides the fold. ``BucketedAggregator.accumulate_bucket(...,
watch=)`` computes a bucket's stat block from the same ``[B, D]`` f32 chunk
it contracts with the weights, on the chunk's device, and adds no host
synchronisation: the ``[B, 4 + G]`` blocks stay on the device until
:meth:`WatchSession.finish` fetches them together with the aggregate's
statistics in one device-to-host copy (or, with quarantine on, until
:meth:`WatchSession.peek_norms`). Fronts that fold through middleware (sp
FedOpt, the cross-silo hooks) screen the cohort with the stats-only block
(:func:`screen_cohort`). Every sum is taken in f32 whatever the leaf dtype,
as JAX does, over the flat f32 vector in the state dict's own leaf order:
the JAX tree's leaf order differs, so the sums agree to f32 rounding.

JAX pins every modelwatch program under the compile counter
``jax.compiles.modelwatch``; eager PyTorch compiles nothing, so the port
has no such counter.

Three consumers:

1. the per-client **contribution ledger** (:class:`ContributionLedger`,
   owned by ``FleetTelemetry``): EWMA norm share and a robust-z outlier
   score from the health tracker's MAD machinery, on ``/statusz``, the
   ``fedml_client_{delta_norm,contribution,outlier_score}`` prom gauges and
   the per-round ``HealthReport``;
2. tsdb series (``modelwatch.nan_count``, ``modelwatch.agg_update_norm``,
   ``modelwatch.divergence_ratio``, ``modelwatch.cosine_drift``,
   ``modelwatch.outlier_rate``) behind the SLO pack's ``nan_storm``,
   ``divergence`` and ``client_outlier_rate`` rows; each auto-captured
   flight-recorder snapshot carries the offending clients' stat rows
   through the SLO engine's alert-context hook;
3. an opt-in quarantine (``args.modelwatch_quarantine``) that routes
   outlier deltas to a rejected verdict, counted
   (``fedml_modelwatch_quarantined_total``) and never folded, without
   changing the default fold.

Kill switch: ``FEDML_MODELWATCH=0`` or ``args.modelwatch_disable``.
"""

from __future__ import annotations

import logging
import math
import os
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import flight_recorder, tsdb
from .core import get_telemetry
from .health import DEFAULT_MAD_Z, MAD_TO_SIGMA, MIN_COHORT, robust_zscores

log = logging.getLogger(__name__)

StateDict = Dict[str, Any]

__all__ = [
    "ContributionLedger",
    "RoundStats",
    "WatchSession",
    "block_stat_math",
    "client_stat",
    "enabled",
    "get_active",
    "outlier_verdicts",
    "prom_gauges",
    "quarantine_enabled",
    "screen_cohort",
    "set_active",
    "statusz_snapshot",
    "train_guard",
]

_ENV_ENABLE = "FEDML_MODELWATCH"
_ENV_Z = "FEDML_MODELWATCH_Z"

# fixed stat-block column layout ([B, 4 + G] per bucket; G dtype groups)
COL_SQ = 0      # global squared L2 norm of the client delta
COL_DOT = 1     # dot(delta, running aggregate)
COL_NAN = 2     # NaN count over the client's tree
COL_INF = 3     # Inf count over the client's tree
N_FIXED_COLS = 4

# aggregate-stat vector layout (finish)
_AGG_SQ, _AGG_NAN, _AGG_INF, _AGG_DOT_PREV, _AGG_PREV_SQ, _AGG_REF_SQ = range(6)


def enabled(args: Any = None) -> bool:
    """Modelwatch is on unless the env or run args kill it."""
    if os.environ.get(_ENV_ENABLE, "1") == "0":
        return False
    return not bool(getattr(args, "modelwatch_disable", False))


def quarantine_enabled(args: Any = None) -> bool:
    return bool(getattr(args, "modelwatch_quarantine", False))


def z_threshold() -> float:
    try:
        return float(os.environ.get(_ENV_Z, DEFAULT_MAD_Z))
    except ValueError:
        return DEFAULT_MAD_Z


def _dtype_name(leaf: Any) -> str:
    """JAX's name of a leaf's dtype (``"float32"``, ``"bfloat16"``, never
    ``"torch.float32"``); a Python number by numpy's promotion, as JAX's
    ``np.result_type``."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).rpartition(".")[2]
    if hasattr(leaf, "dtype"):
        return str(leaf.dtype)
    return str(np.result_type(leaf))


def group_labels(tree: StateDict) -> List[str]:
    """Sorted distinct leaf dtype names: the per-dtype-group norm axes."""
    return sorted({_dtype_name(leaf) for leaf in tree.values()})


def has_object_leaves(tree: StateDict) -> bool:
    """Leaves with their own algebra (FHE ciphertexts): no tensor stats. A
    nested (flax-layout) tree is searched through."""
    from ..aggregation.bucketed import is_object_leaf

    return any(has_object_leaves(leaf) if isinstance(leaf, dict) else is_object_leaf(leaf)
               for leaf in tree.values())


def _as_state_dict(tree: StateDict) -> StateDict:
    """A nested tree in the flax layout (the adapters a FedLLM silo
    exchanges) as the port's state dict, through ``models.convert``: the
    statistics are elementwise, so a transposed kernel leaves them as they
    are. A state dict comes back as it is."""
    if any(isinstance(v, dict) for v in tree.values()):
        from ...models.convert import params_from_jax

        return params_from_jax(tree)
    return tree


def _as_tensor_tree(tree: StateDict, device: Optional[torch.device] = None) -> StateDict:
    return {k: torch.as_tensor(v, device=device) for k, v in _as_state_dict(tree).items()}


def block_stat_math(flat_chunk: torch.Tensor, ref_flat: torch.Tensor,
                    group_slices: Optional[Sequence[Sequence[Tuple[int, int]]]]) -> torch.Tensor:
    """One bucket's ``[B, 4 + G]`` per-client rows from its flat f32 chunk
    ``[B, D]`` against the flat f32 reference ``[D]``. ``group_slices``
    lists each group's ``(start, end)`` column runs (None for one group); a
    NaN in one group leaves the others' sums finite, as JAX's per-leaf
    sums do. Only device ops: no host sync."""
    d = flat_chunk - ref_flat
    dd = d * d
    if group_slices is None:
        sq_g = dd.sum(dim=1, keepdim=True)
    else:
        sq_g = torch.stack([sum(dd[:, a:b].sum(dim=1) for a, b in runs)
                            for runs in group_slices], dim=1)
    sq = sq_g.sum(dim=1, keepdim=True)
    dot = (d * ref_flat).sum(dim=1, keepdim=True)
    nan = torch.isnan(flat_chunk).sum(dim=1, keepdim=True).to(torch.float32)
    inf = torch.isinf(flat_chunk).sum(dim=1, keepdim=True).to(torch.float32)
    return torch.cat([sq, dot, nan, inf, sq_g], dim=1)


def _count(mask: torch.Tensor) -> torch.Tensor:
    """The true elements of a bool mask, in f32: summed as bytes into int32
    (into int64 past 2^31 elements), about twice as fast on the card as
    ``mask.sum()``'s bool reduction."""
    dtype = torch.int32 if mask.numel() < 2 ** 31 else torch.int64
    return mask.view(torch.uint8).sum(dtype=dtype).to(torch.float32)


def _tree_sums(tree: StateDict) -> torch.Tensor:
    """``[sq, nan, inf]`` over a tree's leaves, leaf by leaf, accumulated in
    f32 (a 16-bit leaf is widened inside the norm's reduction, so no f32
    copy of a leaf, let alone of the tree, is made)."""
    acc = None
    for leaf in tree.values():
        x = torch.as_tensor(leaf).detach()
        if not x.is_floating_point():
            x = x.to(torch.float32)
        part = torch.stack([torch.linalg.vector_norm(x, dtype=torch.float32).square(),
                            _count(torch.isnan(x)), _count(torch.isinf(x))])
        acc = part if acc is None else acc + part
    if acc is None:
        return torch.zeros(3, dtype=torch.float32)
    return acc


def client_stat(tree: StateDict, session: "WatchSession") -> torch.Tensor:
    """One arriving tree's device stat row ``[4 + G]`` against the session's
    reference: the async quarantine screen."""
    from ..aggregation.bucketed import flat_f32

    return session.block_from_flat(flat_f32(_as_state_dict(tree))[None])[0]


def train_guard(params: StateDict) -> torch.Tensor:
    """NaN guard and global param norm for the LLM trainer's window end: the
    device ``[sq_norm, nan, inf]`` vector in f32, leaf by leaf. The caller
    reads it after a sync it already makes."""
    return _tree_sums(params)


# ---------------------------------------------------------------------------
# watch session: device-side stat collection for one fold window
# ---------------------------------------------------------------------------

class RoundStats:
    """Host-side result of one watched fold window."""

    def __init__(self, rows: List[Dict[str, Any]], agg: Dict[str, Any],
                 update_tree: Any, groups: List[str]):
        self.rows = rows          # one dict per client, aligned to fold order
        self.agg = agg            # published-aggregate stats
        self.update_tree = update_tree  # device (published - ref): next prev
        self.groups = groups

    def by_rank(self) -> Dict[Any, Dict[str, Any]]:
        return {r["rank"]: r for r in self.rows}


class WatchSession:
    """Collects per-bucket stat blocks for one fold window, fetched once.

    ``ref`` is the running aggregate (the current global params) the client
    deltas are measured against, a state dict or a nested flax-layout tree;
    its flat f32 copy is built once, and moved once to the device of the
    first block that lands on another (a host-held global, device uploads).
    Each dtype group's column runs come from the leaves' sizes, on the host
    in O(leaves). ``prev_update`` is the previous window's published update
    direction (the ``update_tree`` of the last :meth:`finish`), for the
    aggregate cosine-drift series."""

    def __init__(self, ref: StateDict, prev_update: Any = None):
        from ..aggregation.bucketed import flat_f32

        if has_object_leaves(ref):
            raise TypeError("modelwatch needs tensor leaves; object leaves (FHE ciphertexts) "
                            "have no delta statistics")
        self.ref = _as_tensor_tree(ref)
        self.prev_update = prev_update
        self.groups = group_labels(self.ref)
        self.ref_flat = flat_f32(self.ref)
        self.group_slices: Optional[List[List[Tuple[int, int]]]] = None
        if len(self.groups) > 1:
            index = {g: i for i, g in enumerate(self.groups)}
            runs: List[List[Tuple[int, int]]] = [[] for _ in self.groups]
            off = 0
            for leaf in self.ref.values():
                g, n = runs[index[_dtype_name(leaf)]], leaf.numel()
                if g and g[-1][1] == off:  # the group's run goes on
                    g[-1] = (g[-1][0], off + n)
                else:
                    g.append((off, off + n))
                off += n
            self.group_slices = runs
        self._blocks: List[torch.Tensor] = []   # [bucket, 4+G] device tensors
        self._real: List[int] = []              # non-pad rows per block
        self.ranks: Optional[List[Any]] = None
        self.quarantined: Dict[Any, Dict[str, Any]] = {}

    def block_from_flat(self, flat_chunk: torch.Tensor) -> torch.Tensor:
        if flat_chunk.shape[-1] != self.ref_flat.numel():
            raise ValueError(f"modelwatch: an upload of {flat_chunk.shape[-1]} elements against "
                             f"a global model of {self.ref_flat.numel()}")
        if flat_chunk.device != self.ref_flat.device:
            self.ref_flat = self.ref_flat.to(flat_chunk.device)
        return block_stat_math(flat_chunk, self.ref_flat, self.group_slices)

    def add_block(self, block: torch.Tensor, real: int) -> None:
        self._blocks.append(block)
        self._real.append(int(real))

    def watch_block(self, chunk: Sequence[StateDict]) -> None:
        """Stats-only path (no fused fold): the bucket flattened once."""
        from ..aggregation.bucketed import flat_f32

        flat = torch.stack([flat_f32(_as_state_dict(t)) for t in chunk])
        self.add_block(self.block_from_flat(flat), len(chunk))

    @property
    def n_clients(self) -> int:
        return sum(self._real)

    def peek_norms(self) -> np.ndarray:
        """Host-fetch ONLY the delta norms (quarantine needs them pre-fold).
        The full rows still ride the publish-time fetch."""
        if not self._blocks:
            return np.zeros((0,), np.float32)
        sq = torch.cat([b[:r, COL_SQ] for b, r in zip(self._blocks, self._real)]).cpu().numpy()
        with np.errstate(invalid="ignore"):
            return np.sqrt(np.maximum(sq, 0.0))

    def _aggregate_stats(self, published: StateDict) -> Tuple[torch.Tensor, StateDict]:
        """The ``[6]`` aggregate vector and the update tree (published - ref,
        f32 views of one flat vector), on the device."""
        from ..aggregation.bucketed import flat_f32

        pub = flat_f32(_as_tensor_tree(published, self.ref_flat.device))
        upd = pub - self.ref_flat
        prev = self.ref_flat if self.prev_update is None else flat_f32(self.prev_update)
        vec = torch.stack([
            torch.dot(upd, upd),
            torch.isnan(pub).sum().to(torch.float32),
            torch.isinf(pub).sum().to(torch.float32),
            torch.dot(upd, prev),
            torch.dot(prev, prev),
            torch.dot(self.ref_flat, self.ref_flat),
        ])
        tree, off = {}, 0
        for name, leaf in self.ref.items():
            n = leaf.numel()
            tree[name] = upd[off:off + n].view(leaf.shape)
            off += n
        return vec, tree

    def finish(self, published: StateDict) -> RoundStats:
        """Fetch every stat in one device-to-host copy and derive the
        per-client rows and the aggregate stats."""
        has_prev = self.prev_update is not None
        vec_dev, upd_tree = self._aggregate_stats(published)
        n_cols = N_FIXED_COLS + len(self.groups)
        parts = [b[:r].reshape(-1) for b, r in zip(self._blocks, self._real)]
        host = torch.cat([vec_dev] + parts).cpu().numpy().astype(np.float64)
        vec = host[:6]
        rows_np = host[6:].reshape(-1, n_cols)
        ref_norm = math.sqrt(max(float(vec[_AGG_REF_SQ]), 0.0))
        ranks = self.ranks if self.ranks is not None else list(range(len(rows_np)))
        rows: List[Dict[str, Any]] = []
        for i, raw in enumerate(rows_np):
            sq = float(raw[COL_SQ])
            norm = math.sqrt(sq) if sq >= 0.0 else float("nan")
            denom = norm * ref_norm
            cosine = float(raw[COL_DOT]) / denom if denom > 0.0 and math.isfinite(denom) else 0.0
            rows.append({
                "rank": ranks[i] if i < len(ranks) else i,
                "norm": norm,
                "cosine": cosine if math.isfinite(cosine) else 0.0,
                "update_ratio": (norm / ref_norm) if ref_norm > 0.0 else 0.0,
                "nan": int(raw[COL_NAN]),
                "inf": int(raw[COL_INF]),
                "group_norms": {
                    g: math.sqrt(max(float(raw[N_FIXED_COLS + k]), 0.0))
                    for k, g in enumerate(self.groups)},
                "quarantined": False,
            })
        # sync screening watches the WHOLE cohort before dropping outliers,
        # so a quarantined rank usually already has a stat row: mark it in
        # place; only async-style quarantines (no watch row) append one
        by_rank = {r["rank"]: r for r in rows}
        for rank, qrow in self.quarantined.items():
            existing = by_rank.get(rank)
            if existing is not None:
                existing["quarantined"] = True
                existing["z"] = qrow.get("z")
            else:
                rows.append(dict(qrow, rank=rank, quarantined=True))
        upd_norm = math.sqrt(max(float(vec[_AGG_SQ]), 0.0))
        prev_norm = math.sqrt(max(float(vec[_AGG_PREV_SQ]), 0.0))
        cos_prev: Optional[float] = None
        if has_prev and upd_norm > 0.0 and prev_norm > 0.0:
            c = float(vec[_AGG_DOT_PREV]) / (upd_norm * prev_norm)
            cos_prev = c if math.isfinite(c) else None
        agg = {
            "update_norm": upd_norm,
            "nan": int(vec[_AGG_NAN]) if math.isfinite(vec[_AGG_NAN]) else 0,
            "inf": int(vec[_AGG_INF]) if math.isfinite(vec[_AGG_INF]) else 0,
            "cosine_prev": cos_prev,
            "ref_norm": ref_norm,
            "update_ratio": (upd_norm / ref_norm) if ref_norm > 0.0 else 0.0,
        }
        return RoundStats(rows, agg, upd_tree, self.groups)


def outlier_verdicts(norms: Sequence[float],
                     threshold: Optional[float] = None,
                     min_cohort: int = MIN_COHORT) -> Tuple[List[float], List[bool]]:
    """Robust z-scores and one-sided outlier flags over a cohort's delta
    norms: ``z = 0.6745 (x - med)/MAD``, flagged at ``z >= threshold`` AND
    above the median (a small update is not hostile). Non-finite norms (a
    NaN delta) always flag. Cohorts under ``min_cohort`` finite members
    never flag on z alone."""
    thr = z_threshold() if threshold is None else float(threshold)
    finite = [float(n) for n in norms if math.isfinite(n)]
    zs: List[float] = []
    flags: List[bool] = []
    med = mad = 0.0
    if len(finite) >= min_cohort:
        med, mad, _ = robust_zscores(finite)
    for n in norms:
        n = float(n)
        if not math.isfinite(n):
            zs.append(float("inf"))
            flags.append(True)
            continue
        z = MAD_TO_SIGMA * (n - med) / mad if mad > 0.0 else 0.0
        zs.append(z)
        flags.append(len(finite) >= min_cohort and z >= thr and n > med)
    return zs, flags


def screen_cohort(session: WatchSession,
                  pairs: Sequence[Tuple[float, StateDict]],
                  ranks: Optional[Sequence[Any]] = None,
                  *,
                  ledger: Optional["ContributionLedger"] = None,
                  quarantine: bool = False,
                  bucket_size: int = 16) -> List[Tuple[float, StateDict]]:
    """Compute per-client stats for a sync cohort; optionally quarantine.

    Stats-only blocks of at most ``bucket_size`` trees, each at its real
    length: JAX pads a short bucket with copies of its last tree to keep
    XLA's shapes fixed, which eager PyTorch does not need (stats stay on the
    device: no sync unless ``quarantine``). With
    ``quarantine``, delta norms are fetched before the fold, and robust-z
    outliers and NaN deltas are dropped from the returned pairs: counted,
    recorded on the session and the ledger, never silently folded. With
    quarantine off the pairs come back unchanged."""
    pairs = list(pairs)
    ranks = list(ranks) if ranks is not None else list(range(len(pairs)))
    if not pairs:
        return pairs
    trees = [t for _, t in pairs]
    if has_object_leaves(trees[0]):
        return pairs  # object leaves (FHE ciphertexts): no tensor stats
    b = max(1, int(bucket_size))
    for start in range(0, len(trees), b):
        session.watch_block(trees[start:start + b])
    session.ranks = ranks
    if not quarantine:
        return pairs
    norms = session.peek_norms()
    zs, flags = outlier_verdicts(list(norms))
    kept: List[Tuple[float, StateDict]] = []
    for i, pair in enumerate(pairs):
        if flags[i]:
            row = {"norm": float(norms[i]), "z": float(zs[i])}
            session.quarantined[ranks[i]] = row
            if ledger is not None:
                ledger.note_quarantined(ranks[i], float(norms[i]), float(zs[i]))
        else:
            kept.append(pair)
    if session.quarantined and not kept:
        # an all-outlier cohort must still publish something: refuse to
        # quarantine everyone and fold the original cohort instead
        log.warning("modelwatch: quarantine would drop the ENTIRE cohort; folding all")
        session.quarantined.clear()
        return pairs
    return kept


# ---------------------------------------------------------------------------
# contribution ledger
# ---------------------------------------------------------------------------

class ContributionLedger:
    """Per-client contribution and outlier state fed from fold-boundary
    stats.

    EWMA-smoothed delta norms give each rank a *contribution share* (its
    EWMA norm over the cohort's sum); per-round robust z-scores over the raw
    norms give the *outlier score*. Thread-safe leaf lock (taken after any
    caller's locks, never the reverse)."""

    EWMA_ALPHA = 0.3  # the health tracker's and netlink's smoothing

    def __init__(self, alpha: float = EWMA_ALPHA):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._clients: Dict[Any, Dict[str, Any]] = {}
        self._recent_norms: deque = deque(maxlen=64)
        self._agg: Dict[str, Any] = {}
        self._baseline_norm: Optional[float] = None  # trailing EWMA of agg update norm
        self.rounds = 0
        self.quarantined_total = 0
        self._quarantined_since_round = 0
        self.nan_rounds = 0
        self.last_outlier_rate = 0.0
        # the owning FleetTelemetry's FleetSketches: delta norms and outlier
        # flags fold into the fleet quantile/rate sketches, so the signal
        # survives the per-rank families degrading above the budget
        self.sketches = None

    def _row(self, rank: Any) -> Dict[str, Any]:
        return self._clients.setdefault(rank, {
            "norm": 0.0, "ewma_norm": None, "share": 0.0, "z": 0.0,
            "outlier": False, "cosine": 0.0, "update_ratio": 0.0,
            "nan": 0, "inf": 0, "rounds": 0, "quarantined": 0,
        })

    # --- streaming (async submit) path -----------------------------------
    def streaming_z(self, norm: float) -> float:
        """Robust z of one arriving delta norm against the recent window:
        the async front's quarantine signal (no cohort barrier to wait on)."""
        if not math.isfinite(norm):
            return float("inf")
        with self._lock:
            window = [n for n in self._recent_norms if math.isfinite(n)]
        if len(window) < MIN_COHORT:
            return 0.0
        med, mad, _ = robust_zscores(window)
        if mad <= 0.0:
            return 0.0
        return MAD_TO_SIGMA * (float(norm) - med) / mad

    def observe_stream_norm(self, norm: float) -> None:
        """Admit one accepted arrival's norm into the streaming-z window."""
        if math.isfinite(norm):
            with self._lock:
                self._recent_norms.append(float(norm))

    def note_quarantined(self, rank: Any, norm: float, z: float) -> None:
        with self._lock:
            row = self._row(rank)
            row["quarantined"] += 1
            row["norm"] = float(norm)
            row["z"] = float(z)
            row["outlier"] = True
            self.quarantined_total += 1
            self._quarantined_since_round += 1
        get_telemetry().counter("modelwatch.quarantined").add(1)
        flight_recorder.mark("modelwatch_quarantine", rank=rank, norm=float(norm), z=float(z))

    # --- round close ------------------------------------------------------
    def observe_round(self, round_idx: Any, stats: RoundStats) -> Dict[str, Any]:
        """Fold one window's stats in: update the ledger, feed the tsdb
        series the SLO pack watches, and drop a flight-recorder breadcrumb
        when anything anomalous showed up."""
        folded = [r for r in stats.rows if not r.get("quarantined")]
        norms = [r.get("norm", float("nan")) for r in folded]
        zs, flags = outlier_verdicts(norms)
        n_out = sum(1 for f in flags if f)
        q_rows = len(stats.rows) - len(folded)
        agg = stats.agg
        nan_total = int(agg.get("nan", 0)) + int(agg.get("inf", 0))
        with self._lock:
            # async quarantines happen at submit and never reach the session
            # rows; the sync screen marks them IN the rows: count whichever
            # view is larger, never both
            q_extra = max(0, self._quarantined_since_round - q_rows)
            self._quarantined_since_round = 0
            total = len(stats.rows) + q_extra
            rate = (n_out + q_rows + q_extra) / total if total else 0.0
            self.rounds += 1
            for i, r in enumerate(folded):
                row = self._row(r["rank"])
                row["rounds"] += 1
                norm = r.get("norm", 0.0)
                row["norm"] = norm
                row["cosine"] = r.get("cosine", 0.0)
                row["update_ratio"] = r.get("update_ratio", 0.0)
                row["nan"] = r.get("nan", 0)
                row["inf"] = r.get("inf", 0)
                row["z"] = zs[i]
                row["outlier"] = flags[i]
                if math.isfinite(norm):
                    prev = row["ewma_norm"]
                    row["ewma_norm"] = (norm if prev is None
                                        else (1 - self.alpha) * prev + self.alpha * norm)
                    self._recent_norms.append(norm)
            total_ewma = sum(row["ewma_norm"] for row in self._clients.values()
                             if row["ewma_norm"] is not None)
            for row in self._clients.values():
                row["share"] = (row["ewma_norm"] / total_ewma
                                if row["ewma_norm"] is not None and total_ewma > 0.0
                                else 0.0)
            self.last_outlier_rate = rate
            upd_norm = float(agg.get("update_norm", 0.0))
            ratio = None
            if math.isfinite(upd_norm) and nan_total == 0:
                if self._baseline_norm is not None and self._baseline_norm > 0.0:
                    ratio = upd_norm / self._baseline_norm
                self._baseline_norm = (upd_norm if self._baseline_norm is None
                                       else (1 - self.alpha) * self._baseline_norm
                                       + self.alpha * upd_norm)
            cos_prev = agg.get("cosine_prev")
            self._agg = {
                "round": round_idx,
                "update_norm": upd_norm,
                "nan": int(agg.get("nan", 0)),
                "inf": int(agg.get("inf", 0)),
                "divergence_ratio": ratio,
                "cosine_prev": cos_prev,
                "update_ratio": agg.get("update_ratio", 0.0),
                "outliers": [folded[i]["rank"] for i, f in enumerate(flags) if f],
            }
            if nan_total:
                self.nan_rounds += 1
        if nan_total:
            get_telemetry().counter("modelwatch.nan_rounds").add(1)
        if self.sketches is not None:
            for i, r in enumerate(folded):
                self.sketches.observe_delta_norm(
                    r["rank"], r.get("norm", float("nan")), outlier=bool(flags[i]))
        store = tsdb.active()
        if store is not None:
            store.record_gauge("modelwatch.nan_count", float(nan_total))
            if math.isfinite(upd_norm):
                store.record_gauge("modelwatch.agg_update_norm", upd_norm)
            if ratio is not None:
                store.record_gauge("modelwatch.divergence_ratio", float(ratio))
            if cos_prev is not None:
                store.record_gauge("modelwatch.cosine_drift", 1.0 - float(cos_prev))
            store.record_gauge("modelwatch.outlier_rate", float(rate))
        if self._agg.get("outliers") or nan_total:
            flight_recorder.mark(
                "modelwatch", round=round_idx, nan=int(agg.get("nan", 0)),
                inf=int(agg.get("inf", 0)),
                outliers=list(self._agg.get("outliers") or []),
                quarantined=sorted(r["rank"] for r in stats.rows if r.get("quarantined")),
                update_norm=upd_norm)
        return dict(self._agg)

    # --- surfaces ---------------------------------------------------------
    def prom_gauges(self) -> List[Tuple[str, Dict[str, str], float]]:
        """Same triple shape as ``HealthTracker.prom_gauges``. The three
        per-rank families consult the telemetry cardinality budget as one
        unit and degrade to the fleet sketch summaries when it trips."""
        from . import sketches as _sketches

        out: List[Tuple[str, Dict[str, str], float]] = []
        with self._lock:
            n_ranks = len(self._clients)
        if not _sketches.get_budget().admit("client_ledger", 3 * n_ranks):
            return out
        with self._lock:
            for rank, row in sorted(self._clients.items(), key=lambda kv: str(kv[0])):
                labels = {"rank": str(rank)}
                norm = row["norm"]
                out.append(("client_delta_norm", labels,
                            float(norm) if math.isfinite(norm) else -1.0))
                out.append(("client_contribution", labels, float(row["share"])))
                z = row["z"]
                out.append(("client_outlier_score", labels,
                            float(z) if math.isfinite(z) else -1.0))
        return out

    def statusz_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            clients = {}
            for rank, row in self._clients.items():
                clients[str(rank)] = {
                    "norm": _safe(row["norm"]),
                    "ewma_norm": _safe(row["ewma_norm"]),
                    "share": round(row["share"], 6),
                    "z": _safe(row["z"]),
                    "outlier": row["outlier"],
                    "cosine": _safe(row["cosine"]),
                    "update_ratio": _safe(row["update_ratio"]),
                    "nan": row["nan"], "inf": row["inf"],
                    "rounds": row["rounds"], "quarantined": row["quarantined"],
                }
            return {
                "rounds": self.rounds,
                "clients": clients,
                "aggregate": _safe_agg(self._agg),
                "outlier_rate": self.last_outlier_rate,
                "quarantined_total": self.quarantined_total,
                "nan_rounds": self.nan_rounds,
                "z_threshold": z_threshold(),
            }

    def annotate_report(self, report: Dict[str, Any]) -> Dict[str, Any]:
        """Ride the per-round ``HealthReport`` with the ledger's view."""
        with self._lock:
            report["modelwatch"] = {
                "aggregate": _safe_agg(self._agg),
                "outlier_rate": self.last_outlier_rate,
                "clients": {str(r): {"norm": _safe(row["norm"]),
                                     "share": round(row["share"], 6),
                                     "z": _safe(row["z"]),
                                     "outlier": row["outlier"]}
                            for r, row in self._clients.items()},
            }
        return report

    def alert_context(self, spec: Any) -> Optional[Dict[str, Any]]:
        """SLO alert-context provider: the offending clients' stat rows ride
        the auto-captured flight-recorder snapshot for modelwatch alerts."""
        series = getattr(spec, "series", "")
        if not str(series).startswith("modelwatch."):
            return None
        with self._lock:
            rows = []
            for rank, row in sorted(self._clients.items(),
                                    key=lambda kv: -(kv[1]["z"] if math.isfinite(kv[1]["z"])
                                                     else 1e18)):
                rows.append({"rank": str(rank), "norm": _safe(row["norm"]),
                             "z": _safe(row["z"]), "outlier": row["outlier"],
                             "nan": row["nan"], "inf": row["inf"],
                             "quarantined": row["quarantined"],
                             "verdict": ("quarantined" if row["quarantined"]
                                         else "outlier" if row["outlier"] else "ok")})
            return {"clients": rows[:16], "aggregate": _safe_agg(self._agg)}


def _safe(v: Any) -> Any:
    """JSON-safe float: NaN/Inf become strings, None passes through."""
    if v is None:
        return None
    try:
        f = float(v)
    except (TypeError, ValueError):
        return v
    if math.isfinite(f):
        return round(f, 6)
    return repr(f)


def _safe_agg(agg: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _safe(v) if isinstance(v, float) else v for k, v in agg.items()}


# ---------------------------------------------------------------------------
# active-ledger registry (slo.py's engine pattern): the statusz and prom
# surfaces render whatever ledger the running front registered
# ---------------------------------------------------------------------------

_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional[ContributionLedger] = None


def set_active(ledger: Optional[ContributionLedger]) -> None:
    """Register the process's live ledger (and its SLO alert-context hook)."""
    global _ACTIVE
    from . import slo

    with _ACTIVE_LOCK:
        prev = _ACTIVE
        _ACTIVE = ledger
    if prev is not None:
        slo.unregister_alert_context(prev.alert_context)
    if ledger is not None:
        slo.register_alert_context(ledger.alert_context)


def clear_active(ledger: Optional[ContributionLedger] = None) -> None:
    """Deactivate (only if ``ledger`` is the active one, when given)."""
    global _ACTIVE
    from . import slo

    with _ACTIVE_LOCK:
        if ledger is not None and _ACTIVE is not ledger:
            return
        prev = _ACTIVE
        _ACTIVE = None
    if prev is not None:
        slo.unregister_alert_context(prev.alert_context)


def get_active() -> Optional[ContributionLedger]:
    with _ACTIVE_LOCK:
        return _ACTIVE


def statusz_snapshot() -> Dict[str, Any]:
    ledger = get_active()
    return ledger.statusz_snapshot() if ledger is not None and ledger.rounds else {}


def prom_gauges() -> List[Tuple[str, Dict[str, str], float]]:
    ledger = get_active()
    return ledger.prom_gauges() if ledger is not None else []
