"""Mergeable fleet-telemetry sketches: bounded memory at million-client scale.

A copy of ``fedml_tpu/core/telemetry/sketches.py``, whole: the standard
library and numpy only, the same hashing, the same ``WIRE_VERSION`` and the
same bytes, so a JAX tier's sketch wire merges into a port tier and the
reverse. The port's server wires none of the ``/metrics``, ``/statusz`` and
tsdb riders yet (ROADMAP.md, Queue 1); the hierarchy feeds the sketches.

Every per-client surface the tree grew so far — ``fedml_client_health{rank}``,
the modelwatch ledger's per-rank gauges, per-client Perfetto lanes — is
O(clients) in memory, exposition bytes, and tsdb series. That is fine for a
cross-silo cohort of 16 and collapses at the ROADMAP's million-client
cross-device target. This module is the standard fleet-monitoring fix:
**mergeable streaming sketches** that summarize at the edge and compose
upward through the aggregation hierarchy exactly like model deltas do.

Three sketch types, all with associative+commutative ``merge()`` and compact
bytes serialization (so a summary rides the existing per-publish message —
no new round trips, no new message vocabulary):

- :class:`QuantileSketch` — DDSketch-style log-bucketed histogram with a
  guaranteed relative error ≤ ``alpha`` (default 1%) at every quantile and a
  bounded bucket count (~few KB regardless of observation count).
- :class:`TopK` — count-min sketch + candidate heap: the top-k "offender"
  keys by cumulative weight (e.g. slowest ranks by total round time).
- :class:`CardinalitySketch` — HyperLogLog distinct-count (distinct clients
  seen) in ``2**p`` one-byte registers.

:class:`FleetSketches` bundles the fleet families (round time, delta norm,
staleness) plus offenders and cardinality behind one observe/merge/wire API,
and :class:`TelemetryCardinalityBudget` bounds what the exposition side may
emit as *labeled* series: per-rank gauge families consult ``admit()`` and
degrade to the fleet sketch summaries when the budget trips. Below the
exact-mode threshold (:func:`exact_threshold`) nothing degrades and the
per-rank surfaces stay bit-for-bit what they were — small cross-silo runs
keep today's fidelity.

Determinism: all hashing is seeded splitmix64 (no process-randomized
``hash()``), so sketches built in different processes merge coherently and
edge-merged ≡ flat-merged holds exactly (bucket-for-bucket), not just
approximately.
"""

from __future__ import annotations

import base64
import hashlib
import math
import os
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "CardinalitySketch",
    "FleetSketches",
    "QuantileSketch",
    "TelemetryCardinalityBudget",
    "TopK",
    "active_snapshot",
    "exact_threshold",
    "get_active",
    "get_budget",
    "prom_gauges",
    "reset",
    "set_active_provider",
    "tsdb_collector",
]

# below this many distinct ranks the per-rank surfaces keep exact, unbounded
# fidelity; at or above it the fleet path switches to sketch-only accounting
DEFAULT_EXACT_THRESHOLD = 256

# the quantiles every fleet surface exposes (prom label q="0.5" etc.)
FLEET_QUANTILES = (0.5, 0.9, 0.99, 0.999)

# labeled series the offender surfaces may emit per family — the "k" in
# top-k; deliberately small (a dashboard shows ~a dozen worst ranks, never
# a million)
DEFAULT_TOPK = 16

_U64 = np.uint64
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _mix64_int(x: int) -> int:
    """splitmix64 finalizer on a Python int (matches :func:`_mix64_np`)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _mix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over a uint64 array."""
    with np.errstate(over="ignore"):
        x = (x + _U64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def _key_to_int(key: Any) -> int:
    """Stable 64-bit integer for a sketch key (rank int or string name)."""
    if isinstance(key, bool):  # bool is an int subclass; keep it distinct
        key = int(key)
    if isinstance(key, (int, np.integer)):
        return int(key) & _MASK64
    digest = hashlib.blake2b(str(key).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little")


def _bit_length_np(x: np.ndarray) -> np.ndarray:
    """Exact vectorized bit_length for uint64 (no float round-off)."""
    bl = np.zeros(x.shape, dtype=np.int64)
    cur = x.copy()
    for s in (32, 16, 8, 4, 2, 1):
        y = cur >> _U64(s)
        has = y != 0
        bl += np.where(has, s, 0)
        cur = np.where(has, y, cur)
    return bl + (cur != 0)


# --- quantile sketch ---------------------------------------------------------
class QuantileSketch:
    """Log-bucketed quantile sketch (DDSketch family) for non-negative values.

    A value ``v`` lands in bucket ``ceil(log_gamma(v))`` with
    ``gamma = (1+alpha)/(1-alpha)``; reporting the bucket's log-midpoint
    bounds the relative error of every quantile estimate by ``alpha``.
    Values below ``min_value`` (and any non-finite/negative input) count in
    the zero bucket. When the sparse bucket map outgrows ``max_bins`` the
    LOWEST buckets collapse together — high quantiles (the tails SLOs watch)
    keep full accuracy.

    ``merge`` is exact bucket-wise addition: associative, commutative, and
    bit-deterministic, so hierarchy-merged equals flat-merged.
    """

    MAGIC = b"FQS1"

    def __init__(self, alpha: float = 0.01, min_value: float = 1e-9,
                 max_bins: int = 1024):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = float(alpha)
        self.min_value = float(min_value)
        self.max_bins = int(max_bins)
        self.gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self._inv_log_gamma = 1.0 / math.log(self.gamma)
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.zero_count = 0
        self.min = math.inf
        self.max = -math.inf
        self.sum = 0.0

    # -- write side --------------------------------------------------------
    def add(self, value: float, count: int = 1) -> None:
        v = float(value)
        if not math.isfinite(v) or v < self.min_value:
            self.zero_count += count
            self.count += count
            if math.isfinite(v):
                self.min = min(self.min, max(v, 0.0))
                self.max = max(self.max, max(v, 0.0))
                self.sum += max(v, 0.0) * count
            return
        idx = math.ceil(math.log(v) * self._inv_log_gamma)
        self._buckets[idx] = self._buckets.get(idx, 0) + count
        self.count += count
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.sum += v * count
        if len(self._buckets) > self.max_bins:
            self._collapse()

    def add_many(self, values: np.ndarray) -> None:
        """Vectorized ingest: one numpy pass for a whole cohort's values."""
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        finite = np.isfinite(v)
        small = finite & (v < self.min_value)
        ok = finite & ~small
        n_zero = int(small.sum()) + int((~finite).sum())
        if n_zero:
            self.zero_count += n_zero
            self.count += n_zero
            clamped = np.clip(v[small], 0.0, None)
            if clamped.size:
                self.min = min(self.min, float(clamped.min()))
                self.max = max(self.max, float(clamped.max()))
                self.sum += float(clamped.sum())
        vv = v[ok]
        if vv.size:
            idx = np.ceil(np.log(vv) * self._inv_log_gamma).astype(np.int64)
            uniq, cnt = np.unique(idx, return_counts=True)
            for i, c in zip(uniq.tolist(), cnt.tolist()):
                self._buckets[i] = self._buckets.get(i, 0) + c
            self.count += int(vv.size)
            self.min = min(self.min, float(vv.min()))
            self.max = max(self.max, float(vv.max()))
            self.sum += float(vv.sum())
            if len(self._buckets) > self.max_bins:
                self._collapse()

    def _collapse(self) -> None:
        # fold the lowest buckets together until the map fits; tails stay exact
        keys = sorted(self._buckets)
        while len(keys) > self.max_bins:
            lowest = keys.pop(0)
            self._buckets[keys[0]] = (self._buckets.get(keys[0], 0)
                                      + self._buckets.pop(lowest))

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        if not isinstance(other, QuantileSketch):
            raise TypeError(f"cannot merge QuantileSketch with {type(other)!r}")
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"alpha mismatch: {self.alpha} vs {other.alpha} — sketches must "
                "share bucket geometry to merge")
        for idx, c in other._buckets.items():
            self._buckets[idx] = self._buckets.get(idx, 0) + c
        self.count += other.count
        self.zero_count += other.zero_count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.sum += other.sum
        if len(self._buckets) > self.max_bins:
            self._collapse()
        return self

    def copy(self) -> "QuantileSketch":
        out = QuantileSketch(self.alpha, self.min_value, self.max_bins)
        out._buckets = dict(self._buckets)
        out.count, out.zero_count = self.count, self.zero_count
        out.min, out.max, out.sum = self.min, self.max, self.sum
        return out

    # -- read side ---------------------------------------------------------
    def _bucket_value(self, idx: int) -> float:
        # log-midpoint of (gamma^(i-1), gamma^i]: rel err <= alpha by design
        return (self.gamma ** idx) * 2.0 / (1.0 + self.gamma)

    def quantile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return float("nan")
        if q <= 0.0:
            return self.min if math.isfinite(self.min) else 0.0
        if q >= 1.0:
            return self.max if math.isfinite(self.max) else 0.0
        target = q * self.count
        seen = self.zero_count
        if seen >= target:
            return 0.0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= target:
                est = self._bucket_value(idx)
                # min/max clamp keeps the edges honest for tiny counts
                return min(max(est, self.min), self.max)
        return self.max if math.isfinite(self.max) else 0.0

    def quantiles(self, qs: Sequence[float] = FLEET_QUANTILES) -> Dict[str, float]:
        return {_q_label(q): self.quantile(q) for q in qs}

    def fraction_above(self, threshold: float) -> float:
        """Fraction of observed mass strictly above ``threshold`` (bucket
        granularity — rel err ≤ alpha on the cut point)."""
        if self.count == 0:
            return 0.0
        if threshold < self.min_value:
            return (self.count - self.zero_count) / self.count
        cut = math.ceil(math.log(threshold) * self._inv_log_gamma)
        above = sum(c for idx, c in self._buckets.items() if idx > cut)
        return above / self.count

    def bucket_items(self) -> List[Tuple[int, int]]:
        return sorted(self._buckets.items())

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    # struct "<iQ" is unpadded (12B/pair); this dtype matches it bit-for-bit
    # so the bucket body serializes in ONE numpy pass (forwarding rides every
    # hierarchy publish — a per-entry python loop would dominate the hop)
    _PAIR_DTYPE = np.dtype({"names": ["idx", "count"],
                            "formats": ["<i4", "<u8"],
                            "offsets": [0, 4], "itemsize": 12})

    # -- wire --------------------------------------------------------------
    def to_bytes(self) -> bytes:
        items = sorted(self._buckets.items())
        head = struct.pack(
            "<4sdQQdddI", self.MAGIC, self.alpha, self.count, self.zero_count,
            self.min if math.isfinite(self.min) else math.nan,
            self.max if math.isfinite(self.max) else math.nan,
            self.sum, len(items))
        body = np.empty(len(items), dtype=self._PAIR_DTYPE)
        if items:
            idxs, counts = zip(*items)
            body["idx"], body["count"] = idxs, counts
        return head + body.tobytes()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "QuantileSketch":
        head_n = struct.calcsize("<4sdQQdddI")
        magic, alpha, count, zero, mn, mx, total, n = struct.unpack(
            "<4sdQQdddI", raw[:head_n])
        if magic != cls.MAGIC:
            raise ValueError(f"bad QuantileSketch magic {magic!r}")
        out = cls(alpha=alpha)
        out.count, out.zero_count, out.sum = int(count), int(zero), float(total)
        out.min = float(mn) if not math.isnan(mn) else math.inf
        out.max = float(mx) if not math.isnan(mx) else -math.inf
        pairs = np.frombuffer(raw, dtype=cls._PAIR_DTYPE, count=int(n),
                              offset=head_n)
        out._buckets = dict(zip(pairs["idx"].tolist(), pairs["count"].tolist()))
        return out

    def nbytes(self) -> int:
        return len(self.to_bytes())

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, QuantileSketch)
                and self.alpha == other.alpha
                and self.count == other.count
                and self.zero_count == other.zero_count
                and self._buckets == other._buckets)

    __hash__ = None  # mutable


# --- heavy hitters -----------------------------------------------------------
class TopK:
    """Count-min sketch + candidate map: top-k keys by cumulative weight.

    The count-min table bounds over-estimation (never under-estimates); the
    candidate map keeps the ``4*k`` best keys seen so far so ``topk()`` needs
    no full-key scan. Merging adds the tables element-wise and re-estimates
    the union of candidates against the merged table. Keys must be integers
    (ranks) or strings (hashed to a stable 64-bit id).
    """

    MAGIC = b"FTK1"

    def __init__(self, k: int = DEFAULT_TOPK, depth: int = 4, width: int = 1024,
                 seed: int = 0x5EED):
        self.k = int(k)
        self.depth = int(depth)
        self.width = int(width)
        self.seed = int(seed) & _MASK64
        self.table = np.zeros((self.depth, self.width), dtype=np.float64)
        self._salts = [_mix64_int(self.seed + 0x100 + i) for i in range(self.depth)]
        self._cand: Dict[int, float] = {}
        self.total = 0.0

    def _geometry(self) -> Tuple[int, int, int, int]:
        return (self.k, self.depth, self.width, self.seed)

    def add(self, key: Any, weight: float = 1.0) -> None:
        w = float(weight)
        if not math.isfinite(w) or w <= 0.0:
            return
        ki = _key_to_int(key)
        est = math.inf
        for row, salt in enumerate(self._salts):
            col = _mix64_int(ki ^ salt) % self.width
            self.table[row, col] += w
            est = min(est, self.table[row, col])
        self.total += w
        self._note_candidate(ki, est)

    def add_many(self, keys: np.ndarray, weights: np.ndarray) -> None:
        ki = np.asarray(keys, dtype=np.uint64).ravel()
        w = np.asarray(weights, dtype=np.float64).ravel()
        if ki.size == 0:
            return
        ok = np.isfinite(w) & (w > 0.0)
        ki, w = ki[ok], w[ok]
        if ki.size == 0:
            return
        est = np.full(ki.shape, np.inf)
        for row, salt in enumerate(self._salts):
            with np.errstate(over="ignore"):
                cols = (_mix64_np(ki ^ _U64(salt)) % _U64(self.width)).astype(np.int64)
            self.table[row] += np.bincount(cols, weights=w, minlength=self.width)
            est = np.minimum(est, self.table[row, cols])
        self.total += float(w.sum())
        # candidates: only the heaviest UNIQUE keys of this batch can displace
        # the incumbent set (a hot key repeats thousands of times in a batch,
        # so slicing raw positions would fill the slice with one key)
        uniq_ki, first_pos = np.unique(ki, return_index=True)
        uest = est[first_pos]
        order = np.argsort(uest)[::-1][: 4 * self.k]
        for i in order.tolist():
            self._note_candidate(int(uniq_ki[i]), float(uest[i]))

    def _note_candidate(self, ki: int, est: float) -> None:
        cand = self._cand
        cand[ki] = max(cand.get(ki, 0.0), est)
        if len(cand) > 4 * self.k:
            keep = sorted(cand.items(), key=lambda kv: kv[1], reverse=True)[: 2 * self.k]
            self._cand = dict(keep)

    def estimate(self, key: Any) -> float:
        ki = _key_to_int(key)
        est = math.inf
        for row, salt in enumerate(self._salts):
            col = _mix64_int(ki ^ salt) % self.width
            est = min(est, self.table[row, col])
        return float(est)

    def topk(self) -> List[Tuple[int, float]]:
        """``[(key_int, estimated_weight), ...]`` heaviest first, ≤ k rows."""
        rows = [(ki, self.estimate(ki)) for ki in self._cand]
        rows.sort(key=lambda kv: (-kv[1], kv[0]))
        return rows[: self.k]

    def merge(self, other: "TopK") -> "TopK":
        if not isinstance(other, TopK):
            raise TypeError(f"cannot merge TopK with {type(other)!r}")
        if self._geometry() != other._geometry():
            raise ValueError(
                f"TopK geometry mismatch: {self._geometry()} vs "
                f"{other._geometry()} — sketches must share (k, depth, width, seed)")
        self.table += other.table
        self.total += other.total
        union = set(self._cand) | set(other._cand)
        self._cand = {}
        for ki in union:
            self._note_candidate(ki, self.estimate(ki))
        return self

    def copy(self) -> "TopK":
        out = TopK(self.k, self.depth, self.width, self.seed)
        out.table = self.table.copy()
        out._cand = dict(self._cand)
        out.total = self.total
        return out

    # matches repeated struct "<Qd" (16B/pair, no padding): the candidate
    # tail serializes in one numpy pass — see QuantileSketch._PAIR_DTYPE
    _CAND_DTYPE = np.dtype([("key", "<u8"), ("est", "<f8")])

    def to_bytes(self) -> bytes:
        cand = sorted(self._cand.items())
        head = struct.pack("<4sHHIQdI", self.MAGIC, self.k, self.depth,
                           self.width, self.seed, self.total, len(cand))
        body = self.table.astype("<f8").tobytes()
        tail = np.empty(len(cand), dtype=self._CAND_DTYPE)
        if cand:
            keys, ests = zip(*cand)
            tail["key"], tail["est"] = keys, ests
        return head + body + tail.tobytes()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "TopK":
        head_n = struct.calcsize("<4sHHIQdI")
        magic, k, depth, width, seed, total, n_cand = struct.unpack(
            "<4sHHIQdI", raw[:head_n])
        if magic != cls.MAGIC:
            raise ValueError(f"bad TopK magic {magic!r}")
        out = cls(k=k, depth=depth, width=width, seed=seed)
        body_n = depth * width * 8
        out.table = np.frombuffer(
            raw[head_n:head_n + body_n], dtype="<f8").reshape(depth, width).copy()
        out.total = float(total)
        pairs = np.frombuffer(raw, dtype=cls._CAND_DTYPE, count=int(n_cand),
                              offset=head_n + body_n)
        out._cand = dict(zip(pairs["key"].tolist(), pairs["est"].tolist()))
        return out

    def nbytes(self) -> int:
        return len(self.to_bytes())


# --- cardinality -------------------------------------------------------------
class CardinalitySketch:
    """HyperLogLog distinct-count over keys (distinct clients seen).

    ``2**p`` one-byte registers (p=12 → 4 KB, ~1.6% standard error) with the
    usual small-range linear-counting correction. Merge is register-wise max:
    associative, commutative, idempotent.
    """

    MAGIC = b"FHL1"

    def __init__(self, p: int = 12, seed: int = 0xCA5D):
        if not 4 <= p <= 16:
            raise ValueError(f"p must be in [4, 16], got {p}")
        self.p = int(p)
        self.m = 1 << self.p
        self.seed = int(seed) & _MASK64
        self.registers = np.zeros(self.m, dtype=np.uint8)

    def add(self, key: Any) -> None:
        # scalar fast path: pure int ops (the array path costs ~50us/call in
        # numpy small-array overhead; hot per-submit feeds ride this one)
        h = _mix64_int(_key_to_int(key) ^ self.seed)
        idx = h >> (64 - self.p)
        rest = (h << self.p) & _MASK64
        rho = min(64 - rest.bit_length() + 1, 64 - self.p + 1)
        if rho > self.registers[idx]:
            self.registers[idx] = rho

    def add_many(self, keys: np.ndarray) -> None:
        ki = np.asarray(keys, dtype=np.uint64).ravel()
        if ki.size == 0:
            return
        with np.errstate(over="ignore"):
            h = _mix64_np(ki ^ _U64(self.seed))
        idx = (h >> _U64(64 - self.p)).astype(np.int64)
        rest = (h << _U64(self.p)) & _U64(_MASK64)
        # rank = leading zeros of the remaining 64-p bits, + 1 (capped)
        rho = np.minimum(64 - _bit_length_np(rest) + 1, 64 - self.p + 1
                         ).astype(np.uint8)
        # per-register max via sort + reduceat (np.maximum.at is ~10x slower)
        order = np.argsort(idx, kind="stable")
        idx_s, rho_s = idx[order], rho[order]
        starts = np.flatnonzero(np.diff(idx_s, prepend=-1))
        reg_max = np.maximum.reduceat(rho_s, starts)
        uniq = idx_s[starts]
        self.registers[uniq] = np.maximum(self.registers[uniq], reg_max)

    def estimate(self) -> float:
        regs = self.registers.astype(np.float64)
        m = float(self.m)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        raw = alpha * m * m / float(np.sum(np.exp2(-regs)))
        zeros = int(np.count_nonzero(self.registers == 0))
        if raw <= 2.5 * m and zeros:
            return m * math.log(m / zeros)
        return raw

    def merge(self, other: "CardinalitySketch") -> "CardinalitySketch":
        if not isinstance(other, CardinalitySketch):
            raise TypeError(f"cannot merge CardinalitySketch with {type(other)!r}")
        if (self.p, self.seed) != (other.p, other.seed):
            raise ValueError(
                f"HLL geometry mismatch: p/seed {(self.p, self.seed)} vs "
                f"{(other.p, other.seed)}")
        np.maximum(self.registers, other.registers, out=self.registers)
        return self

    def copy(self) -> "CardinalitySketch":
        out = CardinalitySketch(self.p, self.seed)
        out.registers = self.registers.copy()
        return out

    def to_bytes(self) -> bytes:
        return (struct.pack("<4sBQ", self.MAGIC, self.p, self.seed)
                + self.registers.tobytes())

    @classmethod
    def from_bytes(cls, raw: bytes) -> "CardinalitySketch":
        head_n = struct.calcsize("<4sBQ")
        magic, p, seed = struct.unpack("<4sBQ", raw[:head_n])
        if magic != cls.MAGIC:
            raise ValueError(f"bad CardinalitySketch magic {magic!r}")
        out = cls(p=p, seed=seed)
        out.registers = np.frombuffer(
            raw[head_n:head_n + out.m], dtype=np.uint8).copy()
        return out

    def nbytes(self) -> int:
        return len(self.to_bytes())


# --- the fleet bundle --------------------------------------------------------
# the quantile families every FleetSketches carries, in wire order
FLEET_FAMILIES = ("round_time_s", "delta_norm", "staleness")

WIRE_VERSION = 1


class FleetSketches:
    """The fleet's sketch bundle: quantiles per family, top-k offenders (by
    cumulative round time), distinct-clients HLL, and a pair of plain
    counters (observations, outliers) for the rate surfaces.

    ``observe_ns`` self-accounts ingest+merge cost so the fleet_scale bench
    can prove the <1%-of-stage-wall overhead claim without a profiler.
    """

    def __init__(self, alpha: float = 0.01, k: int = DEFAULT_TOPK):
        self.quantiles: Dict[str, QuantileSketch] = {
            name: QuantileSketch(alpha=alpha) for name in FLEET_FAMILIES}
        self.offenders = TopK(k=k)
        self.clients = CardinalitySketch()
        self.observations = 0
        self.outliers = 0
        self.observe_ns = 0
        self.merge_ns = 0

    # -- write side --------------------------------------------------------
    def observe_round_time(self, rank: Any, seconds: float) -> None:
        t0 = time.perf_counter_ns()
        self.quantiles["round_time_s"].add(seconds)
        self.offenders.add(rank, seconds)
        self.clients.add(rank)
        self.observations += 1
        self.observe_ns += time.perf_counter_ns() - t0

    def observe_round_times(self, ranks: np.ndarray, seconds: np.ndarray) -> None:
        t0 = time.perf_counter_ns()
        ranks = np.asarray(ranks, dtype=np.uint64).ravel()
        seconds = np.asarray(seconds, dtype=np.float64).ravel()
        self.quantiles["round_time_s"].add_many(seconds)
        self.offenders.add_many(ranks, seconds)
        self.clients.add_many(ranks)
        self.observations += int(ranks.size)
        self.observe_ns += time.perf_counter_ns() - t0

    def observe_delta_norm(self, rank: Any, norm: float,
                           outlier: bool = False) -> None:
        t0 = time.perf_counter_ns()
        self.quantiles["delta_norm"].add(norm)
        self.clients.add(rank)
        if outlier:
            self.outliers += 1
        self.observe_ns += time.perf_counter_ns() - t0

    def observe_delta_norms(self, ranks: np.ndarray, norms: np.ndarray,
                            n_outliers: int = 0) -> None:
        t0 = time.perf_counter_ns()
        self.quantiles["delta_norm"].add_many(norms)
        self.clients.add_many(np.asarray(ranks, dtype=np.uint64))
        self.outliers += int(n_outliers)
        self.observe_ns += time.perf_counter_ns() - t0

    def observe_staleness(self, rank: Any, staleness: float) -> None:
        t0 = time.perf_counter_ns()
        self.quantiles["staleness"].add(staleness)
        self.clients.add(rank)
        self.observe_ns += time.perf_counter_ns() - t0

    def observe_stalenesses(self, ranks: np.ndarray, staleness: np.ndarray) -> None:
        t0 = time.perf_counter_ns()
        self.quantiles["staleness"].add_many(staleness)
        self.clients.add_many(np.asarray(ranks, dtype=np.uint64))
        self.observe_ns += time.perf_counter_ns() - t0

    # -- compose -----------------------------------------------------------
    def merge(self, other: "FleetSketches") -> "FleetSketches":
        t0 = time.perf_counter_ns()
        for name, sk in other.quantiles.items():
            mine = self.quantiles.get(name)
            if mine is None:
                self.quantiles[name] = sk.copy()
            else:
                mine.merge(sk)
        self.offenders.merge(other.offenders)
        self.clients.merge(other.clients)
        self.observations += other.observations
        self.outliers += other.outliers
        self.observe_ns += other.observe_ns
        self.merge_ns += (time.perf_counter_ns() - t0) + other.merge_ns
        return self

    def copy(self) -> "FleetSketches":
        out = FleetSketches.__new__(FleetSketches)
        out.quantiles = {n: s.copy() for n, s in self.quantiles.items()}
        out.offenders = self.offenders.copy()
        out.clients = self.clients.copy()
        out.observations = self.observations
        out.outliers = self.outliers
        out.observe_ns = self.observe_ns
        out.merge_ns = self.merge_ns
        return out

    # -- wire (rides the existing telemetry-delta message vocabulary) ------
    def to_wire(self) -> Dict[str, Any]:
        return {
            "v": WIRE_VERSION,
            "q": {name: base64.b64encode(sk.to_bytes()).decode("ascii")
                  for name, sk in self.quantiles.items()},
            "topk": base64.b64encode(self.offenders.to_bytes()).decode("ascii"),
            "hll": base64.b64encode(self.clients.to_bytes()).decode("ascii"),
            "c": {"observations": self.observations, "outliers": self.outliers,
                  "observe_ns": self.observe_ns, "merge_ns": self.merge_ns},
        }

    @classmethod
    def from_wire(cls, wire: Dict[str, Any]) -> "FleetSketches":
        if not isinstance(wire, dict) or int(wire.get("v", -1)) != WIRE_VERSION:
            raise ValueError(f"unsupported FleetSketches wire: {wire!r:.120}")
        out = cls.__new__(cls)
        out.quantiles = {
            str(name): QuantileSketch.from_bytes(base64.b64decode(b64))
            for name, b64 in dict(wire.get("q") or {}).items()}
        out.offenders = TopK.from_bytes(base64.b64decode(wire["topk"]))
        out.clients = CardinalitySketch.from_bytes(base64.b64decode(wire["hll"]))
        counters = dict(wire.get("c") or {})
        out.observations = int(counters.get("observations", 0))
        out.outliers = int(counters.get("outliers", 0))
        out.observe_ns = int(counters.get("observe_ns", 0))
        out.merge_ns = int(counters.get("merge_ns", 0))
        return out

    def nbytes(self) -> int:
        return (sum(sk.nbytes() for sk in self.quantiles.values())
                + self.offenders.nbytes() + self.clients.nbytes())

    # -- read side ---------------------------------------------------------
    def straggler_ratio(self) -> float:
        """Fraction of round times above 3× the fleet median — the sketch
        replacement for the per-rank MAD-z straggler flags above threshold."""
        rt = self.quantiles["round_time_s"]
        if rt.count == 0:
            return 0.0
        p50 = rt.quantile(0.5)
        if not math.isfinite(p50) or p50 <= 0.0:
            return 0.0
        return rt.fraction_above(3.0 * p50)

    def outlier_rate(self) -> float:
        n = self.quantiles["delta_norm"].count
        return self.outliers / n if n else 0.0

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe summary for /statusz, the flight recorder, and uplink."""
        fams = {}
        for name, sk in self.quantiles.items():
            if sk.count == 0:
                continue
            fams[name] = {"count": sk.count, "mean": sk.mean,
                          "min": sk.min if math.isfinite(sk.min) else None,
                          "max": sk.max if math.isfinite(sk.max) else None,
                          **sk.quantiles()}
        return {
            "families": fams,
            "top_offenders": [{"rank": ki, "round_seconds": est}
                              for ki, est in self.offenders.topk()],
            "clients_seen": round(self.clients.estimate(), 1),
            "observations": self.observations,
            "straggler_ratio": self.straggler_ratio(),
            "outlier_rate": self.outlier_rate(),
            "sketch_bytes": self.nbytes(),
            "observe_ms": self.observe_ns / 1e6,
            "merge_ms": self.merge_ns / 1e6,
        }

    def prom_gauges(self) -> List[Tuple[str, Optional[Dict[str, str]], float]]:
        """Cardinality-bounded fleet gauges: 4 quantile rows per family, ≤ k
        offender rows, and a handful of scalars — O(1) in fleet size."""
        out: List[Tuple[str, Optional[Dict[str, str]], float]] = []
        rt = self.quantiles["round_time_s"]
        if rt.count:
            for q in FLEET_QUANTILES:
                out.append(("fleet_round_time_seconds",
                            {"q": _q_label(q)}, rt.quantile(q)))
        dn = self.quantiles["delta_norm"]
        if dn.count:
            for q in FLEET_QUANTILES:
                out.append(("fleet_delta_norm", {"q": _q_label(q)}, dn.quantile(q)))
        st = self.quantiles["staleness"]
        if st.count:
            for q in FLEET_QUANTILES:
                out.append(("fleet_staleness", {"q": _q_label(q)}, st.quantile(q)))
        # the offender rows are the one rank-labeled family the fleet path
        # still exports: k <= 16 by construction, but they register with the
        # budget anyway so fedml_telemetry_series_live counts them honestly
        offenders = self.offenders.topk()
        if offenders and get_budget().admit("fleet_offenders", len(offenders)):
            for ki, est in offenders:
                out.append(("fleet_offender_round_seconds",
                            {"rank": str(ki)}, est))
        if self.observations:
            out.append(("fleet_clients_seen", None, self.clients.estimate()))
            out.append(("fleet_straggler_ratio", None, self.straggler_ratio()))
            out.append(("fleet_outlier_rate", None, self.outlier_rate()))
            out.append(("fleet_sketch_bytes", None, float(self.nbytes())))
        return out


def _q_label(q: float) -> str:
    return f"{q:g}"


# --- cardinality budget ------------------------------------------------------
class TelemetryCardinalityBudget:
    """Bounds the *labeled* series the exposition side may emit.

    Per-rank gauge families (``client_health{rank=}``, the modelwatch ledger
    triples, per-client Perfetto lanes) call :meth:`admit` with the series
    count they are about to emit. The budget enforces a per-family cap and a
    process-wide total; a family that would blow either cap is *degraded*:
    the caller emits nothing per-rank and the fleet sketch summaries carry
    the signal instead. Live and degraded state is itself exposed as
    ``fedml_telemetry_series_live{family=}`` (degraded families report their
    requested count with ``state="degraded"``), so the budget can never
    silently eat a surface.

    Defaults are far above any cross-silo cohort (``per_family`` 256, total
    4096) — below the exact-mode threshold nothing degrades and per-rank
    output is bit-identical to the un-budgeted code.
    """

    def __init__(self, max_series: Optional[int] = None,
                 per_family: Optional[int] = None, topk: int = DEFAULT_TOPK):
        if max_series is None:
            max_series = int(os.environ.get("FEDML_TELEMETRY_SERIES_BUDGET", 4096))
        if per_family is None:
            per_family = int(os.environ.get(
                "FEDML_TELEMETRY_SERIES_PER_FAMILY", 256))
        self.max_series = int(max_series)
        self.per_family = int(per_family)
        self.topk = int(topk)
        self._lock = threading.Lock()
        self._live: Dict[str, int] = {}
        self._degraded: Dict[str, int] = {}

    def admit(self, family: str, n_series: int) -> bool:
        """True → emit your ``n_series`` labeled rows; False → degrade to the
        fleet sketch summaries (and the budget records the refusal)."""
        family = str(family)
        n = int(n_series)
        with self._lock:
            other_live = sum(c for f, c in self._live.items() if f != family)
            if n <= self.per_family and other_live + n <= self.max_series:
                self._live[family] = n
                self._degraded.pop(family, None)
                return True
            self._degraded[family] = n
            self._live.pop(family, None)
            return False

    def release(self, family: str) -> None:
        with self._lock:
            self._live.pop(str(family), None)
            self._degraded.pop(str(family), None)

    def live(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._live)

    def degraded(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._degraded)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"max_series": self.max_series,
                    "per_family": self.per_family,
                    "live_total": sum(self._live.values()),
                    "live": dict(self._live),
                    "degraded": dict(self._degraded)}

    def prom_gauges(self) -> List[Tuple[str, Dict[str, str], float]]:
        out: List[Tuple[str, Dict[str, str], float]] = []
        with self._lock:
            for family in sorted(self._live):
                out.append(("telemetry_series_live",
                            {"family": family, "state": "live"},
                            float(self._live[family])))
            for family in sorted(self._degraded):
                out.append(("telemetry_series_live",
                            {"family": family, "state": "degraded"},
                            float(self._degraded[family])))
        return out


# --- process-wide wiring -----------------------------------------------------
_state_lock = threading.Lock()
_budget: Optional[TelemetryCardinalityBudget] = None
_active_provider: Optional[Callable[[], Optional[FleetSketches]]] = None


def exact_threshold() -> int:
    """Distinct-rank count below which the fleet path keeps exact per-rank
    accounting (bit-for-bit pre-sketch behavior)."""
    return int(os.environ.get("FEDML_FLEET_SKETCH_THRESHOLD",
                              DEFAULT_EXACT_THRESHOLD))


def get_budget() -> TelemetryCardinalityBudget:
    global _budget
    with _state_lock:
        if _budget is None:
            _budget = TelemetryCardinalityBudget()
        return _budget


def set_active_provider(
        provider: Optional[Callable[[], Optional[FleetSketches]]]) -> None:
    """Register the process's primary fleet-sketch view (server manager
    registers its FleetTelemetry; a hierarchy tree registers its root). The
    /metrics, /statusz, tsdb, and flight-recorder riders all read it."""
    global _active_provider
    with _state_lock:
        _active_provider = provider


def get_active() -> Optional[FleetSketches]:
    with _state_lock:
        provider = _active_provider
    if provider is None:
        return None
    try:
        return provider()
    except Exception:  # noqa: BLE001 - observability must not crash the caller
        return None


def active_snapshot() -> Optional[Dict[str, Any]]:
    fs = get_active()
    if fs is None or fs.observations == 0:
        return None
    return fs.snapshot()


def prom_gauges() -> List[Tuple[str, Optional[Dict[str, str]], float]]:
    """The /metrics rider: fleet sketch gauges + budget live-series gauges."""
    out: List[Tuple[str, Optional[Dict[str, str]], float]] = []
    fs = get_active()
    if fs is not None and fs.observations:
        out.extend(fs.prom_gauges())
    with _state_lock:
        budget = _budget
    if budget is not None:
        out.extend(budget.prom_gauges())
    return out


def tsdb_collector(store) -> None:
    """Pull-side tsdb feed (``TimeSeriesStore.add_collector``): fleet
    quantiles + rates as gauges so SLO packs can target fleet p99s."""
    fs = get_active()
    if fs is None or fs.observations == 0:
        return
    rt = fs.quantiles["round_time_s"]
    if rt.count:
        store.record_gauge("fleet.round_time_p50", rt.quantile(0.5))
        store.record_gauge("fleet.round_time_p99", rt.quantile(0.99))
    store.record_gauge("fleet.straggler_ratio", fs.straggler_ratio())
    store.record_gauge("fleet.outlier_rate", fs.outlier_rate())
    store.record_gauge("fleet.clients_seen", fs.clients.estimate())


def statusz_snapshot() -> Optional[Dict[str, Any]]:
    """The /statusz rider: sketch summary + budget state (None when idle)."""
    snap = active_snapshot()
    with _state_lock:
        budget = _budget
    if snap is None and budget is None:
        return None
    doc: Dict[str, Any] = {}
    if snap is not None:
        doc.update(snap)
    if budget is not None:
        doc["budget"] = budget.snapshot()
    return doc or None


def reset() -> None:
    """Test hook: drop the process-wide budget and active provider."""
    global _budget, _active_provider
    with _state_lock:
        _budget = None
        _active_provider = None
