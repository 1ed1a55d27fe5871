"""Deadline-based quorum aggregation for synchronous FL rounds: a copy of
``fedml_tpu/core/resilience/quorum.py`` (framework-free).

A synchronous server that waits for *all* K deltas hangs forever the moment
one client dies (the reference's ``check_whether_all_receive`` gate). This
module gives the cross-silo server a bounded round:

- a **deadline** per round — static (``args.round_deadline_s``) or adaptive
  (``args.adaptive_deadline``: a multiple of the slowest healthy client's
  EWMA round time, so the deadline tracks the cohort instead of needing
  retuning per model size);
- a **minimum quorum** (``args.quorum_frac`` of the nominal cohort k): when
  the deadline fires with at least that many deltas, the round aggregates
  what arrived, marks the missing ranks failed in health, and advances —
  ``fedml_quorum_partial_total`` counts these partial rounds;
- **late deltas** (tagged with an older round index) are counted into
  ``fedml_quorum_late_discarded_total`` and dropped, never folded into the
  wrong round;
- **over-provisioning** (``args.overprovision_frac``): when health flagged
  stragglers last round, the server samples ``ceil(k·(1+f))`` clients and
  keeps the first k deltas — surplus arrivals are discarded
  (``fedml_quorum_surplus_total``).

The async buffer (``core/aggregation/async_buffer.py``) judges its arrivals
with the stale verdicts below. :class:`RoundQuorum` is the per-round arrival
tracker; thread-safe because deltas arrive on the receive loop while the
deadline timer fires on its own thread. The server manager owns the timer;
this module owns the decisions.

``quorum_link_cost`` (``use_link_cost``): the adaptive deadline stretches
each rank's EWMA by its predicted upload seconds (netlink's cost model,
through the ``link_predict`` the server hands in) before the cohort max, so
one rank behind a slow WAN link widens the deadline by its own transfer
cost; :meth:`QuorumPolicy.rank_budgets` shows each rank's stretched EWMA.
"""

from __future__ import annotations

import logging
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

log = logging.getLogger(__name__)

# counter names (prom.py renders fedml_<name with dots as _>_total)
PARTIAL_COUNTER = "quorum.partial"
LATE_COUNTER = "quorum.late_discarded"
SURPLUS_COUNTER = "quorum.surplus"
STALE_ACCEPTED_COUNTER = "quorum.stale_accepted"
STALE_REJECTED_COUNTER = "quorum.stale_rejected"

ACCEPT = "accept"
LATE = "late"
SURPLUS = "surplus"
DUPLICATE = "duplicate"
# async-mode verdicts: an arrival trained on an older model version is either
# admitted with a decayed weight or refused past the admission cut
STALE_ACCEPTED = "stale_accepted"
STALE_REJECTED = "stale_rejected"
# modelwatch quarantine's verdict (args.modelwatch_quarantine): the async
# buffer refuses a robust-z delta-norm outlier or a NaN/Inf delta with it
OUTLIER_REJECTED = "outlier_rejected"


def overprovisioned_cohort_size(k: int, frac: float, stragglers_flagged: bool,
                                available: int) -> int:
    """Cohort size to sample this round: ``ceil(k·(1+frac))`` when health
    flagged stragglers last round, capped at the connected population."""
    k = int(k)
    if not stragglers_flagged or frac <= 0:
        return min(k, int(available))
    return min(int(math.ceil(k * (1.0 + float(frac)))), int(available))


@dataclass(frozen=True)
class QuorumPolicy:
    """Round-completion policy. ``enabled`` is False when nothing here can
    ever fire — the server then keeps the all-receive gate."""

    deadline_s: Optional[float] = None       # static per-round deadline
    quorum_frac: float = 1.0                 # min fraction of keep_k to aggregate at deadline
    adaptive: bool = False                   # derive deadline from health EWMAs
    adaptive_mult: float = 3.0               # deadline = mult * max healthy EWMA
    min_deadline_s: float = 1.0              # adaptive floor
    overprovision_frac: float = 0.0
    # args.quorum_link_cost: stretch the adaptive deadline by each rank's
    # measured upload time (the netlink cost model) so a slow WAN link
    # widens the deadline instead of being misread as slow compute
    use_link_cost: bool = False

    @property
    def enabled(self) -> bool:
        return (self.deadline_s is not None or self.adaptive
                or self.quorum_frac < 1.0 or self.overprovision_frac > 0.0)

    @classmethod
    def from_args(cls, args: Any) -> "QuorumPolicy":
        dl = getattr(args, "round_deadline_s", None)
        return cls(
            deadline_s=None if dl is None else float(dl),
            quorum_frac=float(getattr(args, "quorum_frac", 1.0)),
            adaptive=bool(getattr(args, "adaptive_deadline", False)),
            adaptive_mult=float(getattr(args, "adaptive_deadline_mult", 3.0)),
            min_deadline_s=float(getattr(args, "adaptive_deadline_min_s", 1.0)),
            overprovision_frac=float(getattr(args, "overprovision_frac", 0.0)),
            use_link_cost=bool(getattr(args, "quorum_link_cost", False)),
        )

    def min_quorum(self, keep_k: int) -> int:
        return max(1, int(math.ceil(float(self.quorum_frac) * int(keep_k))))

    def rank_budgets(self, health: Any = None, link_predict: Any = None) -> Dict[int, float]:
        """Each rank's seconds the adaptive deadline budgets for: its health
        EWMA, plus its predicted upload seconds under ``use_link_cost``
        (``link_predict(rank)``, None where netlink has no confident
        estimate; a predictor that raises leaves the rank's EWMA as it is,
        as in JAX). Ranks without an EWMA are left out."""
        try:
            ewmas = {r: c.ewma_s for r, c in health._clients.items() if c.ewma_s is not None}
        except AttributeError:  # no health tracker wired in
            return {}
        if not (self.use_link_cost and link_predict is not None):
            return dict(ewmas)
        out = {}
        for rank, ewma in ewmas.items():
            try:
                extra = link_predict(rank)
            except Exception:  # noqa: BLE001 - duck-typed predictor: its rank keeps the EWMA
                extra = None
            out[rank] = ewma + (float(extra) if extra else 0.0)
        return out

    def deadline_for_round(self, health: Any = None,
                           link_predict: Any = None) -> Optional[float]:
        """Seconds until this round's deadline (None = wait forever). The
        adaptive mode needs at least one EWMA observation; until then the
        static deadline (or none) applies. With ``use_link_cost`` each
        rank's EWMA is stretched by its ``link_predict`` seconds before the
        cohort max (:meth:`rank_budgets`)."""
        if self.adaptive and health is not None:
            per_rank = self.rank_budgets(health, link_predict)
            if per_rank:
                adaptive = max(self.min_deadline_s, self.adaptive_mult * max(per_rank.values()))
                return adaptive if self.deadline_s is None else min(adaptive, self.deadline_s)
        return self.deadline_s


class RoundQuorum:
    """Arrival tracker for one round: which ranks we expect, how many deltas
    we keep, and whether the round may complete (fully or at deadline)."""

    def __init__(self, round_idx: int, expected_ranks: Sequence[int], keep_k: int,
                 policy: QuorumPolicy):
        self.round_idx = int(round_idx)
        self.expected = [int(r) for r in expected_ranks]
        self.keep_k = min(int(keep_k), len(self.expected)) if self.expected else int(keep_k)
        self.policy = policy
        self._lock = threading.Lock()
        self._arrived: List[int] = []        # arrival order (keep-first-k)
        self._closed = False

    # --- arrivals (receive-loop thread) ------------------------------------
    def on_delta(self, rank: int, delta_round: Optional[int]) -> str:
        """Classify one model upload. ``delta_round`` is the round the client
        tagged the upload with (None for old senders: trusted as current)."""
        rank = int(rank)
        with self._lock:
            if delta_round is not None and int(delta_round) != self.round_idx:
                _counter(LATE_COUNTER).add(1)
                log.warning("round %d: discarding late delta from rank %d (tagged round %s)",
                            self.round_idx, rank, delta_round)
                return LATE
            if self._closed or len(self._arrived) >= self.keep_k:
                _counter(SURPLUS_COUNTER).add(1)
                log.info("round %d: surplus delta from rank %d discarded (kept first %d)",
                         self.round_idx, rank, self.keep_k)
                return SURPLUS
            if rank in self._arrived:
                return DUPLICATE
            self._arrived.append(rank)
            return ACCEPT

    def complete(self) -> bool:
        with self._lock:
            return len(self._arrived) >= self.keep_k

    # --- deadline (timer thread) -------------------------------------------
    def deadline_quorum_met(self) -> bool:
        with self._lock:
            return len(self._arrived) >= self.policy.min_quorum(self.keep_k)

    def close_partial(self) -> List[int]:
        """Close the round at the deadline: further deltas are surplus.
        Returns the missing ranks (expected, never arrived) so the caller can
        mark them failed in health. Bumps ``fedml_quorum_partial_total``."""
        with self._lock:
            self._closed = True
            missing = [r for r in self.expected if r not in self._arrived]
        _counter(PARTIAL_COUNTER).add(1)
        return missing

    # --- introspection ------------------------------------------------------
    def arrived(self) -> List[int]:
        with self._lock:
            return list(self._arrived)

    def missing(self) -> List[int]:
        with self._lock:
            return [r for r in self.expected if r not in self._arrived]

    def statusz(self) -> dict:
        with self._lock:
            return {
                "round_idx": self.round_idx,
                "expected": list(self.expected),
                "arrived": list(self._arrived),
                "keep_k": self.keep_k,
                "min_quorum": self.policy.min_quorum(self.keep_k),
                "closed": self._closed,
            }


def _counter(name: str):
    from ..telemetry.core import get_telemetry

    return get_telemetry().counter(name)
