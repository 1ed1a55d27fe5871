"""Session-aware multi-tenant admission control for the serving engines.

A copy of ``fedml_tpu/serving/admission.py`` (framework-free).

The front door runs BEFORE a request costs anything: prefill FLOPs, KV
pages, and a decode slot are only spent on requests that pass. Three
mechanisms, in decision order:

1. **Per-tenant token budgets** — a token bucket per tenant (tokens/s
   rate, burst cap) charged ``prompt + max_new`` at submit. An over-budget
   tenant is SHED (reason ``budget``) no matter how idle the engine is:
   budgets are the contract that makes one tenant's flood invisible to the
   rest (the tenant-isolation chaos drill asserts exactly this).
2. **SLO-tied backpressure** — the controller watches the time-series store's
   ``serving.cb.ttft_seconds`` / ``serving.cb.tpot_seconds`` windows and
   converts them to burn fractions against the serving SLO pack's targets.
   At ``defer_burn`` (default 0.7) tenants consuming MORE than their fair
   share are deferred (left queued, not scheduled); at ``shed_burn``
   (default 0.9) their new submits are shed (reason ``slo_pressure``).
   Both thresholds sit below 1.0 — load is turned away while the SLO
   evaluator still reads ``ok``, which is the point: the alert that never
   fires. Tenants at-or-under fair share are never deferred or shed by
   pressure, only by their own budget.
3. **Weighted fair queueing** — every queued request carries a virtual
   finish tag (``tag = max(tenant_tag, vclock) + cost/weight``); the
   engine dequeues the smallest eligible tag. A flooding tenant's tags
   race ahead so its backlog waits behind everyone else's fresh arrivals.

Every admission-path reject increments the labeled family
``fedml_serving_admission_rejected_total{tenant=,reason=}`` (``count_reject``;
every reject path routes there).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Dict, Optional

from ..core import telemetry as tel
from ..core.telemetry import tsdb

#: labeled-counter family: "serving.admission.rejected.<tenant>.<reason>"
#: collapses to fedml_serving_admission_rejected_total{tenant=,reason=}
#: (prom.register_prefix_family below)
REJECT_PREFIX = "serving.admission.rejected."

DEFAULT_TENANT = "default"

#: reasons are a closed vocabulary so the label cardinality stays bounded
REASON_BUDGET = "budget"
REASON_SLO_PRESSURE = "slo_pressure"
REASON_QUEUE_FULL = "queue_full"
REASON_SHUTDOWN = "shutdown"

class AdmissionError(RuntimeError):
    """A request was shed at the front door; carries tenant + reason so
    callers can map it to HTTP 429 and clients can tell budget exhaustion
    from pressure shedding."""

    def __init__(self, tenant: str, reason: str):
        super().__init__(f"admission rejected for tenant {tenant!r}: {reason}")
        self.tenant = tenant
        self.reason = reason


_PROM_REGISTERED = False


def _register_prom_family() -> None:
    global _PROM_REGISTERED
    if _PROM_REGISTERED:
        return
    from ..core.telemetry import prom

    # the tenant set is the configured policy table, not the client population
    prom.register_prefix_family(
        REJECT_PREFIX, ("tenant", "reason"),
        "admission-path rejects by tenant and reason")
    _PROM_REGISTERED = True


def count_reject(tenant: str, reason: str) -> None:
    """The one reject emission site: every reject path routes here."""
    tel.counter(REJECT_PREFIX + f"{tenant}.{reason}").add(1)


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """One tenant's contract: token budget (rate + burst) and WFQ weight.
    The defaults are unlimited — admission is opt-in per tenant."""

    tokens_per_s: float = math.inf
    burst_tokens: float = math.inf
    weight: float = 1.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")


class AdmissionController:
    """Front-door policy state: token buckets, WFQ tags, usage shares, and
    the cached SLO burn fraction. Thread-safe; the engine calls
    :meth:`check` from submit threads and :meth:`eligible`/:meth:`stamp`
    from its worker."""

    def __init__(
        self,
        policies: Optional[Dict[str, TenantPolicy]] = None,
        default: Optional[TenantPolicy] = None,
        *,
        ttft_target_s: float = 5.0,
        tpot_target_s: float = 1.0,
        defer_burn: float = 0.7,
        shed_burn: float = 0.9,
        burn_window_s: float = 60.0,
        burn_ttl_s: float = 1.0,
        usage_halflife_s: float = 30.0,
        clock=time.monotonic,
    ):
        if not 0.0 < defer_burn <= shed_burn:
            raise ValueError(
                f"need 0 < defer_burn <= shed_burn, got {defer_burn}/{shed_burn}")
        _register_prom_family()
        self.policies = dict(policies or {})
        self.default = default or TenantPolicy()
        self.ttft_target_s = float(ttft_target_s)
        self.tpot_target_s = float(tpot_target_s)
        self.defer_burn = float(defer_burn)
        self.shed_burn = float(shed_burn)
        self.burn_window_s = float(burn_window_s)
        self.burn_ttl_s = float(burn_ttl_s)
        self.usage_halflife_s = float(usage_halflife_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._bucket: Dict[str, float] = {}
        self._bucket_t: Dict[str, float] = {}
        self._usage: Dict[str, float] = {}   # decaying admitted-token EWMA
        self._usage_t: Dict[str, float] = {}
        self._tag: Dict[str, float] = {}     # WFQ virtual finish tags
        self._vclock = 0.0
        self._burn_cached = 0.0
        self._burn_cached_t = -math.inf
        self._sheds = 0
        self._deferrals = 0

    def policy(self, tenant: str) -> TenantPolicy:
        return self.policies.get(tenant, self.default)

    # -- SLO backpressure signal -------------------------------------------

    def burn_fraction(self, now: Optional[float] = None) -> float:
        """Worst of the TTFT/TPOT p99 burn fractions over the fast window
        (observed / target, the SLO engine's ceiling convention), cached
        ``burn_ttl_s`` so 10k submits/s don't each sort a tsdb window.
        No store or no data reads as 0.0 — no opinion, no backpressure."""
        if now is None:
            now = self._clock()
        with self._lock:
            if now - self._burn_cached_t < self.burn_ttl_s:
                return self._burn_cached
        store = tsdb.active()
        burn = 0.0
        if store is not None:
            ttft = store.quantile("serving.cb.ttft_seconds", 0.99,
                                  self.burn_window_s)
            tpot = store.quantile("serving.cb.tpot_seconds", 0.99,
                                  self.burn_window_s)
            if ttft is not None and self.ttft_target_s > 0:
                burn = max(burn, ttft / self.ttft_target_s)
            if tpot is not None and self.tpot_target_s > 0:
                burn = max(burn, tpot / self.tpot_target_s)
        with self._lock:
            self._burn_cached = burn
            self._burn_cached_t = now
        return burn

    # -- usage shares -------------------------------------------------------

    def _decay_usage_locked(self, tenant: str, now: float) -> float:
        u = self._usage.get(tenant, 0.0)
        t0 = self._usage_t.get(tenant, now)
        if now > t0 and u > 0:
            u *= 0.5 ** ((now - t0) / self.usage_halflife_s)
        self._usage[tenant] = u
        self._usage_t[tenant] = now
        return u

    def _over_fair_share_locked(self, tenant: str, now: float) -> bool:
        """Is this tenant consuming more than its weight-entitled share of
        recent admitted tokens? Single-tenant traffic is never "over" —
        there is nobody to be unfair to."""
        mine = self._decay_usage_locked(tenant, now)
        total = sum(self._decay_usage_locked(t, now) for t in list(self._usage))
        if total <= 0 or len(self._usage) < 2:
            return False
        weights = {t: self.policy(t).weight for t in self._usage}
        fair = weights[tenant] / sum(weights.values())
        return mine / total > fair * 1.25  # 25% slack: jitter is not abuse

    # -- decision points ----------------------------------------------------

    def check(self, tenant: str, cost_tokens: int,
              now: Optional[float] = None) -> Optional[str]:
        """Submit-time gate. Returns None to accept the request into the
        queue, or a shed reason. Charges the token bucket on accept."""
        if now is None:
            now = self._clock()
        pol = self.policy(tenant)
        burn = self.burn_fraction(now)
        with self._lock:
            # refill, then charge — an idle tenant recovers burst headroom
            level = self._bucket.get(tenant, pol.burst_tokens)
            t0 = self._bucket_t.get(tenant, now)
            if math.isfinite(pol.burst_tokens):
                level = min(pol.burst_tokens,
                            level + pol.tokens_per_s * max(0.0, now - t0))
            self._bucket_t[tenant] = now
            if level < cost_tokens:
                self._bucket[tenant] = level
                self._sheds += 1
                reason = REASON_BUDGET
            elif (burn >= self.shed_burn
                  and self._over_fair_share_locked(tenant, now)):
                self._bucket[tenant] = level  # not charged: request is shed
                self._sheds += 1
                reason = REASON_SLO_PRESSURE
            else:
                self._bucket[tenant] = (level - cost_tokens
                                        if math.isfinite(level) else level)
                self._usage[tenant] = (
                    self._decay_usage_locked(tenant, now) + cost_tokens)
                reason = None
        if reason is not None:
            count_reject(tenant, reason)
        return reason

    def stamp(self, tenant: str, cost_tokens: int) -> float:
        """WFQ virtual finish tag for a newly queued request."""
        with self._lock:
            tag = max(self._tag.get(tenant, 0.0), self._vclock)
            tag += cost_tokens / self.policy(tenant).weight
            self._tag[tenant] = tag
            return tag

    def on_dequeue(self, tag: float) -> None:
        with self._lock:
            self._vclock = max(self._vclock, tag)

    def eligible(self, tenant: str, now: Optional[float] = None) -> bool:
        """Dequeue-time gate: under SLO pressure (burn >= defer_burn), an
        over-fair-share tenant's queued work is DEFERRED — skipped this
        scheduling round, shed nothing. This is the load turned away
        before the alert fires."""
        if now is None:
            now = self._clock()
        burn = self.burn_fraction(now)
        if burn < self.defer_burn:
            return True
        with self._lock:
            over = self._over_fair_share_locked(tenant, now)
            if over:
                self._deferrals += 1
        if over:
            tel.counter("serving.admission.deferrals").add(1)
        return not over

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "tenants": len(self._usage),
                "sheds": self._sheds,
                "deferrals": self._deferrals,
                "burn_fraction": self._burn_cached,
                "vclock": self._vclock,
            }

    def prom_gauges(self) -> list:
        """(name, labels, value) triples for the /metrics ride-along."""
        now = self._clock()
        with self._lock:
            out = [("serving_admission_burn_fraction", None,
                    float(self._burn_cached))]
            total = sum(self._decay_usage_locked(t, now)
                        for t in list(self._usage))
            for t in sorted(self._usage):
                share = self._usage[t] / total if total > 0 else 0.0
                out.append(("serving_tenant_usage_share", {"tenant": t},
                            float(share)))
                level = self._bucket.get(t)
                if level is not None and math.isfinite(level):
                    out.append(("serving_tenant_budget_tokens", {"tenant": t},
                                float(level)))
            return out
