"""Declarative SLOs over the tsdb, evaluated by a multi-window burn-rate
policy with a pending → firing → resolved state machine.

A copy of ``fedml_tpu/core/telemetry/slo.py`` (framework-free) over the
port's ``tsdb``: the same specs, packs, burn rates, state machine and
surfaces, and the netlink collector that feeds the ``link_loss_ratio``
row the worst pair's probe loss each tick. Not ported: the
``mlops.log_alert`` uplink (the port has no mlops) and
``alert_profile_capture`` (JAX's ``mlops.start_profiler_trace``), which
raises NotImplementedError when set (ROADMAP.md, Queue 1).

An :class:`SLOSpec` names a tsdb series, a windowed signal (``rate`` /
``quantile`` / ``avg`` / ``max`` / ``delta`` / ``last``), a comparator, and
a target: ``engine.round_seconds`` p99 <= 2s, rounds/hr >= 10, straggler
ratio <= 0.2. Each evaluator tick computes the signal over a *fast* window
(default 5m) and a *slow* window (default 1h) and converts it to a burn
rate — observed/target for ceilings, target/observed for floors — so "how
bad" is one dimensionless number on every surface.

State machine (Google-SRE multi-window burn-rate shape, with hysteresis):

- ``ok → pending``       first fast-window breach
- ``pending → firing``   fast breach persists ``firing_for_ticks`` ticks AND
  the slow window agrees (a slow window with no data cannot veto — young
  processes alert on the fast window alone)
- ``pending → ok``       fast window clears (no hysteresis on the way down)
- ``firing → resolved``  fast window clears ``clear_for_ticks`` consecutive
  ticks (hysteresis: one good tick amid breaches keeps the alert firing)
- ``resolved → ok``      next clear tick (``resolved`` is the visible
  "recently recovered" state)

Firing alerts fan out to every existing surface: the ``alerts`` section on
`/statusz` (statusz.render ride-along), ``fedml_alert_active{slo=}`` /
``fedml_slo_*`` gauges on `/metrics` (prom.render ride-along),
``fedml_alert_transitions_total``, and a flight-recorder breadcrumb plus an
automatic ONE-SHOT flight-recorder snapshot on the first firing (the alert
preserves its own evidence).

Default packs per front (``engine`` / ``cross_silo`` / ``serving``) carry
permissive targets; ``args.slo_spec`` names a JSON file overriding or
extending them (see docs/observability.md for the schema).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

from . import flight_recorder, tsdb
from .core import get_telemetry

__all__ = [
    "SLOSpec",
    "SLOEngine",
    "AlertState",
    "build_specs",
    "load_spec_file",
    "activate",
    "deactivate",
    "get_engine",
    "register_alert_context",
    "unregister_alert_context",
    "statusz_snapshot",
    "prom_gauges",
    "reset",
]

log = logging.getLogger(__name__)

_ENV_DISABLE = "FEDML_SLO"          # "0" disables activation entirely
_ENV_SERVING_TICK = "FEDML_SLO_TICK_S"

STATE_OK = "ok"
STATE_PENDING = "pending"
STATE_FIRING = "firing"
STATE_RESOLVED = "resolved"

_SIGNALS = ("rate", "quantile", "avg", "max", "delta", "last")
_COMPARATORS = ("<=", ">=")

MAX_TRANSITIONS = 32  # bounded per-alert + engine-wide history

# --- alert-context providers -------------------------------------------------
# A provider is ``fn(spec) -> Optional[dict]``: extra evidence merged into the
# one-shot flight-recorder snapshot's alert record on first firing (e.g. the
# modelwatch contribution ledger attaches the offending clients' stat rows to
# modelwatch.* alerts). Providers must be cheap and must never raise.
_ALERT_CONTEXT: List[Callable[[SLOSpec], Optional[Dict[str, Any]]]] = []
_alert_context_lock = threading.Lock()


def register_alert_context(fn: Callable[["SLOSpec"], Optional[Dict[str, Any]]]) -> None:
    with _alert_context_lock:
        if fn not in _ALERT_CONTEXT:
            _ALERT_CONTEXT.append(fn)


def unregister_alert_context(fn: Callable[["SLOSpec"], Optional[Dict[str, Any]]]) -> None:
    with _alert_context_lock:
        try:
            _ALERT_CONTEXT.remove(fn)
        except ValueError:
            pass


@dataclass(frozen=True)
class SLOSpec:
    """One objective: ``signal(series, window)`` ``comparator`` ``target``."""

    name: str
    series: str
    target: float
    signal: str = "rate"
    comparator: str = "<="
    q: float = 0.99            # quantile signal only
    scale: float = 1.0         # e.g. 3600 turns a per-second rate into per-hour
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    firing_for_ticks: int = 2
    clear_for_ticks: int = 2

    def __post_init__(self):
        if self.signal not in _SIGNALS:
            raise ValueError(f"slo {self.name!r}: unknown signal {self.signal!r} "
                             f"(one of {_SIGNALS})")
        if self.comparator not in _COMPARATORS:
            raise ValueError(f"slo {self.name!r}: comparator must be one of "
                             f"{_COMPARATORS}, got {self.comparator!r}")


# --- default SLO packs per front ---------------------------------------------
# Targets are deliberately permissive: the default pack is the wiring proof
# and the schema reference; deployments tighten via args.slo_spec. Series
# names must resolve against the metric registry.

_ENGINE_PACK: List[Dict[str, Any]] = [
    dict(name="rounds_per_hr", series="engine.rounds", signal="rate",
         scale=3600.0, comparator=">=", target=1.0),
    dict(name="round_p99_seconds", series="engine.round_seconds",
         signal="quantile", q=0.99, comparator="<=", target=600.0),
    # pipelined execution (core/pipeline): a healthy pipeline keeps some
    # measured train/compress/uplink/fold overlap; a run that collapses to
    # serial reports ~0 and burns the floor to infinity (no data = no
    # opinion, so sequential runs never alert)
    dict(name="pipeline_overlap_frac", series="pipeline.overlap_frac",
         signal="avg", comparator=">=", target=0.05),
    dict(name="pipeline_stage_stall_p99_seconds",
         series="pipeline.stage_stall_seconds", signal="quantile", q=0.99,
         comparator="<=", target=120.0),
    # devperf: an instrumented step whose achieved-FLOPs/s collapses to
    # ~zero of peak means the device is stalled (preempted, throttled, or
    # host-bound), not merely slow — even CPU fallback runs against the
    # unknown-chip peak sit orders of magnitude above this floor, so only
    # a genuine collapse (or a chaos drill) trips it. No samples = no
    # opinion, so un-instrumented runs never alert.
    dict(name="mfu_collapse", series="devperf.mfu.*", signal="avg",
         comparator=">=", target=1e-5),
    # HBM high-water near the device limit: the next admission/rebatch OOMs
    dict(name="hbm_high_water", series="devperf.hbm_high_water_frac",
         signal="max", comparator="<=", target=0.95),
    # modelwatch (telemetry/modelwatch.py): training-dynamics objectives fed
    # from fold-boundary delta statistics. nan_storm: ANY NaN/Inf in a
    # published aggregate burns a zero target to infinity — firing in 1 tick
    # (one breached tick arms pending, the next confirms). No modelwatch
    # data (feature off, sharded engine) = no opinion, so it never alerts.
    dict(name="nan_storm", series="modelwatch.nan_count", signal="last",
         comparator="<=", target=0.0, firing_for_ticks=1),
    # the contribution ledger publishes update_norm / trailing-EWMA-baseline
    # as divergence_ratio: a 10x jump in published update magnitude over the
    # run's own history is divergence, not noise (SLOSpec targets are fixed,
    # so the trailing-baseline burn lives ledger-side)
    dict(name="divergence", series="modelwatch.divergence_ratio",
         signal="max", comparator="<=", target=10.0),
    dict(name="client_outlier_rate", series="modelwatch.outlier_rate",
         signal="last", comparator="<=", target=0.25, firing_for_ticks=1),
    # fleet sketch rows (telemetry/sketches.py collector): above the
    # exact-mode threshold the per-rank health/ledger feeds go quiet for new
    # ranks and these sketch-derived fleet series carry the straggler-rate /
    # outlier-rate objectives instead — cardinality-bounded at any cohort
    # size. No active fleet view = no data = no opinion.
    dict(name="fleet_round_p99_seconds", series="fleet.round_time_p99",
         signal="last", comparator="<=", target=600.0),
    dict(name="fleet_straggler_ratio", series="fleet.straggler_ratio",
         signal="last", comparator="<=", target=0.5),
    dict(name="fleet_outlier_rate", series="fleet.outlier_rate",
         signal="last", comparator="<=", target=0.25),
]

_CROSS_SILO_PACK: List[Dict[str, Any]] = _ENGINE_PACK + [
    dict(name="straggler_ratio", series="health.straggler_ratio",
         signal="last", comparator="<=", target=0.5),
    # accounted DP (core/privacy/dp.py): the accountant publishes spent-ε /
    # budget each noised publish; alerting on budget_frac at 0.85 fires
    # BEFORE ε crosses the configured budget — the operator still has runway
    # to stop the run or renegotiate the budget. No DP = no data = no opinion.
    dict(name="dp_budget_exhaustion", series="privacy.dp_budget_frac",
         signal="last", comparator="<=", target=0.85, firing_for_ticks=1),
    dict(name="link_loss_ratio", series="link.loss_ratio",
         signal="max", comparator="<=", target=0.5),
    dict(name="comm_retry_rate", series="comm.retry.*", signal="rate",
         comparator="<=", target=1.0),
    dict(name="checkpoint_drop_rate", series="checkpoint.dropped",
         signal="rate", comparator="<=", target=0.1),
]

_SERVING_PACK: List[Dict[str, Any]] = [
    dict(name="ttft_p99_seconds", series="serving.cb.ttft_seconds",
         signal="quantile", q=0.99, comparator="<=", target=5.0),
    dict(name="tpot_p99_seconds", series="serving.cb.tpot_seconds",
         signal="quantile", q=0.99, comparator="<=", target=1.0),
    dict(name="request_error_rate", series="serving.request_errors",
         signal="rate", comparator="<=", target=1.0),
    # admission is SUPPOSED to shed before the latency SLOs fire, but a
    # sustained shed rate is its own incident: tenants are being turned
    # away faster than operators would accept as transient backpressure
    dict(name="admission_shed_rate", series="serving.admission.rejected.*",
         signal="rate", comparator="<=", target=5.0),
    # paged-KV pool pressure: deferred allocations mean admitted work is
    # waiting on pages (raise num_pages or shrink budgets before TTFT tips)
    dict(name="kv_alloc_deferred_rate", series="serving.kv.alloc_deferred",
         signal="rate", comparator="<=", target=1.0),
    # same devperf pair as the engine pack: decode-step MFU collapse and
    # HBM high-water are serving incidents too (see _ENGINE_PACK notes)
    dict(name="mfu_collapse", series="devperf.mfu.*", signal="avg",
         comparator=">=", target=1e-5),
    dict(name="hbm_high_water", series="devperf.hbm_high_water_frac",
         signal="max", comparator="<=", target=0.95),
]

DEFAULT_PACKS: Dict[str, List[Dict[str, Any]]] = {
    "engine": _ENGINE_PACK,
    "cross_silo": _CROSS_SILO_PACK,
    "serving": _SERVING_PACK,
}


def load_spec_file(path: str) -> Dict[str, Any]:
    """Parse an ``args.slo_spec`` JSON file: ``{"slos": [{...spec...}],
    "replace": false}``. Raises ValueError on schema violations — a config
    typo should fail the run loudly, not silently un-alert it."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("slos", []), list):
        raise ValueError(f"slo_spec {path}: expected {{'slos': [...]}}")
    return doc


def build_specs(front: str, args: Any = None) -> List[SLOSpec]:
    """The front's default pack merged with ``args.slo_spec`` overrides:
    same-name entries replace defaults, new names extend, ``"disable": true``
    removes, top-level ``"replace": true`` drops the defaults entirely."""
    rows = {d["name"]: dict(d) for d in DEFAULT_PACKS.get(front, _ENGINE_PACK)}
    path = getattr(args, "slo_spec", None) if args is not None else None
    if path:
        doc = load_spec_file(str(path))
        if doc.get("replace"):
            rows = {}
        for d in doc.get("slos", []):
            if not isinstance(d, dict) or "name" not in d:
                raise ValueError(f"slo_spec {path}: every entry needs a 'name'")
            d = dict(d)
            name = str(d.pop("name"))
            if d.pop("disable", False):
                rows.pop(name, None)
                continue
            merged = dict(rows.get(name, {}), **d)
            merged["name"] = name
            rows[name] = merged
    specs = []
    for name, d in rows.items():
        d.setdefault("name", name)
        try:
            specs.append(SLOSpec(**d))
        except TypeError as e:
            raise ValueError(f"slo spec {name!r}: {e}") from e
    return specs


class AlertState:
    """Mutable per-SLO evaluation state (engine-lock protected)."""

    __slots__ = ("state", "breach_streak", "clear_streak", "since_mono",
                 "observed_fast", "observed_slow", "burn_fast", "burn_slow",
                 "transitions", "snapshot_done", "snapshot_path")

    def __init__(self):
        self.state = STATE_OK
        self.breach_streak = 0
        self.clear_streak = 0
        self.since_mono = time.monotonic()
        self.observed_fast: Optional[float] = None
        self.observed_slow: Optional[float] = None
        self.burn_fast: Optional[float] = None
        self.burn_slow: Optional[float] = None
        self.transitions: List[Dict[str, Any]] = []
        self.snapshot_done = False
        self.snapshot_path: Optional[str] = None


def _burn(spec: SLOSpec, observed: Optional[float]) -> Optional[float]:
    """Error-budget burn: >1 means the objective is breached. Ceilings burn
    as observed/target, floors as target/observed; no data is no opinion."""
    if observed is None:
        return None
    t = float(spec.target)
    if spec.comparator == "<=":
        if t <= 0:
            return float("inf") if observed > 0 else 1.0
        return observed / t
    if observed <= 0:
        return float("inf") if t > 0 else 1.0
    return t / observed


def _refuse_unported(args: Any) -> None:
    if args is not None and getattr(args, "alert_profile_capture", False):
        raise NotImplementedError(
            "alert_profile_capture (a profiler capture on the first firing alert) is not "
            "ported to fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")


class SLOEngine:
    """Evaluates specs against the store each :meth:`tick` and fans alert
    transitions out to every surface. Lock discipline: ``_lock`` (leaf)
    guards state; store queries and fan-out run outside it."""

    def __init__(self, specs: Iterable[SLOSpec], store: tsdb.TimeSeriesStore,
                 front: str = "engine", args: Any = None):
        _refuse_unported(args)
        self.specs: Dict[str, SLOSpec] = {s.name: s for s in specs}
        self.store = store
        self.front = front
        self.args = args
        self._lock = threading.Lock()       # leaf: no calls out while held
        self._tick_lock = threading.Lock()  # serializes concurrent tickers
        self._states: Dict[str, AlertState] = {n: AlertState() for n in self.specs}
        self.history: List[Dict[str, Any]] = []  # engine-wide, bounded
        self.tick_count = 0
        self.tick_ns = 0    # steady-state evaluator cost
        self.fanout_ns = 0  # transition fan-out: incident-driven diagnostics
        self.alerts_fired = 0
        self._last_tick_mono: Optional[float] = None
        self._ticker: Optional[threading.Thread] = None
        self._ticker_stop = threading.Event()

    # --- evaluation -------------------------------------------------------
    def _signal(self, spec: SLOSpec, window_s: float,
                now: float) -> Optional[float]:
        s = self.store
        if spec.signal == "rate":
            v = s.rate(spec.series, window_s, now)
        elif spec.signal == "quantile":
            v = s.quantile(spec.series, spec.q, window_s, now)
        elif spec.signal == "avg":
            v = s.avg(spec.series, window_s, now)
        elif spec.signal == "max":
            v = s.max(spec.series, window_s, now)
        elif spec.signal == "delta":
            v = s.delta(spec.series, window_s, now)
        else:  # "last"
            v = s.last(spec.series)
        return None if v is None else v * spec.scale

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluator pass: run collectors, evaluate every spec, advance
        state machines, fan out transitions. Returns this tick's
        transitions (tests assert on them)."""
        with self._tick_lock:
            t0 = time.perf_counter_ns()
            if now is None:
                now = time.monotonic()
            self.store.collect(now)
            get_telemetry().counter("slo.evaluations").add(1)
            fired: List[Dict[str, Any]] = []
            for name, spec in self.specs.items():
                fast = self._signal(spec, spec.fast_window_s, now)
                slow = self._signal(spec, spec.slow_window_s, now)
                bf, bs = _burn(spec, fast), _burn(spec, slow)
                with self._lock:
                    tr = self._advance_locked(spec, self._states[name],
                                              fast, slow, bf, bs, now)
                if tr is not None:
                    fired.append(tr)
            with self._lock:
                self.tick_count += 1
                self._last_tick_mono = now
            self.tick_ns += time.perf_counter_ns() - t0
            # fan-out (marks, the one-shot snapshot dump) runs only on
            # state TRANSITIONS — incident-driven diagnostics, billed apart
            # from the per-tick evaluator cost
            t1 = time.perf_counter_ns()
            for tr in fired:
                self._fan_out(tr)
            self.fanout_ns += time.perf_counter_ns() - t1
            return fired

    def maybe_tick(self, min_spacing_s: float = 0.25) -> None:
        """Round-loop tick point: evaluate unless a tick just ran."""
        last = self._last_tick_mono
        if last is not None and time.monotonic() - last < min_spacing_s:
            return
        self.tick()

    def _advance_locked(self, spec: SLOSpec, st: AlertState,
                        fast: Optional[float], slow: Optional[float],
                        bf: Optional[float], bs: Optional[float],
                        now: float) -> Optional[Dict[str, Any]]:
        st.observed_fast, st.observed_slow = fast, slow
        st.burn_fast, st.burn_slow = bf, bs
        fast_breach = bf is not None and bf > 1.0
        slow_agrees = bs is None or bs > 1.0  # no slow data cannot veto
        if fast_breach:
            st.breach_streak += 1
            st.clear_streak = 0
        else:
            st.clear_streak += 1
            st.breach_streak = 0
        old = st.state
        new = old
        if old == STATE_OK:
            if fast_breach:
                new = STATE_PENDING
        elif old == STATE_PENDING:
            if not fast_breach:
                new = STATE_OK
            elif slow_agrees and st.breach_streak >= spec.firing_for_ticks:
                new = STATE_FIRING
        elif old == STATE_FIRING:
            if st.clear_streak >= spec.clear_for_ticks:
                new = STATE_RESOLVED
        else:  # resolved: one visible recovery tick, then ok (or re-breach)
            new = STATE_PENDING if fast_breach else STATE_OK
        if new == old:
            return None
        st.state = new
        st.since_mono = now
        tr = {
            "slo": spec.name,
            "from": old,
            "to": new,
            "observed": fast,
            "target": spec.target,
            "comparator": spec.comparator,
            "burn_rate": bf,
            "window_s": spec.fast_window_s,
            "tick": self.tick_count,
        }
        st.transitions.append(dict(tr))
        del st.transitions[:-MAX_TRANSITIONS]
        self.history.append(dict(tr))
        del self.history[:-MAX_TRANSITIONS]
        return tr

    # --- fan-out ----------------------------------------------------------
    def _fan_out(self, tr: Dict[str, Any]) -> None:
        spec = self.specs[tr["slo"]]
        st = self._states[tr["slo"]]
        get_telemetry().counter("alert.transitions").add(1)
        flight_recorder.mark(
            "slo_alert", slo=tr["slo"], transition=f"{tr['from']}->{tr['to']}",
            observed=tr["observed"], target=tr["target"],
            burn_rate=tr["burn_rate"], window_s=tr["window_s"])
        if tr["to"] != STATE_FIRING:
            return
        self.alerts_fired += 1
        log.warning("SLO alert firing: %s (%s %s %s, observed %s, burn %.3g)",
                    tr["slo"], spec.series, spec.comparator, spec.target,
                    tr["observed"], tr["burn_rate"] or float("nan"))
        # one-shot evidence capture: the FIRST firing of each SLO dumps the
        # flight recorder (ring + counters + span stack) with the alert's
        # metadata attached, so the incident is debuggable after the fact
        if not st.snapshot_done:
            st.snapshot_done = True
            rec = flight_recorder.active()
            if rec is not None:
                alert = {
                    "slo": tr["slo"],
                    "series": spec.series,
                    "signal": spec.signal,
                    "window_s": tr["window_s"],
                    "observed": tr["observed"],
                    "target": tr["target"],
                    "comparator": tr["comparator"],
                    "burn_rate": tr["burn_rate"],
                    "transition": f"{tr['from']}->{tr['to']}",
                }
                with _alert_context_lock:
                    providers = list(_ALERT_CONTEXT)
                for fn in providers:
                    try:
                        extra = fn(spec)
                        if extra:
                            # base keys win: providers add evidence, they
                            # cannot rewrite the alert's own record
                            alert.update({k: v for k, v in extra.items()
                                          if k not in alert})
                    except Exception:  # noqa: BLE001 - evidence must not break fan-out
                        log.debug("alert-context provider failed", exc_info=True)
                st.snapshot_path = rec.dump(reason=f"slo_alert:{tr['slo']}",
                                            alert=alert)

    # --- background ticker ------------------------------------------------
    def start_ticker(self, interval_s: float) -> None:
        if self._ticker is not None:
            return
        self._ticker_stop.clear()

        def loop():
            while not self._ticker_stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - the ticker must survive
                    log.exception("slo tick failed")

        self._ticker = threading.Thread(target=loop, name="slo-ticker", daemon=True)
        self._ticker.start()

    def stop(self) -> None:
        if self._ticker is None:
            return
        self._ticker_stop.set()
        self._ticker.join(timeout=5)
        self._ticker = None

    # --- surfaces ---------------------------------------------------------
    def statusz(self) -> Dict[str, Any]:
        with self._lock:
            slos = {}
            for name, spec in self.specs.items():
                st = self._states[name]
                slos[name] = {
                    "state": st.state,
                    "series": spec.series,
                    "signal": spec.signal,
                    "comparator": spec.comparator,
                    "target": spec.target,
                    "observed": st.observed_fast,
                    "observed_slow": st.observed_slow,
                    "burn_fast": st.burn_fast,
                    "burn_slow": st.burn_slow,
                    "fast_window_s": spec.fast_window_s,
                    "slow_window_s": spec.slow_window_s,
                    "since_s": round(time.monotonic() - st.since_mono, 3),
                    "snapshot_path": st.snapshot_path,
                    "transitions": list(st.transitions),
                }
            return {
                "front": self.front,
                "tick_count": self.tick_count,
                "tick_ms": round(self.tick_ns / 1e6, 3),
                "fanout_ms": round(self.fanout_ns / 1e6, 3),
                "alerts_fired": self.alerts_fired,
                "slos": slos,
                "recent_transitions": list(self.history),
                "tsdb": self.store.statusz(),
            }

    def prom_gauges(self) -> List[tuple]:
        out: List[tuple] = []
        with self._lock:
            for name in self.specs:
                st = self._states[name]
                out.append(("alert_active", {"slo": name},
                            1.0 if st.state == STATE_FIRING else 0.0))
                if st.observed_fast is not None:
                    out.append(("slo_observed", {"slo": name}, float(st.observed_fast)))
                for window, burn in (("fast", st.burn_fast), ("slow", st.burn_slow)):
                    if burn is not None:
                        out.append(("slo_burn_rate", {"slo": name, "window": window},
                                    float(burn)))
        return out


# --- process-wide active engine ----------------------------------------------
_ENGINE: Optional[SLOEngine] = None
_engine_lock = threading.Lock()


def get_engine() -> Optional[SLOEngine]:
    return _ENGINE


def activate(args: Any = None, front: str = "engine") -> Optional[SLOEngine]:
    """Build a FRESH engine for this run (front's default pack merged with
    ``args.slo_spec``), install the tsdb emission hook, and make the engine
    the process-wide one (statusz/prom ride-alongs read it). Returns None
    when disabled (``FEDML_SLO=0`` or ``args.slo_disable``)."""
    global _ENGINE
    if os.environ.get(_ENV_DISABLE, "1") == "0":
        return None
    if args is not None and getattr(args, "slo_disable", False):
        return None
    _refuse_unported(args)
    specs = build_specs(front, args)
    with _engine_lock:
        old = _ENGINE
        store = tsdb.install()
        engine = SLOEngine(specs, store=store, front=front, args=args)
        engine.store.add_collector(_netlink_collector)
        _ENGINE = engine
    if old is not None:
        old.stop()
    tick_s = float(getattr(args, "slo_tick_s", 0) or 0) if args is not None else 0.0
    if front == "serving" and tick_s <= 0:
        tick_s = float(os.environ.get(_ENV_SERVING_TICK, "15"))
    if tick_s > 0:
        engine.start_ticker(tick_s)
    return engine


def deactivate(engine: Optional[SLOEngine]) -> None:
    """End a run's engine: stop its ticker and clear the process-wide slot
    (only if it still owns it) so finished runs stop surfacing alerts."""
    global _ENGINE
    if engine is None:
        return
    engine.stop()
    with _engine_lock:
        if _ENGINE is engine:
            _ENGINE = None
    tsdb.uninstall()


def reset() -> None:
    """Tests: drop the active engine, the tsdb hook, and any registered
    alert-context providers unconditionally."""
    global _ENGINE
    with _engine_lock:
        engine = _ENGINE
        _ENGINE = None
    if engine is not None:
        engine.stop()
    with _alert_context_lock:
        del _ALERT_CONTEXT[:]
    tsdb.reset()


def statusz_snapshot() -> Dict[str, Any]:
    """The `/statusz` ``alerts`` section; empty dict when no engine runs."""
    engine = _ENGINE
    return engine.statusz() if engine is not None else {}


def prom_gauges() -> List[tuple]:
    """``fedml_alert_*`` / ``fedml_slo_*`` ride-along for ``prom.render``."""
    engine = _ENGINE
    return engine.prom_gauges() if engine is not None else []


def _netlink_collector(store: tsdb.TimeSeriesStore) -> None:
    """Feed the worst per-pair link loss ratio into the tsdb each tick —
    the ``link_loss_ratio`` SLO keys on the fleet's worst link."""
    from . import netlink

    pairs = netlink.get_registry().pairs()
    if not pairs:
        return
    worst = max(s.loss_ratio() for s in pairs.values())
    store.record_gauge("link.loss_ratio", float(worst))
