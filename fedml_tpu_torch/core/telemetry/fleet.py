"""Fleet telemetry: merge per-client delta snapshots into one cohort view.

A copy of ``fedml_tpu/core/telemetry/fleet.py``, with modelwatch's
contribution ledger (``ledger``, built on first use). A delta's ``link`` block (the client's netlink
pairs) is merged into this process's netlink registry, and the exported
trace carries netlink's message-flow arrows. The fleet sketches are here (``sketches.py``): every
view feeds its own :class:`~.sketches.FleetSketches`, past the exact-rank
threshold new ranks feed the sketches only, a hierarchy child's merged
sketch wire replaces that child's slot, and a trace above the lane budget
collapses to one summary lane plus the top offenders' lanes.

Clients attach ``Telemetry.delta_snapshot()`` output to their model-upload
message (under the reserved header's ``"delta"`` field); the server merges
them here keyed by client rank. ``export_fleet_trace`` then writes a single
Perfetto JSON where the server is one process lane (pid 0) and every client
rank is its own pid lane — straggler bubbles and comm gaps line up visually.

Cross-host clock alignment: each delta carries ``epoch_unix_ns`` (wall-clock
estimate of that registry's perf-counter epoch). Client span timestamps are
shifted by ``client_epoch - server_epoch`` so lanes share the server's
timebase; NTP-level skew (~ms) is visible but the round structure survives.

In a single-process simulation all parties share ONE registry (same epoch, so
the shift degenerates to ~0) and client deltas are thread-filtered; the
server lane excludes any thread a client has claimed, so each span appears in
exactly one lane.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, List, Optional, Set

from . import sketches as _sketches
from .core import Telemetry, get_telemetry
from .health import HealthTracker

log = logging.getLogger(__name__)

MAX_FLEET_SPANS_PER_CLIENT = 50_000

# the client span whose duration is the health model's round-time signal
TRAIN_SPAN_NAME = "client.train"

# every top-level delta key this version understands; anything else is a
# newer client's stat block — skipped and counted, never a crash (mixed
# fleets upgrade one party at a time). "sketches" is a child tier's merged
# FleetSketches wire dict riding the same vocabulary (hierarchy forwards one
# hop per publish); "link" is the client's netlink pair snapshot.
_KNOWN_DELTA_KEYS = frozenset({
    "spans", "counters", "histograms", "span_stats", "thread_names",
    "epoch_unix_ns", "dropped", "link", "sketches",
})


class FleetTelemetry:
    """Server-side accumulator of client telemetry deltas, keyed by rank."""

    def __init__(self, max_spans_per_client: int = MAX_FLEET_SPANS_PER_CLIENT):
        self.max_spans_per_client = int(max_spans_per_client)
        self._clients: Dict[int, Dict[str, Any]] = {}
        self.merges = 0
        self.rejected = 0
        # a delta from a rank outside the expected cohort (late upload after
        # a reshuffle) is logged + skipped, never raised mid-aggregation
        self.stale = 0
        # unknown top-level delta keys skipped (forward-compat with newer
        # clients); the key names are kept so /statusz shows WHAT was dropped
        self.unknown_dropped = 0
        self.unknown_keys: Set[str] = set()
        self.expected_ranks: Optional[Set[int]] = None
        self.health = HealthTracker()
        self._ledger = None  # modelwatch ContributionLedger, built on first use
        # mergeable fleet sketches: round-time/delta-norm/staleness quantiles,
        # top-k offenders, distinct-clients HLL. Always fed (cheap); above
        # the exact-mode threshold NEW ranks fold into sketches ONLY, so
        # per-rank memory stays bounded at O(threshold) while the sketch view
        # keeps covering the whole fleet.
        self.sketches = _sketches.FleetSketches()
        self.exact_threshold = _sketches.exact_threshold()
        self.sketch_only_merges = 0
        # child-tier sketch slots: a hierarchy child REPLACES its slot on
        # every publish with its subtree's merged view, so ``sketch_view``
        # never double-counts across publishes
        self._child_sketches: Dict[int, _sketches.FleetSketches] = {}

    @property
    def ledger(self):
        """The per-client contribution ledger (``telemetry.modelwatch``),
        built on first use; its delta norms feed this fleet's sketches."""
        led = self._ledger
        if led is None:
            from .modelwatch import ContributionLedger

            led = self._ledger = ContributionLedger()
            led.sketches = self.sketches
        return led

    def set_expected_ranks(self, ranks) -> None:
        """Declare this round's cohort; ``None`` accepts any rank."""
        self.expected_ranks = None if ranks is None else {int(r) for r in ranks}

    @property
    def sketch_mode(self) -> bool:
        """True once the tracked-rank count has reached the exact-mode
        threshold: new ranks fold into sketches only from here on."""
        return len(self._clients) >= self.exact_threshold

    def wire_view(self) -> Dict[str, Any]:
        """The merged view serialized for one forward hop. Skips the
        defensive ``sketch_view`` copy when there are no child slots (edge
        nodes — the common case; this rides EVERY hierarchy publish)."""
        if not self._child_sketches:
            return self.sketches.to_wire()
        return self.sketch_view().to_wire()

    def sketch_view(self) -> "_sketches.FleetSketches":
        """This node's merged fleet view: own sketches ⊕ every child tier's
        latest forwarded slot (each slot is already that subtree's view)."""
        out = self.sketches.copy()
        for child in self._child_sketches.values():
            out.merge(child)
        return out

    def merge_client_delta(self, rank: int, delta: Any, direct: bool = True) -> bool:
        """Fold one client delta in; returns False (and counts it) on junk.
        Defensive by design — a misbehaving client must not crash the server's
        receive loop. ``direct=False`` marks a delta replayed up an ancestor
        chain: the per-rank exact path still merges, but sketches are NOT fed
        (each observation belongs to exactly one node's sketches, or the
        hierarchy would double-count on every forward)."""
        if not isinstance(delta, dict):
            self.rejected += 1
            return False
        try:
            rank = int(rank)
        except (TypeError, ValueError):
            self.rejected += 1
            return False
        if self.expected_ranks is not None and rank not in self.expected_ranks:
            self.stale += 1
            self.health.heartbeat(rank)  # it is alive, just late/stale
            log.warning(
                "fleet: skipping delta from unexpected rank %d (cohort %s); "
                "late upload after reshuffle?", rank, sorted(self.expected_ranks),
            )
            return False
        wire = delta.get("sketches")
        if isinstance(wire, dict):
            # a child tier's merged subtree view: REPLACE that child's slot
            # (the wire is cumulative — adding it would double-count)
            try:
                self._child_sketches[rank] = _sketches.FleetSketches.from_wire(wire)
            except (ValueError, KeyError, TypeError):
                log.warning("fleet: unusable sketch wire from rank %d", rank)
            if set(delta) <= {"sketches"}:
                self.merges += 1
                return True
        if self.sketch_mode and rank not in self._clients:
            # beyond the exact threshold a NEW rank gets no per-rank entry
            # and no per-rank health row — its signal lives in the sketches
            if direct:
                self._feed_sketches_only(rank, delta)
            self.sketch_only_merges += 1
            self.merges += 1
            return True
        ent = self._clients.setdefault(
            rank, {"spans": [], "counters": {}, "histograms": {}, "span_stats": {},
                   "thread_names": {}, "epoch_unix_ns": None, "dropped": 0,
                   "client_dropped": 0}
        )
        spans = delta.get("spans")
        if isinstance(spans, list):
            for r in spans:
                if not (isinstance(r, dict) and "name" in r and "t0_ns" in r and "dur_ns" in r):
                    continue
                self._observe_health(rank, r, feed_sketches=direct)
                if len(ent["spans"]) >= self.max_spans_per_client:
                    ent["dropped"] += 1
                    continue
                ent["spans"].append(r)
        # cumulative aggregates: latest delta wins
        for key in ("counters", "histograms", "span_stats"):
            val = delta.get(key)
            if isinstance(val, dict):
                ent[key] = val
        names = delta.get("thread_names")
        if isinstance(names, dict):
            ent["thread_names"].update({str(k): str(v) for k, v in names.items()})
        if isinstance(delta.get("epoch_unix_ns"), (int, float)):
            ent["epoch_unix_ns"] = int(delta["epoch_unix_ns"])
        if isinstance(delta.get("dropped"), int):
            # client-side Telemetry.dropped is cumulative: latest wins
            ent["client_dropped"] = delta["dropped"]
        unknown = set(delta) - _KNOWN_DELTA_KEYS
        if unknown:
            self.unknown_dropped += len(unknown)
            new = unknown - self.unknown_keys
            if new:
                self.unknown_keys.update(new)
                log.warning(
                    "fleet: skipping unknown delta key(s) %s from rank %d "
                    "(newer client version? merge continues without them)",
                    sorted(new), rank)
        link = delta.get("link")
        if isinstance(link, dict) and link:
            # client-observed per-pair link estimates: fold into the server's
            # netlink registry (it only adopts pairs it cannot measure itself)
            from . import netlink

            try:
                netlink.get_registry().merge_remote(rank, link)
            except (TypeError, ValueError):  # a junk estimator summary
                log.warning("fleet: link snapshot from rank %d unusable", rank)
        self.merges += 1
        self.health.heartbeat(rank)
        return True

    def _observe_health(self, rank: int, span_rec: Dict[str, Any],
                        feed_sketches: bool = True) -> None:
        """Feed the health model from the merged span stream: each completed
        ``client.train`` span is one round-time observation (or a failure,
        when the span unwound on an exception). Direct arrivals also feed the
        fleet sketches (bounded fleet-wide quantiles + offenders)."""
        if span_rec.get("name") != TRAIN_SPAN_NAME:
            return
        try:
            if span_rec.get("error"):
                self.health.observe_failure(rank)
                return
            dur_s = float(span_rec["dur_ns"]) / 1e9
            attrs = span_rec.get("attrs") or {}
            round_idx = attrs.get("round") if isinstance(attrs, dict) else None
            self.health.observe_round(rank, dur_s, round_idx)
            if feed_sketches:
                self.sketches.observe_round_time(rank, dur_s)
        except (TypeError, ValueError, KeyError):
            pass  # malformed span record: fleet merge already tolerates it

    def _feed_sketches_only(self, rank: int, delta: Dict[str, Any]) -> None:
        """Sketch-mode ingest for a rank with no per-rank entry: fold its
        ``client.train`` durations into the sketches and drop the rest."""
        spans = delta.get("spans")
        if not isinstance(spans, list):
            return
        for r in spans:
            if not (isinstance(r, dict) and r.get("name") == TRAIN_SPAN_NAME):
                continue
            try:
                if not r.get("error"):
                    self.sketches.observe_round_time(rank, float(r["dur_ns"]) / 1e9)
            except (TypeError, ValueError, KeyError):
                pass

    @property
    def ranks(self) -> List[int]:
        return sorted(self._clients)

    def summary(self) -> Dict[str, Any]:
        """Per-rank roll-up, small enough for the mlops uplink every round."""
        per_client = {}
        for rank, ent in self._clients.items():
            per_client[str(rank)] = {
                "span_stats": ent["span_stats"],
                "counters": ent["counters"],
                "histograms": ent["histograms"],
                "spans_merged": len(ent["spans"]),
                "dropped": ent["dropped"] + ent["client_dropped"],
            }
        doc = {"clients": per_client, "merges": self.merges,
               "rejected": self.rejected, "stale": self.stale,
               "unknown_dropped": self.unknown_dropped,
               "unknown_keys": sorted(self.unknown_keys)}
        view = self.sketch_view()
        if view.observations:
            doc["sketches"] = view.snapshot()
        if self.sketch_only_merges:
            doc["sketch_only_merges"] = self.sketch_only_merges
        return doc

    # --- export ----------------------------------------------------------
    def export_fleet_trace(self, path: str, server: Optional[Telemetry] = None,
                           max_client_lanes: Optional[int] = None) -> str:
        """One Perfetto JSON: server lane (pid 0) + one pid lane per client.

        Above ``max_client_lanes`` (default: the exposition budget's
        per-family cap) the per-rank lanes collapse to ONE summary lane
        carrying the sketch quantile table, plus lanes for only the top-k
        offender ranks — a 10k-client trace stays loadable."""
        server = server or get_telemetry()
        server_epoch = server.epoch_unix_ns()
        snap = server.snapshot()
        if max_client_lanes is None:
            max_client_lanes = _sketches.get_budget().per_family
        lane_ranks = self.ranks
        summary_lane = len(lane_ranks) > int(max_client_lanes)
        if summary_lane:
            view = self.sketch_view()
            have = set(lane_ranks)
            lane_ranks = []
            for ki, _ in view.offenders.topk():  # sorted worst-first
                if ki in have:
                    lane_ranks.append(int(ki))
                if len(lane_ranks) >= int(max_client_lanes):
                    break
        # Threads shipped by any client belong to that client's lane, not the
        # server's (single-process sim: one shared registry).
        client_tids = set()
        for ent in self._clients.values():
            for r in ent["spans"]:
                client_tids.add(r.get("tid"))

        events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": "server"}},
        ]
        for r in snap["spans"]:
            if r["tid"] in client_tids:
                continue
            events.append(_span_event(r, pid=0, shift_ns=0))
        if summary_lane:
            # one bounded lane for the whole fleet: sketch quantiles +
            # offender table as args, one instant event to anchor it
            pid = _FLEET_SUMMARY_PID
            n = len(self._clients) + self.sketch_only_merges
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": f"fleet-summary ({n} clients, "
                                                      f"{len(lane_ranks)} offender lanes)"}})
            events.append({"ph": "i", "name": "fleet.sketch_summary", "pid": pid,
                           "tid": 0, "ts": 0, "s": "g",
                           "args": view.snapshot()})
        for rank in lane_ranks:
            ent = self._clients[rank]
            pid = int(rank)
            events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                           "args": {"name": f"client-{rank}"}})
            for tid_s, tname in ent["thread_names"].items():
                try:
                    tid = int(tid_s)
                except ValueError:
                    continue
                events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                               "args": {"name": tname}})
            shift_ns = 0
            if ent["epoch_unix_ns"] is not None:
                shift_ns = ent["epoch_unix_ns"] - server_epoch
            for r in ent["spans"]:
                events.append(_span_event(r, pid=pid, shift_ns=shift_ns))
        # measured message flows: arrows from sender lane to receiver lane
        # carrying bytes + the pair's live bandwidth/RTT estimates
        from . import netlink

        events.extend(netlink.get_registry().flow_events(server_epoch))
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


# the summary lane's pid: far outside any plausible rank space
_FLEET_SUMMARY_PID = 999_999_999


def _span_event(r: Dict[str, Any], pid: int, shift_ns: int) -> Dict[str, Any]:
    args = dict(r.get("attrs") or {})
    args["seq"] = r.get("seq")
    for k in ("trace_id", "trace_parent", "trace_round"):
        if k in r:
            args[k] = r[k]
    if r.get("error"):
        args["error"] = True
    return {
        "ph": "X",
        "name": r["name"],
        "ts": (r["t0_ns"] + shift_ns) / 1e3,
        "dur": r["dur_ns"] / 1e3,
        "pid": pid,
        "tid": r.get("tid", 0),
        "args": args,
    }
