"""Hierarchical asynchronous aggregation: edge → regional → root.

The counterpart of ``fedml_tpu/core/distributed/hierarchy.py``. A single
async buffer removes the round barrier but still funnels every client upload
through one server. This module composes buffers into a tree: clients submit
to **edge** nodes, each edge folds its own publish window and forwards the
published model UP as one ``(window weight, model)`` submission to its
**regional** parent, regionals forward to the **root**, and a root publish
bumps the fleet-wide model version which propagates DOWN to every tier.
Per-node fan-in stays O(children) no matter how many clients the fleet has.

Every tier runs the SAME :class:`~..aggregation.async_buffer.AsyncAggBuffer`
the cross-silo server runs in async mode, over one bucketed engine, on the
tree's device (``device``, the card unless the caller names the CPU; an
arrival on another device is refused). A forward hands the child's published
state dict to the parent by reference: no copy between tiers. The tree is
in-process only, as in the JAX package: no cross-silo deployment of the
tiers exists in either.

Observability flows up with the models: client fleet-telemetry deltas merge
into the edge's :class:`FleetTelemetry` AND, below the sketch threshold,
replay to every ancestor; each publish carries the child's merged sketch
view one hop up (the parent replaces that child's slot), so the root's
``sketch_view`` is the flat merge of every edge's sketches. Publishes run
under the tree's trace context (one trace id per root model version).

Staleness clock: client versions are ROOT model versions (the only version
clients ever see). After every root publish the tree syncs each node's
buffer version to the root version, so an edge judges staleness against the
newest global model even though its own buffer publishes more often. The
sync stamps versions only: no tier receives a copy of the model; clients
read :meth:`HierarchyTree.latest_model`.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

import torch

from .. import telemetry as tel
from ...device import resolve_device
from ..aggregation.async_buffer import AsyncAggBuffer, StalenessPolicy
from ..telemetry import FleetTelemetry, TraceContext, new_trace_id
from ..telemetry import sketches as _sketches

StateDict = Dict[str, torch.Tensor]

TIER_EDGE = "edge"
TIER_REGIONAL = "regional"
TIER_ROOT = "root"

FORWARD_COUNTER = "hierarchy.forwards"  # fedml_hierarchy_forwards_total


class HierarchyNode:
    """One aggregation tier node: an async buffer + a fleet-telemetry view
    of its subtree. Thread-safe through the buffer's own lock plus a node
    lock around the fleet merge / forward bookkeeping."""

    def __init__(self, name: str, tier: str, buffer: AsyncAggBuffer,
                 parent: Optional["HierarchyNode"] = None,
                 device: Any = None):
        self.name = str(name)
        self.tier = str(tier)
        self.buffer = buffer
        self.parent = parent
        self.device = None if device is None else torch.device(device)
        self.children: List["HierarchyNode"] = []
        self.fleet = FleetTelemetry()
        # set by core.privacy.HierarchyPrivacy: the node's privacy session
        # (edge WindowCoordinator / regional ring pass-through / root
        # unmasker). When set, child forwards fold at weight 1.0 — the tiers
        # are carrying ring-masked integer vectors and a weighted fold would
        # scale the masks out of exact cancellation.
        self.privacy = None
        self.forwards = 0
        self._lock = threading.Lock()
        # child submissions need a stable integer rank for the buffer's
        # staleness clock; allocated on first forward from each child
        self._child_ranks: Dict[str, int] = {}
        self._on_publish = None  # root-only: set by HierarchyTree
        if parent is not None:
            parent.children.append(self)

    # --- upward flow -------------------------------------------------------
    def submit(self, rank: int, model_params: StateDict, sample_num: float,
               client_version: Optional[int],
               telemetry_delta: Optional[dict] = None) -> str:
        """One client (or child-tier) arrival. Merges telemetry into this
        node (and, below the sketch threshold, replays the delta up the
        ancestor chain for exact per-rank fidelity), folds the model into
        this node's buffer, and cascades a publish upward when the window
        fills. Above the threshold ancestors see only the sketch summaries
        this node forwards one hop per publish."""
        self._check_device(model_params)
        if telemetry_delta is not None:
            with self._lock:
                self.fleet.merge_client_delta(rank, telemetry_delta)
                replay_up = not self.fleet.sketch_mode
            if replay_up:
                node: Optional[HierarchyNode] = self.parent
                while node is not None:
                    with node._lock:
                        node.fleet.merge_client_delta(rank, telemetry_delta,
                                                      direct=False)
                    node = node.parent
        verdict = self.buffer.submit(rank, model_params, sample_num, client_version)
        if client_version is not None:
            staleness = max(0, self.buffer.version - int(client_version))
            with self._lock:
                self.fleet.sketches.observe_staleness(rank, float(staleness))
        self._maybe_publish()
        return verdict

    def _check_device(self, model_params: StateDict) -> None:
        if self.device is None or not model_params:
            return
        dev = next(iter(model_params.values())).device
        if dev != self.device:
            raise ValueError(
                f"{self.name}: an arrival on {dev}, and the tree folds on {self.device}")

    def _maybe_publish(self) -> None:
        if not self.buffer.ready():
            return
        with tel.span("hierarchy.publish", node=self.name, tier=self.tier,
                      version=self.buffer.version):
            model = self.buffer.publish()
        if model is None:
            return
        if self.parent is not None:
            with self._lock:
                self.forwards += 1
            tel.counter(FORWARD_COUNTER).add(1)
            self.parent._submit_from_child(self, self.buffer.last_publish_weight, model)
        elif self._on_publish is not None:
            self._on_publish(model)

    def _submit_from_child(self, child: "HierarchyNode", weight: float,
                           model: StateDict) -> None:
        with self._lock:
            rank = self._child_ranks.setdefault(child.name, len(self._child_ranks))
        # the child's merged sketch view rides the publish (ONE hop, no new
        # round trip): the parent replaces that child's slot, so the root's
        # sketch_view always equals the flat merge of every edge's sketches
        with child._lock:
            wire = child.fleet.wire_view()
        with self._lock:
            self.fleet.merge_client_delta(rank, {"sketches": wire})
        # a child's publish is already the freshest model its subtree has:
        # forward at the child's current (synced) version so the staleness
        # decay never double-penalizes the extra tier hop
        if self.privacy is not None:
            weight = 1.0
            self.privacy.before_fold(model)  # ring values fold exactly, or not at all
        self.buffer.submit(rank, model, weight, client_version=self.buffer.version)
        self._maybe_publish()

    def flush_sketches(self) -> None:
        """Force one sketch forward to the parent outside the publish cycle
        (end-of-run exposition: the last partial window still counts)."""
        if self.parent is None:
            return
        with self._lock:
            wire = self.fleet.wire_view()
        with self.parent._lock:
            rank = self.parent._child_ranks.setdefault(
                self.name, len(self.parent._child_ranks))
            self.parent.fleet.merge_client_delta(rank, {"sketches": wire})

    # --- introspection -----------------------------------------------------
    def statusz(self) -> Dict[str, Any]:
        with self._lock:
            doc = {
                "tier": self.tier,
                "parent": self.parent.name if self.parent else None,
                "children": [c.name for c in self.children],
                "forwards": self.forwards,
                "fleet_merges": self.fleet.merges,
                "sketch_observations": self.fleet.sketch_view().observations,
            }
        doc["buffer"] = self.buffer.statusz()
        return doc

    def prom_gauges(self) -> List[tuple]:
        labels = {"node": self.name, "tier": self.tier}
        out = [(name, {**lbl, **labels}, v) for name, lbl, v in self.buffer.prom_gauges()]
        with self._lock:
            out.append(("hierarchy_forwards", labels, float(self.forwards)))
        return out


class HierarchyTree:
    """The whole edge→regional→root assembly plus the downward version sync.

    ``submit`` routes a client to its edge by ``rank % n_edges`` (a caller
    may route by calling ``edge.submit`` directly). ``latest_model`` /
    ``version`` are what clients pull — the root's most recent publish.
    """

    def __init__(self, root: HierarchyNode, regionals: Sequence[HierarchyNode],
                 edges: Sequence[HierarchyNode], initial_model: Optional[StateDict] = None):
        self.root = root
        self.regionals = list(regionals)
        self.edges = list(edges)
        self.device = root.device
        self._lock = threading.Lock()
        if initial_model is not None:
            root._check_device(initial_model)
        self._model = initial_model
        self._trace = TraceContext(new_trace_id(), round_idx=root.buffer.version)
        root._on_publish = self._on_root_publish
        # the root's merged sketch view is THE fleet summary for this
        # process: the /metrics, /statusz and tsdb riders read the active
        # provider (last-built tree wins; tests reset)
        _sketches.set_active_provider(self._root_sketch_view)

    @classmethod
    def build(cls, n_edges: int, regional_fanout: int = 4,
              publish_k: int = 8, root_publish_k: Optional[int] = None,
              policy: Optional[StalenessPolicy] = None,
              engine=None, initial_model: Optional[StateDict] = None,
              device: Any = "cuda") -> "HierarchyTree":
        """Assemble a tree with ``n_edges`` edges grouped ``regional_fanout``
        per regional. Tiers share one engine but each node owns its buffer;
        every node folds on ``device`` (CUDA without a card raises here)."""
        if n_edges < 1:
            raise ValueError(f"n_edges must be >= 1, got {n_edges}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        mk = lambda k: AsyncAggBuffer(  # noqa: E731
            publish_k=k, policy=policy or StalenessPolicy(), engine=engine)
        n_regionals = max(1, -(-n_edges // int(regional_fanout)))
        root = HierarchyNode("root", TIER_ROOT, mk(root_publish_k or max(1, n_regionals)),
                             device=dev)
        # a regional publishes once every child-publish-cycle: its window is
        # capped by how many edges it ACTUALLY parents (round-robin split), or
        # a sparse tier (e.g. 1 edge under a fanout-4 regional) stalls forever
        n_children = [n_edges // n_regionals + (1 if r < n_edges % n_regionals else 0)
                      for r in range(n_regionals)]
        regionals = [HierarchyNode(f"regional-{i}", TIER_REGIONAL,
                                   mk(max(1, min(publish_k, regional_fanout, n_children[i]))),
                                   parent=root, device=dev)
                     for i in range(n_regionals)]
        edges = [HierarchyNode(f"edge-{i}", TIER_EDGE, mk(publish_k),
                               parent=regionals[i % n_regionals], device=dev)
                 for i in range(int(n_edges))]
        return cls(root, regionals, edges, initial_model=initial_model)

    # --- client-facing -----------------------------------------------------
    def submit(self, rank: int, model_params: StateDict, sample_num: float,
               client_version: Optional[int] = None,
               telemetry_delta: Optional[dict] = None) -> str:
        edge = self.edges[int(rank) % len(self.edges)]
        with tel.activated(self._trace):
            return edge.submit(rank, model_params, sample_num, client_version,
                               telemetry_delta=telemetry_delta)

    def latest_model(self) -> Optional[StateDict]:
        with self._lock:
            return self._model

    @property
    def version(self) -> int:
        return self.root.buffer.version

    # --- downward flow -----------------------------------------------------
    def _on_root_publish(self, model: StateDict) -> None:
        version = self.root.buffer.version
        with self._lock:
            self._model = model
            # new trace per global model generation: the next cascade of
            # edge/regional publishes groups under the new round index
            self._trace = TraceContext(new_trace_id(), round_idx=version)
        with tel.span("hierarchy.version_sync", version=version):
            for node in self.regionals + self.edges:
                # sync the staleness clocks: every tier now judges arrivals
                # against the newest GLOBAL model version
                with node.buffer._lock:
                    node.buffer.version = version

    def _root_sketch_view(self):
        with self.root._lock:
            return self.root.fleet.sketch_view()

    def flush_sketches(self) -> None:
        """Propagate every node's current sketch view up one tier per hop
        (edges → regionals → root), so end-of-run exposition includes the
        windows that never filled a publish."""
        for node in self.edges + self.regionals:
            node.flush_sketches()

    # --- introspection -----------------------------------------------------
    def nodes(self) -> List[HierarchyNode]:
        return [self.root] + self.regionals + self.edges

    def statusz(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "n_edges": len(self.edges),
            "n_regionals": len(self.regionals),
            "nodes": {n.name: n.statusz() for n in self.nodes()},
        }

    def prom_gauges(self) -> List[tuple]:
        out: List[tuple] = []
        for n in self.nodes():
            out.extend(n.prom_gauges())
        return out
