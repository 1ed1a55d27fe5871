"""Resilience subsystem: durable round state, quorum aggregation, retrying
comms (counterpart of ``fedml_tpu/core/resilience``).

- :mod:`round_state` — atomic, async round-boundary checkpoints with a
  completion watermark, plus crash-resume for the sp simulator and the
  cross-silo server;
- :mod:`quorum` — deadline-based partial aggregation so one dead client
  cannot hang a synchronous round forever, with straggler-aware cohort
  over-provisioning, and the async buffer's staleness verdicts;
- :mod:`retry` — the one retry/backoff policy the comm backends share
  (exponential + jitter, budget-capped, ``comm.retry.<backend>`` counters).

:func:`statusz_snapshot` is the ``resilience`` block of the JAX package's
`/statusz` page, fed by the module-level registry the three submodules
update as they act; the page itself is not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import threading
from typing import Any, Dict

from .quorum import QuorumPolicy, RoundQuorum, overprovisioned_cohort_size
from .retry import RETRY_COUNTER_PREFIX, RetryPolicy, retry_call, transient_error
from .round_state import RoundState, RoundStateStore

__all__ = [
    "QuorumPolicy",
    "RoundQuorum",
    "RetryPolicy",
    "RoundState",
    "RoundStateStore",
    "retry_call",
    "transient_error",
    "overprovisioned_cohort_size",
    "note",
    "statusz_snapshot",
]

# Process-wide "most recent resilience facts" for a status page: what
# happened last, not an event log.
_lock = threading.Lock()
_state: Dict[str, Any] = {}


def note(**facts: Any) -> None:
    """Record status facts (e.g. ``note(last_checkpoint_round=7)``)."""
    with _lock:
        _state.update(facts)


def statusz_snapshot() -> Dict[str, Any]:
    """The ``resilience`` block: last checkpointed round, quorum stats, and
    the retry counters from the telemetry registry."""
    from ..telemetry import core as tel_core

    with _lock:
        doc: Dict[str, Any] = dict(_state)
    t = tel_core.get_telemetry()
    retries = {
        name[len(RETRY_COUNTER_PREFIX):]: c.value
        for name, c in t._counters.items()
        if name.startswith(RETRY_COUNTER_PREFIX)
    }
    if retries:
        doc["comm_retries"] = retries
    for key, counter_name in (
        ("quorum_partial_total", "quorum.partial"),
        ("quorum_late_discarded_total", "quorum.late_discarded"),
        ("quorum_stale_accepted_total", "quorum.stale_accepted"),
        ("quorum_stale_rejected_total", "quorum.stale_rejected"),
        ("checkpoint_dropped_total", "checkpoint.dropped"),
    ):
        c = t._counters.get(counter_name)
        if c is not None:
            doc[key] = c.value
    return doc
