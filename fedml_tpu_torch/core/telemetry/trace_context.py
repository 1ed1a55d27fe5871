"""W3C-traceparent-style trace context for cross-process span correlation.

A copy of ``fedml_tpu/core/telemetry/trace_context.py``: the same header
key and wire format, so a JAX peer and the port read each other's traces.

A federated round is a multi-process story: the server opens a ``server.round``
span, broadcasts, and N clients train in other processes (or threads). This
module carries ``(trace_id, parent_span_id, round_idx)`` across the comm layer
so client spans become children of the server's round span in one fleet trace.

Wire format (adapted from W3C traceparent ``version-traceid-parentid-flags``)::

    "00-<32 hex trace_id>-<16 hex parent span seq>-<round_idx decimal>"

The parent id is the registry ``seq`` of the originating span (zero-padded to
16 hex digits; all-zeros means "no parent"), and the flags field is reused for
the federated round index (``-1`` when unset). The string rides in a reserved
``Message`` header key — the *only* place the literal lives is
``RESERVED_TELEMETRY_KEY`` below, so user payload keys can never collide
with it.

This module imports nothing outside the stdlib and the telemetry core, so
``core/distributed/communication/message.py`` can import it safely.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional

from . import core as _core
from .core import get_telemetry

# Reserved Message header key. Canonical literal — everything else (Message,
# backends, managers, the lint tool) must reference this constant.
RESERVED_TELEMETRY_KEY = "__telemetry__"

# Sub-keys inside the reserved header dict.
TRACEPARENT_FIELD = "tp"  # traceparent string (this module)
DELTA_FIELD = "delta"     # client delta snapshot (fleet.py consumes)
SENT_AT_FIELD = "ts"      # sender wall-clock ns at send (netlink.py stamps/reads)
LINK_FIELD = "link"       # client link-pair snapshot inside the delta (netlink.py)

_VERSION = "00"
_NO_PARENT = "0" * 16

MALFORMED_COUNTER = "telemetry.trace_ctx_malformed"


class TraceContext:
    """Immutable-ish carrier for the active trace."""

    __slots__ = ("trace_id", "parent_span_id", "round_idx")

    def __init__(self, trace_id: str, parent_span_id: Optional[int] = None,
                 round_idx: Optional[int] = None):
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.round_idx = round_idx

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, TraceContext)
            and self.trace_id == other.trace_id
            and self.parent_span_id == other.parent_span_id
            and self.round_idx == other.round_idx
        )

    def __repr__(self) -> str:  # pragma: no cover
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"parent={self.parent_span_id}, round={self.round_idx})")

    # --- wire encoding ---------------------------------------------------
    def to_traceparent(self) -> str:
        parent = _NO_PARENT if self.parent_span_id is None else f"{int(self.parent_span_id):016x}"
        rnd = -1 if self.round_idx is None else int(self.round_idx)
        return f"{_VERSION}-{self.trace_id}-{parent}-{rnd}"

    @classmethod
    def from_traceparent(cls, header: str) -> Optional["TraceContext"]:
        """Tolerant parse; malformed input returns None (old-sender compat)."""
        if not isinstance(header, str):
            return None
        parts = header.split("-")
        # round_idx may itself be negative ("-1"), splitting into an extra
        # empty field — rejoin anything past the third dash.
        if len(parts) < 4:
            return None
        version, trace_id, parent = parts[0], parts[1], parts[2]
        rnd_str = "-".join(parts[3:])
        if version != _VERSION:
            return None
        if len(trace_id) != 32 or not _is_hex(trace_id):
            return None
        if len(parent) != 16 or not _is_hex(parent):
            return None
        try:
            rnd = int(rnd_str)
        except ValueError:
            return None
        return cls(
            trace_id=trace_id,
            parent_span_id=None if parent == _NO_PARENT else int(parent, 16),
            round_idx=None if rnd < 0 else rnd,
        )


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


def new_trace_id() -> str:
    """128-bit random trace id, 32 lowercase hex chars (W3C shape)."""
    return os.urandom(16).hex()


# --- thread-local active context ----------------------------------------
_tls = threading.local()


def current() -> Optional[TraceContext]:
    """The trace context active on this thread, if any."""
    return getattr(_tls, "ctx", None)


# Enabled-path span records pick up the active context through this hook
# (core cannot import this module — it would be circular).
_core._trace_ctx_getter = current


def set_current(ctx: Optional[TraceContext]) -> None:
    _tls.ctx = ctx


@contextmanager
def activated(ctx: Optional[TraceContext]):
    """Scope ``ctx`` as the active context; restores the previous one on exit.

    ``activated(None)`` deliberately *clears* the context so a message from an
    old sender (no header) does not inherit whatever trace the receive loop
    last handled.
    """
    prev = current()
    set_current(ctx)
    try:
        yield ctx
    finally:
        set_current(prev)


# --- Message header inject / extract -------------------------------------
def inject(message: Any) -> None:
    """Attach the active trace context to an outgoing ``Message``.

    Called by every backend's ``send_message``. Merges into an existing
    reserved header (a client may already have attached a ``delta`` snapshot)
    without overwriting other fields.
    """
    ctx = current()
    if ctx is None:
        return
    header = message.get(RESERVED_TELEMETRY_KEY)
    if not isinstance(header, dict):
        header = {}
        message.add_params(RESERVED_TELEMETRY_KEY, header)
    header.setdefault(TRACEPARENT_FIELD, ctx.to_traceparent())


def extract(message: Any) -> Optional[TraceContext]:
    """Parse the trace context from an incoming ``Message``.

    Absent header → None (old sender; caller clears the context).
    Malformed header → None + ``telemetry.trace_ctx_malformed`` counter bump,
    never an exception — a bad peer must not kill the receive loop.
    """
    try:
        header = message.get(RESERVED_TELEMETRY_KEY)
    except Exception:  # noqa: BLE001 - duck-typed message
        return None
    if header is None:
        return None
    if isinstance(header, str):  # bare traceparent string also accepted
        tp = header
    elif isinstance(header, dict):
        tp = header.get(TRACEPARENT_FIELD)
        if tp is None:
            return None
    else:
        get_telemetry().counter(MALFORMED_COUNTER).add(1)
        return None
    ctx = TraceContext.from_traceparent(tp)
    if ctx is None:
        get_telemetry().counter(MALFORMED_COUNTER).add(1)
    return ctx


def telemetry_header(message: Any) -> Optional[Dict[str, Any]]:
    """The reserved header dict from a message, or None. Convenience for
    consumers of the ``delta`` field (fedml_aggregator)."""
    header = message.get(RESERVED_TELEMETRY_KEY)
    return header if isinstance(header, dict) else None
