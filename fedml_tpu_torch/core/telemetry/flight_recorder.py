"""Flight recorder: a bounded ring of structured events + JSONL crash dumps.

A copy of ``fedml_tpu/core/telemetry/flight_recorder.py`` (framework-free)
over the port's ``core.py``: the same ring, span hooks, excepthooks and
dump records (the JAX dump's ``mesh`` record is left out until the server
mesh is ported; a comm event's byte estimate is netlink's
``payload_nbytes``). Dumps land in ``~/.fedml_tpu_torch/crash``
unless ``FEDML_FR_DIR`` names another directory.

The telemetry registry answers "where did the time go" for runs that *finish*.
This module answers the other question — "what was the process doing when it
died" — the way an aircraft flight recorder does: a fixed-size ring buffer of
the last-N structured events (span opens/closes, comm sends/receives,
exceptions, free-form marks) that costs ~nothing while the run is healthy and
is serialized to ONE JSONL crash dump the moment it is not.

A dump carries, one JSON object per line:

- ``meta``       — reason, wall time, pid/role, schema version, drop counts
- ``exception``  — type/message/traceback of the triggering exception (if any)
- ``span_stack`` — the failing span stack: spans still open on the dumping
  thread plus the error-unwind trail (spans that exited *because of* the
  exception, innermost first — by dump time Python has already popped them,
  so the recorder keeps its own trail)
- ``counters`` / ``histograms`` / ``span_stats`` — registry snapshot
- ``trace``      — active distributed trace context (trace id, round)
- ``env``        — process environment with secret-shaped values redacted
- ``event`` ×N   — the ring, oldest first

Installation is either :func:`install` (process-level: chains
``sys.excepthook``/``threading.excepthook``, the only module of the port
that touches those) or the :func:`installed` context manager (scope-level:
dump + re-raise); the serving replica entrypoint installs it.

An enabled ``record()`` costs about a microsecond a call
(:func:`enabled_event_overhead_ns` measures it); with no active recorder
the module-level helpers are a None-check.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from . import core as _core
from .core import get_telemetry

__all__ = [
    "FlightRecorder",
    "active",
    "install",
    "uninstall",
    "installed",
    "record_event",
    "record_comm",
    "mark",
    "enabled_event_overhead_ns",
    "noop_event_overhead_ns",
]

# Canonical event kinds, the JAX module's: dumps of both packages read alike.
EVENT_SPAN_OPEN = "span_open"
EVENT_SPAN_CLOSE = "span_close"
EVENT_COMM_SEND = "comm_send"
EVENT_COMM_RECV = "comm_recv"
EVENT_EXCEPTION = "exception"
EVENT_MARK = "mark"
EVENT_KINDS = frozenset(
    (EVENT_SPAN_OPEN, EVENT_SPAN_CLOSE, EVENT_COMM_SEND, EVENT_COMM_RECV,
     EVENT_EXCEPTION, EVENT_MARK)
)

# v2: added the optional {"type": "fleet"} sketch-summary record
DUMP_SCHEMA_VERSION = 2

_ENV_DISABLE = "FEDML_FLIGHT_RECORDER"  # "0" disables recording entirely
_ENV_CAPACITY = "FEDML_FR_EVENTS"       # ring size (default below)
_ENV_DUMP_DIR = "FEDML_FR_DIR"          # where crash dumps land

DEFAULT_CAPACITY = 512
DEFAULT_DUMP_DIR = os.path.join("~", ".fedml_tpu_torch", "crash")

# Env var names whose VALUES must never reach a dump. Substring match,
# case-insensitive — the standard secret shapes.
_SECRET_MARKERS = ("SECRET", "TOKEN", "PASSWORD", "PASSWD", "CREDENTIAL",
                   "API_KEY", "APIKEY", "ACCESS_KEY", "PRIVATE", "AUTH")
_REDACTED = "<redacted>"


def redact_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Copy of the environment with secret-shaped values replaced."""
    src = os.environ if env is None else env
    out = {}
    for k, v in src.items():
        ku = k.upper()
        out[k] = _REDACTED if any(m in ku for m in _SECRET_MARKERS) else v
    return out


class FlightRecorder:
    """Bounded ring of (t_ns, kind, name, fields, tid) tuples + dump logic."""

    def __init__(self, capacity: Optional[int] = None,
                 dump_dir: Optional[str] = None,
                 enabled: Optional[bool] = None,
                 role: Optional[str] = None):
        if capacity is None:
            capacity = int(os.environ.get(_ENV_CAPACITY, DEFAULT_CAPACITY))
        self.capacity = max(int(capacity), 1)
        self.dump_dir = os.path.expanduser(
            dump_dir or os.environ.get(_ENV_DUMP_DIR, DEFAULT_DUMP_DIR))
        if enabled is None:
            enabled = os.environ.get(_ENV_DISABLE, "1") != "0"
        self.enabled = bool(enabled)
        self.role = role
        self._lock = threading.Lock()
        # manual ring (not deque(maxlen=...)): overwrite must COUNT as a drop
        self._ring: List[Optional[tuple]] = [None] * self.capacity
        self._next = 0
        self._count = 0
        self.dropped = 0
        self.dump_count = 0
        self.last_dump_path: Optional[str] = None
        self._tls = threading.local()
        self._epoch_ns = time.perf_counter_ns()

    # --- recording --------------------------------------------------------
    def record(self, kind: str, name: str, fields: Optional[Dict[str, Any]] = None) -> None:
        """Append one event; O(1), bounded, never raises."""
        if not self.enabled:
            return
        ev = (time.perf_counter_ns() - self._epoch_ns, kind, name, fields,
              threading.get_ident())
        with self._lock:
            if self._count >= self.capacity:
                self.dropped += 1  # overwrote the oldest event
            else:
                self._count += 1
            self._ring[self._next] = ev
            self._next = (self._next + 1) % self.capacity

    def events(self) -> List[tuple]:
        """Ring contents, oldest first."""
        with self._lock:
            if self._count < self.capacity:
                return [e for e in self._ring[: self._count]]
            return [e for e in self._ring[self._next:] + self._ring[: self._next]]

    # --- span hooks (wired into core.Telemetry via install) ---------------
    def _error_trail(self) -> List[Dict[str, Any]]:
        trail = getattr(self._tls, "error_trail", None)
        if trail is None:
            trail = self._tls.error_trail = []
        return trail

    def on_span(self, opened: bool, span: Any, errored: bool) -> None:
        """Called by ``core._Span`` enter/exit when this recorder is active."""
        attrs = span.attrs or None
        if opened:
            # a fresh span on this thread means the previous unwind (if any)
            # completed without killing the process — clear the trail
            trail = self._error_trail()
            if trail:
                trail.clear()
            self.record(EVENT_SPAN_OPEN, span.name, attrs)
            return
        if errored:
            # Python pops `with tel.span(...)` blocks while the exception is
            # STILL propagating; remember them so dump() can show the failing
            # stack even though the registry's thread stack is already empty.
            self._error_trail().append(
                {"name": span.name, "attrs": _json_safe_dict(attrs)})
        fields = dict(attrs) if attrs else {}
        fields["dur_ms"] = round((span.dur_ns or 0) / 1e6, 3)
        if errored:
            fields["error"] = True
        self.record(EVENT_SPAN_CLOSE, span.name, fields)

    def record_exception(self, exc_type, exc, tb=None) -> None:
        self.record(EVENT_EXCEPTION, getattr(exc_type, "__name__", str(exc_type)),
                    {"message": str(exc)})

    # --- dump -------------------------------------------------------------
    def span_stack(self) -> List[Dict[str, Any]]:
        """The failing span stack for the calling thread: spans still open in
        the telemetry registry (outermost first) + the error-unwind trail
        (spans already popped by the in-flight exception, innermost last)."""
        stack: List[Dict[str, Any]] = []
        try:
            for sp in get_telemetry()._stack():
                stack.append({"name": sp.name, "attrs": _json_safe_dict(sp.attrs or None),
                              "open": True})
        except Exception:  # noqa: BLE001 - diagnostics must not throw
            pass
        trail = getattr(self._tls, "error_trail", None)
        if trail:
            # trail is innermost-first (unwind order); append outermost-first
            for rec in reversed(trail):
                stack.append({"name": rec["name"], "attrs": rec["attrs"],
                              "open": False})
        return stack

    def dump(self, path: Optional[str] = None, reason: str = "explicit",
             exc_info: Optional[tuple] = None,
             alert: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write one JSONL crash dump; returns the path (None on I/O failure).
        Never raises — the recorder must not mask the original exception.
        ``alert`` attaches the triggering SLO's metadata (slo.py one-shot
        snapshots) so a reader can say *why* this dump exists."""
        try:
            if path is None:
                os.makedirs(self.dump_dir, exist_ok=True)
                stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
                path = os.path.join(
                    self.dump_dir, f"fr_{stamp}_pid{os.getpid()}_{self.dump_count}.jsonl")
            lines: List[Dict[str, Any]] = []
            evs = self.events()
            lines.append({
                "type": "meta",
                "schema": DUMP_SCHEMA_VERSION,
                "reason": reason,
                "time_unix": time.time(),  # a record timestamp, not a duration
                "pid": os.getpid(),
                "role": self.role,
                "python": sys.version.split()[0],
                "events": len(evs),
                "capacity": self.capacity,
                "dropped": self.dropped,
            })
            if exc_info is not None and exc_info[0] is not None:
                etype, evalue, etb = exc_info
                lines.append({
                    "type": "exception",
                    "class": getattr(etype, "__name__", str(etype)),
                    "message": str(evalue),
                    "traceback": traceback.format_exception(etype, evalue, etb),
                })
            if alert:
                lines.append(dict({"type": "alert"}, **alert))
            lines.append({"type": "span_stack", "spans": self.span_stack()})
            try:
                snap = get_telemetry().summary()
            except Exception:  # noqa: BLE001 - diagnostics must not throw
                snap = {}
            lines.append({"type": "counters", "counters": snap.get("counters", {}),
                          "dropped": snap.get("dropped", 0)})
            lines.append({"type": "histograms",
                          "histograms": snap.get("histograms", {}),
                          "span_stats": snap.get("span_stats", {})})
            ctx = None
            try:
                from . import trace_context
                cur = trace_context.current()
                if cur is not None:
                    ctx = {"trace_id": cur.trace_id, "parent": cur.parent_span_id,
                           "round": cur.round_idx}
            except Exception:  # noqa: BLE001
                pass
            lines.append({"type": "trace", "context": ctx})
            # fleet sketch summary (quantile table, top-k offenders, budget
            # state) whenever a fleet view is active — the bounded stand-in
            # for per-rank state a million-client dump can't carry
            try:
                from . import sketches as _fleet_sketches

                fleet_snap = _fleet_sketches.statusz_snapshot()
            except Exception:  # noqa: BLE001 - diagnostics must not throw
                fleet_snap = None
            if fleet_snap:
                lines.append(dict({"type": "fleet"}, **fleet_snap))
            lines.append({"type": "env", "env": redact_env()})
            for t_ns, kind, name, fields, tid in evs:
                rec = {"type": "event", "t_ns": t_ns, "kind": kind, "name": name,
                       "tid": tid}
                if fields:
                    rec["fields"] = _json_safe_dict(fields)
                lines.append(rec)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                for rec in lines:
                    f.write(json.dumps(rec) + "\n")
            os.replace(tmp, path)  # atomic: a reader never sees half a dump
            self.dump_count += 1
            self.last_dump_path = path
            return path
        except Exception:  # noqa: BLE001 - never mask the crashing exception
            try:
                sys.stderr.write("flight recorder: dump failed\n")
            except Exception:  # noqa: BLE001
                pass
            return None

    # --- introspection ----------------------------------------------------
    def statusz(self) -> Dict[str, Any]:
        with self._lock:
            count = self._count
        return {
            "installed": self is _ACTIVE,
            "enabled": self.enabled,
            "role": self.role,
            "events": count,
            "capacity": self.capacity,
            "dropped": self.dropped,
            "dump_count": self.dump_count,
            "last_dump_path": self.last_dump_path,
            "dump_dir": self.dump_dir,
        }


def _json_safe_dict(d: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if not d:
        return None
    return {k: _core._json_safe(v) for k, v in d.items()}


# --- process-wide active recorder --------------------------------------------
_ACTIVE: Optional[FlightRecorder] = None
_install_lock = threading.Lock()
# the live install's hooks and what each found on top (put back on uninstall)
_sys_hook: Optional["_ChainedHook"] = None
_sys_restore: Any = None
_threading_hook: Optional["_ChainedHook"] = None
_threading_restore: Any = None
_install_depth = 0


def active() -> Optional[FlightRecorder]:
    return _ACTIVE


def _span_hook(opened: bool, span: Any, exc_type) -> None:
    r = _ACTIVE
    if r is not None:
        r.on_span(opened, span, exc_type is not None)


class _ChainedHook:
    """One install's ``sys.excepthook`` or ``threading.excepthook``.

    While it is the live install's hook it records the exception and dumps;
    once that install is undone it only passes the exception on. Either way
    it then calls ``prev``: the hook it found at install time, with any hook
    of this module skipped, else the interpreter's default. So this module's
    hooks never chain to one another or to themselves, and a hook that an
    uninstall could not take off the stack (another recorder, the JAX
    package's, installed over it and later put it back) still reaches the
    default hook."""

    __slots__ = ("prev", "threaded")

    def __init__(self, prev: Any, threaded: bool):
        while isinstance(prev, _ChainedHook):
            prev = prev.prev
        self.prev = prev
        self.threaded = threaded

    def __call__(self, *args) -> None:
        r = _ACTIVE
        if r is not None and (self is _sys_hook or self is _threading_hook):
            if self.threaded:
                a = args[0]
                exc_info = (a.exc_type, a.exc_value, a.exc_traceback)
                reason = "unhandled_thread_exception"
            else:
                exc_info, reason = args, "unhandled_exception"
            r.record_exception(*exc_info)
            r.dump(reason=reason, exc_info=exc_info)
        prev = self.prev
        if prev is None:
            prev = threading.__excepthook__ if self.threaded else sys.__excepthook__
        prev(*args)


def install(role: Optional[str] = None,
            recorder: Optional[FlightRecorder] = None) -> FlightRecorder:
    """Activate a process-wide recorder: span hooks into the telemetry
    registry plus chained ``sys.excepthook``/``threading.excepthook`` so any
    unhandled exception writes a crash dump. Idempotent and refcounted —
    nested installs share the one active recorder; :func:`uninstall` restores
    the previous hooks when the last install exits."""
    global _ACTIVE, _sys_hook, _sys_restore, _threading_hook, _threading_restore
    global _install_depth
    with _install_lock:
        _install_depth += 1
        if _ACTIVE is None:
            _ACTIVE = recorder or FlightRecorder(role=role)
            _core._span_event_hook = _span_hook
            _sys_restore = sys.excepthook
            _sys_hook = _ChainedHook(_sys_restore, threaded=False)
            sys.excepthook = _sys_hook
            _threading_restore = threading.excepthook
            _threading_hook = _ChainedHook(_threading_restore, threaded=True)
            threading.excepthook = _threading_hook
        elif role and _ACTIVE.role is None:
            _ACTIVE.role = role
        return _ACTIVE


def uninstall() -> None:
    """Undo one :func:`install`; when the depth hits 0 each hook is taken
    off the top if it is still there (under another recorder's hook it
    stays, passing exceptions down its chain)."""
    global _ACTIVE, _sys_hook, _sys_restore, _threading_hook, _threading_restore
    global _install_depth
    with _install_lock:
        if _install_depth == 0:
            return
        _install_depth -= 1
        if _install_depth > 0:
            return
        _core._span_event_hook = None
        if sys.excepthook is _sys_hook:
            sys.excepthook = _sys_restore
        if threading.excepthook is _threading_hook:
            threading.excepthook = _threading_restore
        _sys_hook = _sys_restore = _threading_hook = _threading_restore = None
        _ACTIVE = None


@contextmanager
def installed(role: Optional[str] = None, dump_on_error: bool = True):
    """Scope-level install: the sp simulator and the cross-silo managers wrap
    their run loops in this so an exception anywhere inside produces exactly
    one crash dump and still propagates to the caller."""
    rec = install(role=role)
    try:
        yield rec
    except BaseException as e:  # noqa: BLE001 - record, dump, re-raise
        if dump_on_error and not isinstance(e, GeneratorExit):
            rec.record_exception(type(e), e, e.__traceback__)
            rec.dump(reason="exception", exc_info=(type(e), e, e.__traceback__))
        raise
    finally:
        uninstall()


# --- module-level fast paths (a None-check when no recorder is active) -------
def record_event(kind: str, name: str, **fields: Any) -> None:
    r = _ACTIVE
    if r is not None:
        r.record(kind, name, fields or None)


def mark(name: str, **fields: Any) -> None:
    """Free-form breadcrumb (round boundaries, state transitions)."""
    r = _ACTIVE
    if r is not None:
        r.record(EVENT_MARK, name, fields or None)


def record_comm(direction: str, message: Any) -> None:
    """Book one comm-layer send/receive. Duck-typed against ``Message``;
    called by ``FedMLCommManager`` for every backend, so the last dump shows
    who was talking to whom when the process died."""
    r = _ACTIVE
    if r is None:
        return
    kind = EVENT_COMM_SEND if direction == "send" else EVENT_COMM_RECV
    try:
        sender = message.get_sender_id()
        receiver = message.get_receiver_id()
        from . import netlink

        fields = {
            "sender": sender,
            "receiver": receiver,
            # who was talking to whom, and how much: the peer is the far end
            # of this event's direction, the bytes are the payload estimate
            "peer": receiver if direction == "send" else sender,
            "bytes": netlink.payload_nbytes(message),
        }
        name = str(message.get_type())
    except Exception:  # noqa: BLE001 - diagnostics must not throw
        fields, name = None, "unknown"
    r.record(kind, name, fields)


# --- overhead probes ----------------------------------------------------------
def enabled_event_overhead_ns(iters: int = 2000, batches: int = 5) -> float:
    """Per-call cost of ``record()`` on an enabled recorder, in ns (min over
    batches so scheduler noise cannot inflate it)."""
    rec = FlightRecorder(capacity=256, enabled=True)
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            rec.record(EVENT_MARK, "overhead.probe")
        per_call = (time.perf_counter_ns() - t0) / iters
        if per_call < best:
            best = per_call
    return best


def noop_event_overhead_ns(iters: int = 2000, batches: int = 5) -> float:
    """Per-call cost of the module-level helper with NO active recorder —
    the price every instrumented call site pays in a healthy run."""
    best = float("inf")
    saved = _ACTIVE
    try:
        _deactivate()
        for _ in range(batches):
            t0 = time.perf_counter_ns()
            for _ in range(iters):
                record_event(EVENT_MARK, "overhead.probe")
            per_call = (time.perf_counter_ns() - t0) / iters
            if per_call < best:
                best = per_call
    finally:
        _reactivate(saved)
    return best


def _deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def _reactivate(rec: Optional[FlightRecorder]) -> None:
    global _ACTIVE
    _ACTIVE = rec
