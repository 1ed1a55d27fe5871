"""The one retry/backoff policy for transient faults: a copy of
``fedml_tpu/core/resilience/retry.py``.

Every networked send path retries through here (wired into
``FedMLCommManager.send_message``), so retry behavior is uniform and
observable.

Semantics:

- **exponential backoff with full jitter**: attempt *n* sleeps
  ``uniform(delay*(1-jitter), delay)`` where ``delay = min(base * mult^n,
  max_delay)`` — the AWS-style decorrelation that keeps a restarted fleet
  from retrying in lockstep;
- **budget-capped**: both an attempt cap and an elapsed-time budget; the
  budget wins (a slow failing call does not get its full attempt count);
- **observable**: each retry bumps ``comm.retry.<label>``, books a
  flight-recorder ``retry`` event and logs a warning.

The success path is one ``try`` — no clock read, no allocation beyond the
generator frame — so wrapping a healthy send costs nothing measurable.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)

# counter("comm.retry.<backend>"), the JAX package's name
RETRY_COUNTER_PREFIX = "comm.retry."

EVENT_RETRY = "retry"


def transient_error(exc: BaseException) -> bool:
    """Default retryability test: connection-shaped faults and the comm
    codec's explicit ``ValueError`` (truncated/corrupt frame) are transient;
    programming errors are not. gRPC's ``RpcError`` does not subclass
    ``OSError`` — match it (and similar wrapper exceptions) by name."""
    if isinstance(exc, (ConnectionError, TimeoutError, OSError, ValueError)):
        return True
    name = type(exc).__name__
    return "RpcError" in name or "Unavailable" in name or "Timeout" in name


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule + budget. Immutable so one policy instance can be
    shared across threads/backends."""

    max_attempts: int = 5
    base_delay_s: float = 0.2
    max_delay_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.5          # fraction of each delay randomized away
    budget_s: Optional[float] = 120.0  # total elapsed cap; None = attempts only

    def delay_bounds(self, attempt: int) -> tuple:
        """(lo, hi) sleep bounds before retry ``attempt`` (1-based)."""
        hi = min(self.base_delay_s * (self.multiplier ** (attempt - 1)), self.max_delay_s)
        lo = hi * (1.0 - max(0.0, min(1.0, self.jitter)))
        return lo, hi

    @classmethod
    def from_args(cls, args: Any) -> Optional["RetryPolicy"]:
        """Build from an Arguments namespace; None when retries are disabled
        (``comm_retry_max_attempts`` <= 1 or unset-to-default-off)."""
        attempts = int(getattr(args, "comm_retry_max_attempts", 5) or 0)
        if attempts <= 1:
            return None
        return cls(
            max_attempts=attempts,
            base_delay_s=float(getattr(args, "comm_retry_base_delay_s", 0.2)),
            max_delay_s=float(getattr(args, "comm_retry_max_delay_s", 5.0)),
            budget_s=float(getattr(args, "comm_retry_budget_s", 120.0)),
        )


def retry_call(
    fn: Callable[[], Any],
    *,
    policy: RetryPolicy,
    label: str = "call",
    is_retryable: Optional[Callable[[BaseException], bool]] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: Optional[random.Random] = None,
) -> Any:
    """Call ``fn()`` under ``policy``. Retries only faults ``is_retryable``
    accepts (default :func:`transient_error`); re-raises the last error once
    attempts or the elapsed budget are exhausted. ``sleep``/``clock``/``rng``
    are injectable for deterministic tests."""
    is_retryable = is_retryable or transient_error
    t0: Optional[float] = None
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as exc:  # noqa: BLE001 - filtered by is_retryable below
            attempt += 1
            if t0 is None:
                t0 = clock()
            if not is_retryable(exc) or attempt >= policy.max_attempts:
                raise
            lo, hi = policy.delay_bounds(attempt)
            delay = (rng.uniform(lo, hi) if rng is not None else random.uniform(lo, hi))
            if policy.budget_s is not None and (clock() - t0) + delay > policy.budget_s:
                raise
            _book_retry(label, attempt, delay, exc)
            if on_retry is not None:
                on_retry(attempt, exc)
            sleep(delay)


def _book_retry(label: str, attempt: int, delay_s: float, exc: BaseException) -> None:
    """Counter + flight-recorder breadcrumb for one retry decision."""
    from ..telemetry import flight_recorder
    from ..telemetry.core import get_telemetry

    get_telemetry().counter(RETRY_COUNTER_PREFIX + label).add(1)
    flight_recorder.record_event(
        EVENT_RETRY, label, attempt=attempt, delay_s=round(delay_s, 4), error=repr(exc)
    )
    log.warning("%s failed (%r); retry %d in %.2fs", label, exc, attempt, delay_s)
