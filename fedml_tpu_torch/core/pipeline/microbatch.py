"""Micro-batch sizing from the measured link-cost model.

A copy of ``fedml_tpu/core/pipeline/microbatch.py`` (framework-free) over
the port's netlink. The pipelined executor only hides communication if each chunk's transfer
time fits under the compute time that remains while it is in flight.
This module asks :class:`~fedml_tpu_torch.core.telemetry.netlink.LinkCostModel`
what the link actually costs and picks the number of micro-batches *m*
accordingly.

Sizing rule. Probing the cost model at ``total`` and
``total/2`` bytes recovers the affine transfer law ``t(n) = base + n *
per_byte`` the model embeds (half-RTT plus bytes over measured
bandwidth). The *bulk* term ``per_byte * total`` is paid once no matter
how we chunk; only the ``base`` term multiplies with *m*. So the largest
*m* whose added latency still fits under compute satisfies

    base * m  <=  compute_s - per_byte * total

and we clamp to ``[min_chunks, max_chunks]``. Degenerate regimes get an
explicit reason instead of a silent guess: a cold or low-confidence model
falls back to ``default_chunks``; a bandwidth-bound link (bulk alone
exceeds compute — nothing can hide it) pins a small *m* to cap queue
memory; a free link (no measurable base) takes ``max_chunks``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..telemetry import netlink


@dataclass
class MicroBatchPlan:
    """The planner's verdict: how many chunks, and why."""

    n_micro_batches: int
    chunk_nbytes: int
    predicted_chunk_transfer_s: Optional[float]
    confidence: float
    reason: str  # "balanced" | "low_confidence" | "bandwidth_bound" | "free_link"

    def as_dict(self) -> dict:
        return {
            "n_micro_batches": self.n_micro_batches,
            "chunk_nbytes": self.chunk_nbytes,
            "predicted_chunk_transfer_s": (
                None if self.predicted_chunk_transfer_s is None
                else round(self.predicted_chunk_transfer_s, 6)),
            "confidence": round(self.confidence, 4),
            "reason": self.reason,
        }


def plan_micro_batches(
    total_nbytes: int,
    compute_s: float,
    *,
    src: int,
    dst: int,
    cost_model: Optional["netlink.LinkCostModel"] = None,
    min_chunks: int = 1,
    max_chunks: int = 8,
    default_chunks: int = 4,
    min_confidence: float = 0.25,
) -> MicroBatchPlan:
    """Size micro-batches so chunked uplink hides under ``compute_s``.

    ``total_nbytes`` is the full upload for the work unit (one client's
    delta, or one batch of activations); ``compute_s`` the local compute
    it should hide under. ``src``/``dst`` are comm ranks for the link-cost
    lookup. A model with no usable signal never blocks the pipeline — it
    just yields ``default_chunks`` with reason ``low_confidence``.
    """
    total_nbytes = max(1, int(total_nbytes))
    compute_s = max(0.0, float(compute_s))
    model = cost_model if cost_model is not None else netlink.get_registry().cost_model()

    full = model.predict_transfer_s(src, dst, total_nbytes)
    half = model.predict_transfer_s(src, dst, total_nbytes // 2)
    confidence = min(full.confidence, half.confidence)

    def _plan(m: int, reason: str, chunk_s: Optional[float]) -> MicroBatchPlan:
        m = max(min_chunks, min(max_chunks, int(m)))
        return MicroBatchPlan(
            n_micro_batches=m,
            chunk_nbytes=-(-total_nbytes // m),  # ceil division
            predicted_chunk_transfer_s=chunk_s,
            confidence=confidence,
            reason=reason,
        )

    if full.seconds is None or half.seconds is None or confidence < min_confidence:
        return _plan(default_chunks, "low_confidence", None)

    # Two-point recovery of t(n) = base + n * per_byte.
    base = max(0.0, 2.0 * half.seconds - full.seconds)
    per_byte = max(0.0, (full.seconds - half.seconds) / max(1, total_nbytes // 2))
    bulk_s = per_byte * total_nbytes

    if compute_s <= bulk_s:
        # Bandwidth-bound: the bytes alone outlast compute; chunking only
        # adds latency, so keep m small to cap in-flight memory.
        m = max(2, min_chunks)
        return _plan(m, "bandwidth_bound", base + bulk_s / m)
    if base <= 1e-9:
        return _plan(max_chunks, "free_link", bulk_s / max_chunks)

    m = int((compute_s - bulk_s) / base)
    m = max(min_chunks, min(max_chunks, m))
    return _plan(m, "balanced", base + bulk_s / m)


def even_micro_batches(batch_size: int, target_chunks: int) -> int:
    """Largest ``m <= target_chunks`` that divides ``batch_size`` evenly.

    Split learning slices a fixed batch of examples, and ragged final
    micro-batches would change summation order vs the unsplit reference;
    an even split keeps the parity test honest. Falls back to 1 (never 0).
    """
    batch_size = max(1, int(batch_size))
    for m in range(min(batch_size, max(1, int(target_chunks))), 0, -1):
        if batch_size % m == 0:
            return m
    return 1
