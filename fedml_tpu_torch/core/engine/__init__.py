"""core.engine: the round engine's synchronous loop, its sp and vmapped
strategies and sinks (counterpart of ``fedml_tpu/core/engine``; the placement
search is not ported)."""

from .round_engine import (
    AggregationSink,
    AlgFrameSink,
    ClientExecutionStrategy,
    InProcessSequentialStrategy,
    RoundEngine,
    RoundResult,
    StackedBucketedSink,
    VmappedMegabatchStrategy,
    eval_due,
    sample_cohort,
)

__all__ = [
    "AggregationSink",
    "AlgFrameSink",
    "ClientExecutionStrategy",
    "InProcessSequentialStrategy",
    "RoundEngine",
    "RoundResult",
    "StackedBucketedSink",
    "VmappedMegabatchStrategy",
    "eval_due",
    "sample_cohort",
]
