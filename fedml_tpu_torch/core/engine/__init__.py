"""core.engine: the round engine's synchronous loop, its sp, vmapped and
cross-silo strategies and sinks (counterpart of ``fedml_tpu/core/engine``; the placement
search is not ported)."""

from .round_engine import (
    AggregationSink,
    AlgFrameSink,
    ClientExecutionStrategy,
    InProcessSequentialStrategy,
    RemoteCommStrategy,
    RoundEngine,
    RoundResult,
    StackedBucketedSink,
    VmappedMegabatchStrategy,
    eval_due,
    knob_set,
    refuse_chaos_knobs,
    refuse_knobs,
    run_local_round,
    sample_cohort,
    sample_from_pool,
    sample_silos,
)

__all__ = [
    "AggregationSink",
    "AlgFrameSink",
    "ClientExecutionStrategy",
    "InProcessSequentialStrategy",
    "RemoteCommStrategy",
    "RoundEngine",
    "RoundResult",
    "StackedBucketedSink",
    "VmappedMegabatchStrategy",
    "eval_due",
    "knob_set",
    "refuse_chaos_knobs",
    "refuse_knobs",
    "run_local_round",
    "sample_cohort",
    "sample_from_pool",
    "sample_silos",
]
