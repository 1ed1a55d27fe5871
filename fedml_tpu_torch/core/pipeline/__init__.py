"""Micro-batched pipelined round execution (counterpart of
``fedml_tpu/core/pipeline``).

``executor`` is the generic staged pipeline (worker threads + bounded
queues + overlap accounting), ``microbatch`` sizes chunks from netlink's
link-cost model, and ``strategy`` adapts both to the round engine as the
``PipelinedExecution`` client strategy (``client_execution: pipelined`` on
the sp front). The paged serving engine's admission wave rides the same
executor; the split-learning front that drives it in JAX is not ported
(ROADMAP.md, Queue 1).

Import from here, not from ``core.engine``: the engine package stays an
import-time leaf, and this package pulls in aggregation and compression at
use time.
"""

from .executor import (
    PipelineError,
    PipelineReport,
    PipelinedExecutor,
    StageSpec,
    StageStats,
)
from .microbatch import MicroBatchPlan, even_micro_batches, plan_micro_batches
from .strategy import (
    PipelinedBufferSink,
    PipelinedExecution,
    build_pipelined_execution,
)

__all__ = [
    "PipelineError",
    "PipelineReport",
    "PipelinedExecutor",
    "StageSpec",
    "StageStats",
    "MicroBatchPlan",
    "even_micro_batches",
    "plan_micro_batches",
    "PipelinedBufferSink",
    "PipelinedExecution",
    "build_pipelined_execution",
]
