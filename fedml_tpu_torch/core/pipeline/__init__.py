"""Staged pipeline executor (counterpart of ``fedml_tpu/core/pipeline``).

Only the generic executor is ported so far; the micro-batch planner and the
round-engine strategy wait for the FedAvg slice (ROADMAP.md).
"""

from .executor import (
    PipelineError,
    PipelineReport,
    PipelinedExecutor,
    StageSpec,
    StageStats,
)

__all__ = [
    "PipelineError",
    "PipelineReport",
    "PipelinedExecutor",
    "StageSpec",
    "StageStats",
]
