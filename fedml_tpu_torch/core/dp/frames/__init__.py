"""DP solution frames: counterpart of ``fedml_tpu/core/dp/frames``
(reference python/fedml/core/dp/frames/)."""

from .base_dp_frame import BaseDPFrame
from .cdp import GlobalDP
from .dp_clip import DPClip
from .ldp import LocalDP
from .nbafl import NbAFLDP


def create_dp_frame(args) -> BaseDPFrame:
    """The frame ``args.dp_solution_type`` names (reference
    fedml_differential_privacy.py:33-47)."""
    solution = str(getattr(args, "dp_solution_type", "cdp")).lower()
    if solution == "cdp":
        return GlobalDP(args)
    if solution == "ldp":
        return LocalDP(args)
    if solution == "nbafl":
        return NbAFLDP(args)
    if solution in ("dp_clip", "dpclip"):
        return DPClip(args)
    raise ValueError(f"unknown dp_solution_type {solution!r}")


__all__ = ["BaseDPFrame", "GlobalDP", "LocalDP", "NbAFLDP", "DPClip", "create_dp_frame"]
