"""Local DP frame: counterpart of ``fedml_tpu/core/dp/frames/ldp.py``
(reference python/fedml/core/dp/frames/ldp.py ``LocalDP``): each client
perturbs its own update before it leaves; the server folds the noisy
updates untouched."""

from __future__ import annotations

from typing import Any

from ..mechanisms import create_mechanism
from .base_dp_frame import BaseDPFrame


class LocalDP(BaseDPFrame):
    def __init__(self, args: Any):
        super().__init__(args)
        self.set_ldp(create_mechanism(
            getattr(args, "mechanism_type", "gaussian"),
            epsilon=float(getattr(args, "epsilon", 1.0)),
            delta=float(getattr(args, "delta", 1e-5)),
            sensitivity=float(getattr(args, "sensitivity", 1.0)),
        ))
