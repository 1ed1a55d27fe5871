"""Central (global) DP frame: counterpart of ``fedml_tpu/core/dp/frames/cdp.py``
(reference python/fedml/core/dp/frames/cdp.py ``GlobalDP``): the server
clips each client update (``max_grad_norm``) and noises the aggregate. The
facade owns the one accountant and steps it on every ``add_global_noise``.
"""

from __future__ import annotations

from typing import Any

from ..mechanisms import create_mechanism
from .base_dp_frame import BaseDPFrame


class GlobalDP(BaseDPFrame):
    def __init__(self, args: Any):
        super().__init__(args)
        self.set_cdp(create_mechanism(
            getattr(args, "mechanism_type", "gaussian"),
            epsilon=float(getattr(args, "epsilon", 1.0)),
            delta=float(getattr(args, "delta", 1e-5)),
            sensitivity=float(getattr(args, "sensitivity", 1.0)),
        ))
