"""Base DP frame: counterpart of ``fedml_tpu/core/dp/frames/base_dp_frame.py``
(reference python/fedml/core/dp/frames/base_dp_solution.py).

A frame owns an optional local (client) and central (server) mechanism and
the three entry points the alg-frame hooks call: ``add_local_noise``,
``global_clip`` and ``add_global_noise``, with ``set_params_for_dp`` for the
frames that need the round's statistics. Noise comes from the explicit
generator the caller passes.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from ....utils.pytree import StateDict, tree_clip_by_global_norm

GradList = List[Tuple[float, StateDict]]


class BaseDPFrame:
    def __init__(self, args: Any = None):
        self.args = args
        self.cdp = None  # central mechanism
        self.ldp = None  # local mechanism
        self.max_grad_norm = getattr(args, "max_grad_norm", None)

    def set_cdp(self, mechanism) -> None:
        self.cdp = mechanism

    def set_ldp(self, mechanism) -> None:
        self.ldp = mechanism

    def add_local_noise(self, local_grad: StateDict, gen: torch.Generator,
                        extra_auxiliary_info: Any = None) -> StateDict:
        return self.ldp.add_noise(local_grad, gen)

    def add_global_noise(self, global_model: StateDict, gen: torch.Generator) -> StateDict:
        return self.cdp.add_noise(global_model, gen)

    def global_clip(self, raw_client_grad_list: GradList) -> GradList:
        """Per-client L2 clip of the whole update (reference
        base_dp_solution.py:43-57)."""
        if self.max_grad_norm is None:
            return raw_client_grad_list
        c = float(self.max_grad_norm)
        return [(n, tree_clip_by_global_norm(g, c)) for n, g in raw_client_grad_list]

    def set_params_for_dp(self, raw_client_grad_list: GradList) -> None:
        pass

    def get_rdp_scale(self) -> Optional[float]:
        mech = self.cdp if self.cdp is not None else self.ldp
        return getattr(mech, "sigma", None) if mech is not None else None
