"""Differential-privacy facade: counterpart of
``fedml_tpu/core/dp/fedml_differential_privacy.py`` (reference
``python/fedml/core/dp/fedml_differential_privacy.py:13``).

A process-wide singleton configured from ``args`` by ``fedml_tpu_torch.init``
and called only from the alg-frame hooks: ``add_local_noise`` (client side),
``global_clip`` and ``add_global_noise`` (server side). The frame
``args.dp_solution_type`` names does the work (``frames/``: cdp, ldp,
nbafl, dp_clip).

One RDP accountant lives here, stepped once a round: on each
``add_global_noise`` for the central frames, in ``global_clip`` for LDP.
Noise comes from one generator per device seeded with ``random_seed + 7``
(JAX's key offset).
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional, Tuple

from ...utils.pytree import StateDict
from .budget_accountant.rdp_accountant import RDPAccountant
from .frames import create_dp_frame
from .frames.cdp import GlobalDP
from .frames.ldp import LocalDP
from .mechanisms.gaussian import DeviceGenerators

DP_SOLUTION_CDP = "cdp"
DP_SOLUTION_LDP = "ldp"
DP_SOLUTION_NBAFL = "nbafl"
DP_SOLUTION_DP_CLIP = "dp_clip"

LOCAL_SOLUTIONS = (DP_SOLUTION_LDP, DP_SOLUTION_NBAFL, DP_SOLUTION_DP_CLIP)
GLOBAL_SOLUTIONS = (DP_SOLUTION_CDP, DP_SOLUTION_NBAFL, DP_SOLUTION_DP_CLIP)
SEED_OFFSET = 7


def dp_solution(args: Any) -> Optional[str]:
    """The DP solution ``args`` turns on, or None."""
    if not getattr(args, "enable_dp", False):
        return None
    s = str(getattr(args, "dp_solution_type", DP_SOLUTION_CDP)).lower()
    return DP_SOLUTION_DP_CLIP if s == "dpclip" else s


class FedMLDifferentialPrivacy:
    _instance: Optional["FedMLDifferentialPrivacy"] = None

    @classmethod
    def get_instance(cls) -> "FedMLDifferentialPrivacy":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self) -> None:
        self.is_enabled = False
        self.dp_solution = None
        self.frame = None
        self.accountant = None
        self.sample_rate = 1.0
        self.generators = DeviceGenerators(SEED_OFFSET)

    def init(self, args: Any) -> None:
        self.is_enabled = bool(getattr(args, "enable_dp", False))
        if not self.is_enabled:
            self.dp_solution, self.frame, self.accountant = None, None, None
            return
        self.dp_solution = dp_solution(args)
        self.frame = create_dp_frame(args)
        # one clipping knob: clipping_norm feeds the per-client global-norm
        # clip unless the frame clips its own way (NbAFL, DPClip) or
        # max_grad_norm is set
        clipping_norm = getattr(args, "clipping_norm", None)
        if (clipping_norm is not None and self.frame.max_grad_norm is None
                and isinstance(self.frame, (GlobalDP, LocalDP))):
            self.frame.max_grad_norm = float(clipping_norm)
        self.accountant = RDPAccountant()
        self.sample_rate = float(getattr(args, "client_num_per_round", 1)) / float(
            getattr(args, "client_num_in_total", 1))
        self.generators = DeviceGenerators(int(getattr(args, "random_seed", 0)) + SEED_OFFSET)
        logging.info("DP enabled: solution=%s clip=%s", self.dp_solution, self.frame.max_grad_norm)

    # --- enable predicates (queried from the hooks) --------------------------
    def is_dp_enabled(self) -> bool:
        return self.is_enabled

    def is_local_dp_enabled(self) -> bool:
        return self.is_enabled and self.dp_solution in LOCAL_SOLUTIONS

    def is_global_dp_enabled(self) -> bool:
        return self.is_enabled and self.dp_solution in GLOBAL_SOLUTIONS

    def is_central_dp_enabled(self) -> bool:
        return self.is_global_dp_enabled()

    def is_clipping(self) -> bool:
        return self.is_enabled and self.frame is not None and self.frame.max_grad_norm is not None

    # --- noising (reference :88-103) -----------------------------------------
    def add_local_noise(self, local_grad: StateDict, extra_auxiliary_info: Any = None) -> StateDict:
        """Client-side perturbation. ``extra_auxiliary_info`` is the dict the
        client hook fills with ``global_model_params`` (DPClip's anchor) and
        ``local_sample_num`` (NbAFL's m)."""
        if isinstance(self.frame, LocalDP) and self.frame.max_grad_norm is not None:
            local_grad = self.frame.global_clip([(1.0, local_grad)])[0][1]
        return self.frame.add_local_noise(local_grad, self.generators.for_tree(local_grad),
                                          extra_auxiliary_info)

    def add_global_noise(self, global_model: StateDict) -> StateDict:
        out = self.frame.add_global_noise(global_model, self.generators.for_tree(global_model))
        if not isinstance(self.frame, LocalDP):
            self._account_step()
        return out

    def global_clip(self, raw_client_grad_list: List[Tuple[float, StateDict]]
                    ) -> List[Tuple[float, StateDict]]:
        """Called from on_before_aggregation whenever DP is on: feeds the
        round's statistics to the frame, accounts one LDP composition a
        round (JAX ``:123-135``), then clips if configured."""
        self.frame.set_params_for_dp(raw_client_grad_list)
        if isinstance(self.frame, LocalDP):
            # LDP clips on the client before noising: re-clipping the noised
            # models here would rescale signal and noise together
            self._account_step()
            return raw_client_grad_list
        return self.frame.global_clip(raw_client_grad_list)

    # --- accounting ----------------------------------------------------------
    def _account_step(self) -> None:
        sigma = self.frame.get_rdp_scale() if self.frame is not None else None
        if self.accountant is not None and sigma:
            self.accountant.step(noise_multiplier=sigma, sample_rate=self.sample_rate)

    def get_epsilon(self, delta: float = 1e-5) -> float:
        return self.accountant.get_epsilon(delta) if self.accountant else float("inf")
