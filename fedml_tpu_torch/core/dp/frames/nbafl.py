"""NbAFL frame, noising before aggregation: counterpart of
``fedml_tpu/core/dp/frames/nbafl.py`` (reference
python/fedml/core/dp/frames/NbAFL.py; Wei et al. 2020).

Clients clip each coordinate to ``C`` (w / max(1, |w|/C)) and add Gaussian
noise of sigma_u = 2cC/(m eps); the server adds downlink noise only when the
round count T exceeds sqrt(N) L, with sigma_d = 2cC sqrt(T^2 - L^2 N) /
(m N eps) (L clients a round, N in total, m the local dataset size: the
client's own, the round's smallest on the server).

The JAX package's two departures from the reference are kept: the downlink
noise is added (the reference replaces the model with it), and sigma_u is
calibrated as above (the reference's ignores C and m). On the vmapped front
the weights are normalised fractions, so the server's m is ``int(min)`` = 0,
clamped to 1.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ....utils.pytree import StateDict
from ..mechanisms.gaussian import add_gaussian_noise
from .base_dp_frame import BaseDPFrame, GradList


class NbAFLDP(BaseDPFrame):
    def __init__(self, args: Any):
        super().__init__(args)
        self.epsilon = float(getattr(args, "epsilon", 1.0))
        self.delta = float(getattr(args, "delta", 1e-5))
        self.big_c = float(getattr(args, "nbafl_C", getattr(args, "clipping_norm", 1.0) or 1.0))
        self.total_round_num = int(getattr(args, "comm_round", 1))
        self.small_c = math.sqrt(2.0 * math.log(1.25 / self.delta))
        self.client_num_per_round = int(getattr(args, "client_num_per_round", 1))
        self.client_num_in_total = int(getattr(args, "client_num_in_total", 1))
        self.m = 1  # the round's smallest local dataset; set_params_for_dp

    def set_params_for_dp(self, raw_client_grad_list: GradList) -> None:
        if raw_client_grad_list:
            self.m = max(1, int(min(n for n, _ in raw_client_grad_list)))

    def _sigma_u(self, m: int) -> float:
        return 2.0 * self.small_c * self.big_c / (max(1, m) * self.epsilon)

    def get_rdp_scale(self) -> float:
        return self._sigma_u(self.m)

    def sigma_d(self) -> float:
        """The downlink noise's std (0 while T <= sqrt(N) L)."""
        t, l, n = self.total_round_num, self.client_num_per_round, self.client_num_in_total
        if t <= math.sqrt(n) * l:
            return 0.0
        return (2.0 * self.small_c * self.big_c * math.sqrt(max(t ** 2 - l ** 2 * n, 0))
                / (self.m * n * self.epsilon))

    def add_local_noise(self, local_grad: StateDict, gen: torch.Generator,
                        extra_auxiliary_info: Any = None) -> StateDict:
        m = self.m
        if isinstance(extra_auxiliary_info, dict) and extra_auxiliary_info.get("local_sample_num"):
            m = int(extra_auxiliary_info["local_sample_num"])
        c = self.big_c
        clipped = {k: w / torch.clamp(w.abs() / c, min=1.0) for k, w in local_grad.items()}
        return add_gaussian_noise(clipped, gen, self._sigma_u(m))

    def add_global_noise(self, global_model: StateDict, gen: torch.Generator) -> StateDict:
        sigma_d = self.sigma_d()
        if sigma_d == 0.0:
            return global_model
        return add_gaussian_noise(global_model, gen, sigma_d)
