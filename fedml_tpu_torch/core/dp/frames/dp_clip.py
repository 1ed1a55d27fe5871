"""DP-FedAvg clip frame: counterpart of ``fedml_tpu/core/dp/frames/dp_clip.py``
(reference python/fedml/core/dp/frames/dp_clip.py ``DP_Clip``; McMahan et
al., ICLR 2018):

- the client L2-clips its update ``w_local - w_global`` to ``clipping_norm``
  and sends ``w_global + clipped``, still a model, so the server's weighted
  average stays the protocol's;
- the server averages, then adds Gaussian noise of std
  ``clipping_norm * noise_multiplier / qW``, qW the round's sum of weights
  (JAX ``dp_clip.py:46-58``). On the vmapped front the weights are
  normalised fractions, so qW is 1 there.
"""

from __future__ import annotations

import logging
from typing import Any

import torch

from ....utils.pytree import StateDict, tree_add, tree_clip_by_global_norm, tree_sub
from ..mechanisms.gaussian import add_gaussian_noise
from .base_dp_frame import BaseDPFrame, GradList


class DPClip(BaseDPFrame):
    def __init__(self, args: Any):
        super().__init__(args)
        self.clipping_norm = float(getattr(args, "clipping_norm", 1.0) or 1.0)
        self.noise_multiplier = float(getattr(args, "noise_multiplier", 1.0))
        self.train_data_num_in_total = int(getattr(args, "train_data_num_in_total", 0))
        self.client_num_per_round = int(getattr(args, "client_num_per_round", 1))
        self.client_num_in_total = int(getattr(args, "client_num_in_total", 1))
        self._qw_round = None  # the round's sum of sample weights
        self._warned_no_anchor = False

    def set_params_for_dp(self, raw_client_grad_list: GradList) -> None:
        """qW from the round's own weights, which sum to q*W in expectation
        (``train_data_num_in_total`` is only a fallback)."""
        if raw_client_grad_list:
            self._qw_round = float(sum(n for n, _ in raw_client_grad_list))

    def _qw(self) -> float:
        if self._qw_round:
            return max(1.0, self._qw_round)
        q = self.client_num_per_round / max(1, self.client_num_in_total)
        return max(1.0, self.train_data_num_in_total * q)

    def get_rdp_scale(self) -> float:
        return self.noise_multiplier

    def sigma(self) -> float:
        """The std of the server's noise this round."""
        return self.clipping_norm * self.noise_multiplier / self._qw()

    def add_local_noise(self, local_grad: StateDict, gen: torch.Generator,
                        extra_auxiliary_info: Any = None) -> StateDict:
        """Clip the local update around the round's global model
        (``extra_auxiliary_info['global_model_params']``); without that
        anchor there is no delta to clip and the model passes through."""
        anchor = extra_auxiliary_info
        if isinstance(extra_auxiliary_info, dict):
            anchor = extra_auxiliary_info.get("global_model_params")
        if anchor is None:
            if not self._warned_no_anchor:
                logging.warning("DPClip: no global-model anchor provided; skipping delta clip")
                self._warned_no_anchor = True
            return local_grad
        delta = tree_clip_by_global_norm(tree_sub(local_grad, anchor), self.clipping_norm)
        return tree_add(anchor, delta)

    def add_global_noise(self, global_model: StateDict, gen: torch.Generator) -> StateDict:
        return add_gaussian_noise(global_model, gen, self.sigma())
