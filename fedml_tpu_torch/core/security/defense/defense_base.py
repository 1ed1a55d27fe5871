"""Base class for defenses: counterpart of
``fedml_tpu/core/security/defense/defense_base.py`` (reference
core/security/defense/defense_base.py).

A defense may act at three points, the server's hooks:
``defend_before_aggregation`` screens or re-weights the client list,
``defend_on_aggregation`` replaces the aggregation rule,
``defend_after_aggregation`` post-processes the global model. The tensor
work runs on the state dicts' device, most of it over the cohort stacked
into one ``[K, D]`` matrix.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

StateDict = Dict[str, torch.Tensor]
GradList = List[Tuple[float, StateDict]]


class BaseDefenseMethod:
    def __init__(self, config: Any):
        self.config = config

    def defend_before_aggregation(self, raw_client_grad_list: GradList,
                                  extra_auxiliary_info: Any = None) -> GradList:
        return raw_client_grad_list

    def defend_on_aggregation(self, raw_client_grad_list: GradList,
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> StateDict:
        return base_aggregation_func(self.config, raw_client_grad_list)

    def defend_after_aggregation(self, global_model: StateDict) -> StateDict:
        return global_model
