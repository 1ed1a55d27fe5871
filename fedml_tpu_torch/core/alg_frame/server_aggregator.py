"""Abstract server aggregator with the defense, DP and contribution hooks:
counterpart of ``fedml_tpu/core/alg_frame/server_aggregator.py`` (reference
``python/fedml/core/alg_frame/server_aggregator.py:14``).

Hook order as in the JAX package (``:41-124``): ``on_before_aggregation``
(model attack, defense screening, the DP frame's clip), ``aggregate``
(defense-wrapped), ``on_after_aggregation`` (FHE decryption when a client
encrypted, central DP noise, the defense's post-processing), then
``assess_contribution``. With no middleware on they pass the client list
and the folded model through unchanged.

Contribution assessment departs from the JAX package (ROADMAP.md, Queue 3,
R9): JAX's metric ignores the subset model it is given, its test returns a
dict the valuations cannot subtract, and on the sp front it finds the
round's client list only when a model attack put it there. Here
``on_before_aggregation`` records the screened list whenever contribution
is on, and the metric is ``test_acc`` of the subset model.
"""

from __future__ import annotations

import abc
import logging
from typing import Any, List, Tuple

from .context import Context


class ServerAggregator(abc.ABC):
    """Aggregates client updates; subclasses implement test()."""

    def __init__(self, model: Any, args: Any):
        self.model = model
        self.id = 0
        self.args = args
        self.enable_hooks = not getattr(args, "disable_alg_frame_hooks", False)

    def set_id(self, aggregator_id: int) -> None:
        self.id = aggregator_id

    @abc.abstractmethod
    def get_model_params(self):
        ...

    @abc.abstractmethod
    def set_model_params(self, model_parameters) -> None:
        ...

    # --- hooks (reference server_aggregator.py:44-134) ----------------------
    def on_before_aggregation(
        self, raw_client_model_or_grad_list: List[Tuple[float, Any]]
    ) -> List[Tuple[float, Any]]:
        if not self.enable_hooks:
            return raw_client_model_or_grad_list
        from ..dp.fedml_differential_privacy import FedMLDifferentialPrivacy
        from ..security.fedml_attacker import FedMLAttacker
        from ..security.fedml_defender import FedMLDefender

        lst = raw_client_model_or_grad_list
        attacker = FedMLAttacker.get_instance()
        if attacker.is_model_attack():
            lst = attacker.attack_model(lst, extra_auxiliary_info=self.get_model_params())
            Context().add(Context.KEY_CLIENT_MODEL_LIST, lst)
        defender = FedMLDefender.get_instance()
        if defender.is_defense_enabled():
            lst = defender.defend_before_aggregation(lst,
                                                     extra_auxiliary_info=self.get_model_params())
        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_dp_enabled():
            # always through the frame: it feeds the round's statistics
            # (NbAFL's m, DPClip's qW), steps the LDP accountant, and clips
            # only if a norm is configured
            lst = dp.global_clip(lst)
        if getattr(self.args, "enable_contribution", False):
            Context().add(Context.KEY_CLIENT_MODEL_LIST, lst)
        return lst

    def aggregate(self, raw_client_model_or_grad_list: List[Tuple[float, Any]]):
        """Defense-wrapped aggregation (reference :75-88)."""
        from ..aggregation.agg_operator import FedMLAggOperator

        if self.enable_hooks:
            from ..security.fedml_defender import FedMLDefender

            defender = FedMLDefender.get_instance()
            if defender.is_defense_enabled():
                return defender.defend_on_aggregation(
                    raw_client_model_or_grad_list,
                    base_aggregation_func=FedMLAggOperator.agg,
                    extra_auxiliary_info=self.get_model_params())
        return FedMLAggOperator.agg(self.args, raw_client_model_or_grad_list)

    def on_after_aggregation(self, aggregated_model_or_grad: Any) -> Any:
        if not self.enable_hooks:
            return aggregated_model_or_grad
        from ..dp.fedml_differential_privacy import FedMLDifferentialPrivacy
        from ..fhe.fhe_agg import FedMLFHE
        from ..security.fedml_defender import FedMLDefender

        fhe = FedMLFHE.get_instance()
        if fhe.is_fhe_enabled() and Context().get("fhe_encrypted"):
            aggregated_model_or_grad = fhe.fhe_dec("global", aggregated_model_or_grad)
        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_central_dp_enabled():
            logging.info("-----add central DP noise ----")
            aggregated_model_or_grad = dp.add_global_noise(aggregated_model_or_grad)
        defender = FedMLDefender.get_instance()
        if defender.is_defense_enabled():
            aggregated_model_or_grad = defender.defend_after_aggregation(aggregated_model_or_grad)
        return aggregated_model_or_grad

    def contribution_metric(self, params) -> float:
        """``test_acc`` of ``params`` on the test data in Context; the
        aggregator's own model is put back afterwards."""
        saved = self.get_model_params()
        self.set_model_params(params)
        try:
            metrics = self.test(Context().get(Context.KEY_TEST_DATA), None, self.args)
        finally:
            self.set_model_params(saved)
        return float(metrics["test_acc"]) if isinstance(metrics, dict) else float(metrics)

    def assess_contribution(self) -> None:
        """Reference :105-134: Shapley or LOO valuation after the fold."""
        if not self.enable_hooks:
            return
        from ..contribution.contribution_assessor_manager import ContributionAssessorManager

        # one manager for the aggregator's lifetime: the multi-round
        # accumulation needs the history
        manager = getattr(self, "_contribution_manager", None)
        if manager is None:
            manager = self._contribution_manager = ContributionAssessorManager(self.args)
        if not manager.is_enabled():
            return
        model_list = Context().get(Context.KEY_CLIENT_MODEL_LIST)
        if model_list is None:
            return
        manager.run(model_list, self.get_model_params(), metric_fn=self.contribution_metric)

    @abc.abstractmethod
    def test(self, test_data, device, args):
        ...

    def test_all(self, train_data_local_dict, test_data_local_dict, device, args) -> bool:
        return True
