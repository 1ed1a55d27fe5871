"""Abstract server aggregator: counterpart of
``fedml_tpu/core/alg_frame/server_aggregator.py`` (reference
``python/fedml/core/alg_frame/server_aggregator.py:14``).

The hooks keep their place around the fold (``on_before_aggregation``,
``aggregate``, ``on_after_aggregation``, then ``assess_contribution``), but
the middleware they call (model attacks, defenses, DP, FHE, contribution
assessment) is not ported yet: enabling any of it raises
NotImplementedError (ROADMAP.md, Queue 1). With none enabled the hooks pass
the client list and the folded model through unchanged, as the JAX
package's do.
"""

from __future__ import annotations

import abc
from typing import Any, List, Tuple

_HOOK_FLAGS = ("enable_attack", "enable_defense", "enable_dp", "enable_fhe",
               "enable_contribution")


def enabled_middleware(args: Any) -> List[str]:
    """The middleware flags ``args`` turns on."""
    return [f for f in _HOOK_FLAGS if getattr(args, f, False)]


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

    def _check_hooks(self) -> None:
        on = enabled_middleware(self.args) if self.enable_hooks else []
        if on:
            raise NotImplementedError(
                f"{', '.join(on)}: the server's attack, defense, DP, FHE and contribution "
                "hooks are not ported to fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")

    def on_before_aggregation(
        self, raw_client_model_or_grad_list: List[Tuple[float, Any]]
    ) -> List[Tuple[float, Any]]:
        self._check_hooks()
        return raw_client_model_or_grad_list

    def aggregate(self, raw_client_model_or_grad_list: List[Tuple[float, Any]]):
        from ..aggregation.agg_operator import FedMLAggOperator

        self._check_hooks()
        return FedMLAggOperator.agg(self.args, raw_client_model_or_grad_list)

    def on_after_aggregation(self, aggregated_model_or_grad: Any) -> Any:
        self._check_hooks()
        return aggregated_model_or_grad

    def assess_contribution(self) -> None:
        self._check_hooks()

    @abc.abstractmethod
    def test(self, test_data, device, args):
        ...

    def test_all(self, train_data_local_dict, test_data_local_dict, device, args) -> bool:
        return True
