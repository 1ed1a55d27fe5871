"""Runner dispatch: counterpart of ``fedml_tpu/runner.py`` (reference
``python/fedml/runner.py:19``). The port runs the ``sp`` and ``vmap``
simulations; the other simulation backends (NCCL, MPI), cross-silo,
cross-cloud, cross-device and placement plans raise NotImplementedError
(ROADMAP.md, Queue 1)."""

from __future__ import annotations

from typing import Any, Optional

from .constants import (FEDML_SIMULATION_TYPE_SP, FEDML_SIMULATION_TYPE_VMAP,
                        FEDML_TRAINING_PLATFORM_SIMULATION)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to fedml_tpu_torch yet; the port runs the sp "
        "and vmap simulations (see ROADMAP.md, Queue 1)")


class FedMLRunner:
    def __init__(
        self,
        args: Any,
        device: Any,
        dataset,
        model,
        client_trainer: Optional[Any] = None,
        server_aggregator: Optional[Any] = None,
    ):
        self.args = args
        if getattr(args, "placement", None):
            raise _not_ported("placement")
        if args.training_type != FEDML_TRAINING_PLATFORM_SIMULATION:
            raise _not_ported(f"training_type {args.training_type!r}")
        backend = getattr(args, "backend", FEDML_SIMULATION_TYPE_SP)
        if backend == FEDML_SIMULATION_TYPE_SP:
            from .simulation.simulator import SimulatorSingleProcess as Simulator
        elif backend == FEDML_SIMULATION_TYPE_VMAP:
            from .simulation.simulator import SimulatorVmap as Simulator
        else:
            raise _not_ported(f"simulation backend {backend!r}")
        self.runner = Simulator(args, device, dataset, model, client_trainer, server_aggregator)

    def run(self):
        return self.runner.run()
