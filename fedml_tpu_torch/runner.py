"""Runner dispatch: counterpart of ``fedml_tpu/runner.py`` (reference
``python/fedml/runner.py:19``). The port runs the ``sp``, ``vmap``,
``NCCL`` and ``MPI`` simulations and the cross-silo front (``training_type:
cross_silo``, dispatched by ``role``), with its round-barrier
secure-aggregation fronts (``secure_aggregation``: SecAgg and LightSecAgg,
over INMEMORY); cross-cloud, cross-device and placement plans raise
NotImplementedError (ROADMAP.md, Queue 1)."""

from __future__ import annotations

from typing import Any, Optional

from .constants import (COMM_BACKEND_INMEMORY, FEDML_SIMULATION_TYPE_MPI, FEDML_SIMULATION_TYPE_NCCL,
                        FEDML_SIMULATION_TYPE_SP, FEDML_SIMULATION_TYPE_VMAP,
                        FEDML_TRAINING_PLATFORM_CROSS_SILO, FEDML_TRAINING_PLATFORM_SIMULATION)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to fedml_tpu_torch yet; the port runs the sp and vmap "
        "NCCL and MPI simulations and cross-silo FedAvg (see ROADMAP.md, Queue 1)")


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
        if args.training_type == FEDML_TRAINING_PLATFORM_SIMULATION:
            self.runner = self._init_simulation_runner(
                args, device, dataset, model, client_trainer, server_aggregator)
        elif args.training_type == FEDML_TRAINING_PLATFORM_CROSS_SILO:
            self.runner = self._init_cross_silo_runner(
                args, device, dataset, model, client_trainer, server_aggregator)
        else:
            raise _not_ported(f"training_type {args.training_type!r}")

    @staticmethod
    def _init_simulation_runner(args, device, dataset, model, client_trainer, server_aggregator):
        backend = getattr(args, "backend", FEDML_SIMULATION_TYPE_SP)
        if backend == FEDML_SIMULATION_TYPE_SP:
            from .simulation.simulator import SimulatorSingleProcess as Simulator
        elif backend == FEDML_SIMULATION_TYPE_VMAP:
            from .simulation.simulator import SimulatorVmap as Simulator
        elif backend == FEDML_SIMULATION_TYPE_NCCL:
            # the cohort in client groups over the devices; the groups' partial
            # sums reduced onto the first (the reference's broadcast + reduce)
            from .simulation.simulator import SimulatorCollective as Simulator
        elif backend == FEDML_SIMULATION_TYPE_MPI:
            from .simulation.simulator import SimulatorMPI as Simulator
        else:
            raise _not_ported(f"simulation backend {backend!r}")
        return Simulator(args, device, dataset, model, client_trainer, server_aggregator)

    @staticmethod
    def _init_cross_silo_runner(args, device, dataset, model, client_trainer, server_aggregator):
        from .core.fhe.fhe_agg import refuse_fhe_front

        role = getattr(args, "role", "client")
        refuse_fhe_front(args, "cross_silo", str(getattr(args, "backend", COMM_BACKEND_INMEMORY)))
        secure = str(getattr(args, "secure_aggregation", "") or "").lower()
        if secure in ("lightsecagg", "lsa", "secagg", "sa"):
            backend = str(getattr(args, "backend", COMM_BACKEND_INMEMORY))
            if backend != COMM_BACKEND_INMEMORY:
                # the secure managers put numpy shares in the control message,
                # which the JSON of a byte backend cannot carry, in JAX too
                raise NotImplementedError(
                    f"secure_aggregation {secure!r} over backend {backend!r}: the SecAgg and "
                    f"LightSecAgg fronts run over {COMM_BACKEND_INMEMORY} only (see ROADMAP.md, "
                    "Queue 3, R4)")
            if secure in ("lightsecagg", "lsa"):
                # reference: cross_silo/lightsecagg/lsa_fedml_api.py FedML_LSA_Horizontal
                from .cross_silo import lightsecagg as front
            else:
                # reference: cross_silo/secagg/sa_fedml_api.py FedML_SA_Horizontal
                from .cross_silo import secagg as front
            if role == "client":
                return front.Client(args, device, dataset, model, model_trainer=client_trainer)
            return front.Server(args, device, dataset, model, server_aggregator=server_aggregator)
        if role == "client":
            from .cross_silo.fedml_client import FedMLCrossSiloClient

            return FedMLCrossSiloClient(args, device, dataset, model, client_trainer)
        if role == "server":
            from .cross_silo.fedml_server import FedMLCrossSiloServer

            return FedMLCrossSiloServer(args, device, dataset, model, server_aggregator)
        raise ValueError(f"unknown role {role!r}")

    def run(self):
        return self.runner.run()
