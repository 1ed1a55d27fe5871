"""fedml_tpu_torch: the PyTorch/CUDA port of the fedml_tpu package.

Module paths mirror the JAX package (``fedml_tpu``), which stays the
reference each slice of the port is held against. This package imports
``torch`` and never ``jax`` or ``fedml_tpu``. Importing it builds nothing:
the CUDA kernels under ``ops/csrc`` are compiled at their first launch.

Entry points take ``device=`` and default to ``"cuda"``; without CUDA they
raise unless the caller asks for ``"cpu"``. The public surface is the JAX
package's for the sp FedAvg simulation::

    import fedml_tpu_torch as fedml
    args = fedml.init(fedml.default_config("simulation", model="resnet56",
                                           dataset="cifar10"))
    dev = fedml.get_device(args)          # cuda:0; the CPU when using_gpu=False
    dataset, output_dim = fedml.data.load(args)
    model = fedml.model.create(args, output_dim)
    fedml.FedMLRunner(args, dev, dataset, model).run()

or the one-liner ``run_simulation(args=args)``; ``backend="vmap"`` runs the
client-batched simulator, and ``federated_optimizer`` picks FedAvg, FedProx,
FedOpt, FedNova, SCAFFOLD, FedDyn or Mime on the sp backend.

Cross-silo FedAvg runs one party per ``FedMLRunner``: a config with
``training_type="cross_silo"``, ``role`` "server" (rank 0) or "client"
(ranks 1..N) and ``backend`` "INMEMORY" (parties as threads of one process)
or a backend between processes: "MQTT_S3" (over the socket broker,
``mqtt_socket="host:port"``, with one shared ``object_store_dir``;
``mqtt_s3_wire="fedml"`` with a shared ``mqtt_s3_bucket_dir`` speaks the
reference's pickled wire), "MQTT_WEB3"/"MQTT_THETASTORE" (the same broker,
payloads in one shared content-addressed ``cas_root``), "TRPC" (raw TCP
frames from ``trpc_base_port``) or "GRPC"/"MPI" (from ``grpc_base_port``;
``grpc_wire="fedml"`` for the reference's wire; needs ``grpc``);
``run_cross_silo_server(args)`` and ``run_cross_silo_client(args)`` are the
one-liners. A silo of several processes (``scenario: hierarchical``, the
reference's intra-silo DDP) runs ``run_hierarchical_cross_silo_client`` in
each of its processes, launched with ``FEDML_COORDINATOR_ADDRESS``,
``FEDML_NUM_PROCESSES`` and ``FEDML_PROCESS_ID`` (or ``coordinator_address``,
``num_processes``, ``process_id``): rank 0 talks to the server, every rank
trains its share of each batch (``parallel/``). ``backend="MPI"`` and
``"NCCL"`` run the reference's other two simulators (``simulation/``).

``init`` configures the trust middleware from the config, as the JAX
package's does: DP (``enable_dp``), attacks (``enable_attack``), defenses
(``enable_defense``), contribution assessment (``enable_contribution``) and
homomorphic encryption (``enable_fhe`` with ``fhe_scheme: rlwe``, its ring
products on the card), run by the trainers' and aggregators' hooks on every
front that supports them.
"""

from __future__ import annotations

import logging
import os
import random
from typing import Any, Dict, Optional

import numpy as np

from . import constants, data
from .arguments import Arguments, default_config, load_arguments
from .constants import (FEDML_SIMULATION_TYPE_SP, FEDML_TRAINING_PLATFORM_CROSS_SILO,
                        FEDML_TRAINING_PLATFORM_SIMULATION)
from .device import get_device, resolve_device
from .runner import FedMLRunner

__version__ = "0.1.0"


class _ModelNS:
    @staticmethod
    def create(args, output_dim=None, seed=None, device=None):
        from .models.model_hub import create as _create

        return _create(args, output_dim, seed, device)


model = _ModelNS()


def _seed_everything(seed: int) -> None:
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))


def init(args: Optional[Any] = None, override: Optional[Dict[str, Any]] = None) -> Any:
    """Parse the config, set up logging, seed the RNGs (Python, numpy,
    torch) and configure the trust middleware's singletons (attacker,
    defender, DP, FHE) from ``args``, as the JAX package's ``init`` does
    (``__init__.py:88-96``); FHE's ring products run on ``get_device(args)``.
    First it joins this process to its silo's process group where the
    config or the environment names one (``parallel/multihost.py``
    ``init_distributed``; a no-op for one process). mlops is not ported:
    asking for it raises NotImplementedError (ROADMAP.md, Queue 1)."""
    from .core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from .core.fhe.fhe_agg import FedMLFHE
    from .core.security.fedml_attacker import FedMLAttacker
    from .core.security.fedml_defender import FedMLDefender

    if args is None:
        args = load_arguments(override=override)
    elif override:
        for k, v in override.items():
            setattr(args, k, v)
    if getattr(args, "using_mlops", False):
        raise NotImplementedError(
            "using_mlops: not ported to fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")
    from .parallel.multihost import init_distributed

    pid = getattr(args, "process_id", None)
    init_distributed(
        coordinator_address=getattr(args, "coordinator_address", None),
        num_processes=int(getattr(args, "num_processes", 0) or 0) or None,
        process_id=int(pid) if pid is not None else None,
        device=None if getattr(args, "using_gpu", True) else "cpu",
    )
    logging.basicConfig(
        level=logging.INFO,
        format="[fedml_tpu_torch] %(asctime)s %(levelname)s %(name)s: %(message)s")
    _seed_everything(int(getattr(args, "random_seed", 0)))
    FedMLAttacker.get_instance().init(args)
    FedMLDefender.get_instance().init(args)
    FedMLDifferentialPrivacy.get_instance().init(args)
    FedMLFHE.get_instance().init(
        args, device=get_device(args) if getattr(args, "enable_fhe", False) else "cpu")
    return args


def run_simulation(backend: str = FEDML_SIMULATION_TYPE_SP, args: Optional[Any] = None):
    """One-line simulation entry: init, device, data, model, runner."""
    args = args or default_config(FEDML_TRAINING_PLATFORM_SIMULATION, backend=backend)
    args.training_type = FEDML_TRAINING_PLATFORM_SIMULATION
    args.backend = backend
    args = init(args)
    dev = get_device(args)
    dataset, output_dim = data.load(args)
    mdl = model.create(args, output_dim, device=dev)
    return FedMLRunner(args, dev, dataset, mdl).run()


def _run_cross_silo(role: str, args: Optional[Any] = None):
    """One party of a cross-silo federation: init, device, data, model,
    runner; returns the server's final metrics (None for a client)."""
    args = args or load_arguments(training_type=FEDML_TRAINING_PLATFORM_CROSS_SILO)
    args.training_type = FEDML_TRAINING_PLATFORM_CROSS_SILO
    args.role = role
    args = init(args)
    dev = get_device(args)
    dataset, output_dim = data.load(args)
    mdl = model.create(args, output_dim, device=dev)
    return FedMLRunner(args, dev, dataset, mdl).run()


def run_cross_silo_server(args: Optional[Any] = None):
    """Reference: launch_cross_silo_horizontal.py."""
    return _run_cross_silo("server", args)


def run_cross_silo_client(args: Optional[Any] = None):
    return _run_cross_silo("client", args)


def run_hierarchical_cross_silo_server(args: Optional[Any] = None):
    """Reference: launch_cross_silo_hi.py — the same managers, the
    hierarchical scenario."""
    if args is not None:
        args.scenario = "hierarchical"
    return _run_cross_silo("server", args)


def run_hierarchical_cross_silo_client(args: Optional[Any] = None):
    """One process of a hierarchical silo (see the package docstring)."""
    if args is not None:
        args.scenario = "hierarchical"
    return _run_cross_silo("client", args)


__all__ = [
    "Arguments",
    "FedMLRunner",
    "__version__",
    "constants",
    "data",
    "default_config",
    "get_device",
    "init",
    "load_arguments",
    "model",
    "resolve_device",
    "run_cross_silo_client",
    "run_cross_silo_server",
    "run_hierarchical_cross_silo_client",
    "run_hierarchical_cross_silo_server",
    "run_simulation",
]
