"""YAML-config -> Arguments object: a copy of ``fedml_tpu/arguments.py``.

A single YAML file with sections (``common_args``, ``data_args``,
``model_args``, ``train_args``, ...) is flattened into one attribute
namespace, with CLI overrides (``--cf``, ``--rank``, ``--role``), so a
config written for the JAX package drives the port unchanged. PyYAML is
imported only when a YAML file is read.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

from .constants import FEDML_TRAINING_PLATFORM_CROSS_SILO, FEDML_TRAINING_PLATFORM_SIMULATION


def add_args(parser: Optional[argparse.ArgumentParser] = None) -> argparse.ArgumentParser:
    """CLI arg surface (reference: arguments.py:36-72)."""
    parser = parser or argparse.ArgumentParser(description="fedml_tpu_torch")
    parser.add_argument("--yaml_config_file", "--cf", help="yaml configuration file", type=str, default="")
    parser.add_argument("--run_id", type=str, default="0")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--role", type=str, default="client")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--node_rank", type=int, default=0)
    return parser


class Arguments:
    """Flat attribute namespace over the merged YAML sections.

    Reference: ``Arguments`` at ``python/fedml/arguments.py:75`` — same
    flattening behavior (every key of every ``*_args`` section becomes a
    top-level attribute).
    """

    def __init__(
        self,
        cmd_args: Optional[argparse.Namespace] = None,
        training_type: Optional[str] = None,
        comm_backend: Optional[str] = None,
        override: Optional[Dict[str, Any]] = None,
    ):
        if cmd_args is not None:
            for k, v in vars(cmd_args).items():
                setattr(self, k, v)
        self.training_type = training_type or getattr(self, "training_type", None)
        self.backend = comm_backend or getattr(self, "backend", None)
        cfg_path = getattr(self, "yaml_config_file", "") or ""
        if cfg_path:
            self.load_yaml_config(cfg_path)
        if override:
            for k, v in override.items():
                setattr(self, k, v)

    # -- yaml handling ----------------------------------------------------
    def load_yaml_config(self, yaml_path: str) -> None:
        import yaml

        with open(yaml_path, "r") as f:
            configuration = yaml.safe_load(f) or {}
        self.set_attr_from_config(configuration)
        self.yaml_paths = [yaml_path]

    def set_attr_from_config(self, configuration: Dict[str, Any]) -> None:
        for _section, content in configuration.items():
            if isinstance(content, dict):
                for key, val in content.items():
                    setattr(self, key, val)
            else:
                setattr(self, _section, content)

    # -- dict-like convenience -------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Arguments({vars(self)!r})"


def load_arguments(
    training_type: Optional[str] = None,
    comm_backend: Optional[str] = None,
    args: Optional[argparse.Namespace] = None,
    override: Optional[Dict[str, Any]] = None,
) -> Arguments:
    """Parse CLI + YAML into an :class:`Arguments` (reference: arguments.py bottom)."""
    if args is None:
        parser = add_args()
        args, _unknown = parser.parse_known_args()
    out = Arguments(args, training_type=training_type, comm_backend=comm_backend, override=override)

    # Per-silo config override (reference: __init__.py:187-211 data_silo_config)
    if hasattr(out, "data_silo_config") and out.training_type == FEDML_TRAINING_PLATFORM_CROSS_SILO:
        rank = int(getattr(out, "rank", 0))
        if 1 <= rank <= len(out.data_silo_config):
            silo_cfg = out.data_silo_config[rank - 1]
            if isinstance(silo_cfg, str) and os.path.exists(silo_cfg):
                out.load_yaml_config(silo_cfg)
    return out


def default_config(training_type: str = FEDML_TRAINING_PLATFORM_SIMULATION, **over: Any) -> Arguments:
    """A runnable in-code default config (reference ships these as
    ``python/fedml/config/simulation_sp/fedml_config.yaml``; here they are
    code so tests need no files). Mirrors
    ``examples/federate/quick_start/parrot/fedml_config.yaml``."""
    ns = argparse.Namespace(run_id="0", rank=0, role="client", local_rank=0, node_rank=0, yaml_config_file="")
    base: Dict[str, Any] = dict(
        training_type=training_type,
        random_seed=0,
        scenario="horizontal",
        using_mlops=False,
        dataset="mnist",
        data_cache_dir=os.path.expanduser("~/fedml_data"),
        partition_method="hetero",
        partition_alpha=0.5,
        model="lr",
        federated_optimizer="FedAvg",
        client_id_list="[]",
        client_num_in_total=10,
        client_num_per_round=4,
        comm_round=5,
        epochs=1,
        batch_size=32,
        client_optimizer="sgd",
        learning_rate=0.03,
        weight_decay=0.001,
        frequency_of_the_test=5,
        using_gpu=True,
        gpu_id=0,
        backend="sp",
        enable_wandb=False,
    )
    base.update(over)
    return Arguments(ns, training_type=training_type, override=base)
