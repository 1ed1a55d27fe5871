"""Topology managers for decentralized FL: a copy of
``fedml_tpu/core/distributed/topology``."""

from .base_topology_manager import BaseTopologyManager, ring_lattice
from .symmetric_topology_manager import SymmetricTopologyManager
from .asymmetric_topology_manager import AsymmetricTopologyManager

__all__ = [
    "BaseTopologyManager",
    "ring_lattice",
    "SymmetricTopologyManager",
    "AsymmetricTopologyManager",
]
