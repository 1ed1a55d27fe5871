"""Symmetric (undirected) ring-plus-links topology.

A copy of ``fedml_tpu/core/distributed/topology/symmetric_topology_manager.py`` (numpy only).

Reference: core/distributed/topology/symmetric_topology_manager.py:7-57 —
ring ∪ k-nearest ring lattice, self-loops, rows normalized to a doubly
substochastic mixing matrix. Built here with direct index arithmetic instead
of networkx.
"""

from __future__ import annotations

import numpy as np

from .base_topology_manager import BaseTopologyManager, ring_lattice


class SymmetricTopologyManager(BaseTopologyManager):
    def __init__(self, n: int, neighbor_num: int = 2):
        self.n = n
        self.neighbor_num = neighbor_num
        self.topology = np.zeros((n, n), dtype=np.float32)

    def generate_topology(self) -> None:
        n = self.n
        adj = np.maximum(ring_lattice(n, 2), ring_lattice(n, self.neighbor_num))
        np.fill_diagonal(adj, 1)
        self.topology = adj / adj.sum(axis=1, keepdims=True)
