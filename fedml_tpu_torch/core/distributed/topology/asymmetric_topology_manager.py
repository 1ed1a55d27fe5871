"""Asymmetric (directed) topology: undirected base ring plus random one-way
links.

A copy of ``fedml_tpu/core/distributed/topology/asymmetric_topology_manager.py`` (numpy only).

Reference: core/distributed/topology/asymmetric_topology_manager.py:7-90 —
start from ring ∪ k-lattice, then flip a coin for each absent edge (i, j),
adding it one-way only if (j, i) was not already added. Rows are then
normalized (out-weights); columns are NOT stochastic, which is the point of
the asymmetric variant. Seeded rng here for reproducible experiments (the
reference uses the global numpy state).
"""

from __future__ import annotations

import numpy as np

from .base_topology_manager import BaseTopologyManager, ring_lattice


class AsymmetricTopologyManager(BaseTopologyManager):
    def __init__(self, n: int, undirected_neighbor_num: int = 3, out_directed_neighbor: int = 3, seed: int = 0):
        self.n = n
        self.undirected_neighbor_num = undirected_neighbor_num
        self.out_directed_neighbor = out_directed_neighbor
        self.seed = seed
        self.topology = np.zeros((n, n), dtype=np.float32)

    def generate_topology(self) -> None:
        n = self.n
        rng = np.random.default_rng(self.seed)
        adj = np.maximum(ring_lattice(n, 2), ring_lattice(n, self.undirected_neighbor_num))
        np.fill_diagonal(adj, 1)

        directed_added = set()
        for i in range(n):
            zeros = np.nonzero(adj[i] == 0)[0]
            if len(zeros) == 0:
                continue
            k = min(self.out_directed_neighbor, len(zeros))
            for j in rng.choice(zeros, size=k, replace=False):
                if (int(j), i) not in directed_added:
                    adj[i, int(j)] = 1
                    directed_added.add((i, int(j)))

        self.topology = adj / adj.sum(axis=1, keepdims=True)
