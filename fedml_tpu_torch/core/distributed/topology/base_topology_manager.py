"""Topology manager protocol for decentralized FL.

A copy of ``fedml_tpu/core/distributed/topology/base_topology_manager.py`` (numpy only).

Reference: core/distributed/topology/base_topology_manager.py:4-23. The
topology is an n x n row-stochastic mixing matrix W; W[i, j] != 0 means j is
an out-neighbor of i. Decentralized algorithms consume neighbor index lists
(who to message) and weights (how to mix received models).
"""

from __future__ import annotations

import abc
from typing import List

import numpy as np


class BaseTopologyManager(abc.ABC):
    n: int
    topology: np.ndarray

    @abc.abstractmethod
    def generate_topology(self) -> None: ...

    def get_in_neighbor_idx_list(self, node_index: int) -> List[int]:
        """Nodes that send to ``node_index`` (nonzero column entries)."""
        col = self.topology[:, node_index]
        return [int(i) for i in np.nonzero(col)[0] if i != node_index]

    def get_out_neighbor_idx_list(self, node_index: int) -> List[int]:
        """Nodes that ``node_index`` sends to (nonzero row entries)."""
        row = self.topology[node_index]
        return [int(j) for j in np.nonzero(row)[0] if j != node_index]

    def get_in_neighbor_weights(self, node_index: int) -> List[float]:
        if node_index >= self.n:
            return []
        return [float(w) for w in self.topology[:, node_index]]

    def get_out_neighbor_weights(self, node_index: int) -> List[float]:
        if node_index >= self.n:
            return []
        return [float(w) for w in self.topology[node_index]]

    def mixing_matrix(self) -> np.ndarray:
        """The full W, for gossip steps (x' = W @ x: the decentralized
        simulator mixes all nodes in one matmul instead of per-node Python
        loops)."""
        return np.asarray(self.topology, dtype=np.float32)


def ring_lattice(n: int, k: int) -> np.ndarray:
    """0/1 adjacency of a regular ring lattice: each node linked to its k//2
    nearest neighbors on each side (the Watts-Strogatz graph at rewiring
    probability 0, which is all the reference uses networkx for)."""
    a = np.zeros((n, n), dtype=np.float32)
    half = max(1, k // 2)
    for off in range(1, half + 1):
        idx = np.arange(n)
        a[idx, (idx + off) % n] = 1
        a[idx, (idx - off) % n] = 1
    return a
