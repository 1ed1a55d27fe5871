"""Non-IID (Dirichlet) and homogeneous data partitioning.

A copy of ``fedml_tpu/core/data/noniid_partition.py`` (numpy only): the same
seeds give the same shards bit for bit. Reference:
``python/fedml/core/data/noniid_partition.py`` —
``partition_class_samples_with_dirichlet_distribution`` et al. Semantics
match: per-class Dirichlet(alpha) proportions across clients, with the
balancing trick that caps a client once it reaches the average share.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def partition_class_samples_with_dirichlet_distribution(
    N: int, alpha: float, client_num: int, idx_batch: List[List[int]], idx_k: np.ndarray, rng: np.random.Generator
):
    """One class's indices distributed over clients by Dirichlet(alpha).

    Mirrors reference behavior: proportions are zeroed for clients already
    holding >= N/client_num samples, renormalized, then split.
    """
    rng.shuffle(idx_k)
    proportions = rng.dirichlet(np.repeat(alpha, client_num))
    proportions = np.array(
        [p * (len(idx_j) < N / client_num) for p, idx_j in zip(proportions, idx_batch)]
    )
    proportions = proportions / proportions.sum()
    proportions = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
    idx_batch = [idx_j + idx.tolist() for idx_j, idx in zip(idx_batch, np.split(idx_k, proportions))]
    min_size = min(len(idx_j) for idx_j in idx_batch)
    return idx_batch, min_size


def non_iid_partition_with_dirichlet_distribution(
    label_list: np.ndarray,
    client_num: int,
    classes: int,
    alpha: float,
    seed: int = 0,
    min_require_size: int = 1,
) -> Dict[int, np.ndarray]:
    """Full hetero partition (reference: noniid_partition.py main entry)."""
    rng = np.random.default_rng(seed)
    N = label_list.shape[0]
    min_size = 0
    idx_batch: List[List[int]] = [[] for _ in range(client_num)]
    while min_size < min_require_size:
        idx_batch = [[] for _ in range(client_num)]
        for k in range(classes):
            idx_k = np.where(label_list == k)[0]
            idx_batch, min_size = partition_class_samples_with_dirichlet_distribution(
                N, alpha, client_num, idx_batch, idx_k, rng
            )
    net_dataidx_map = {}
    for i in range(client_num):
        rng.shuffle(idx_batch[i])
        net_dataidx_map[i] = np.asarray(idx_batch[i], dtype=np.int64)
    return net_dataidx_map


def homo_partition(n_samples: int, client_num: int, seed: int = 0) -> Dict[int, np.ndarray]:
    """IID partition: shuffled equal split (reference: partition_method
    "homo")."""
    rng = np.random.default_rng(seed)
    idxs = rng.permutation(n_samples)
    return {i: np.sort(part).astype(np.int64) for i, part in enumerate(np.array_split(idxs, client_num))}


def record_data_stats(label_list: np.ndarray, net_dataidx_map: Dict[int, np.ndarray], classes: int):
    """Per-client class histogram (reference: record_data_stats)."""
    return {
        cid: np.bincount(label_list[idxs].astype(int), minlength=classes).tolist()
        for cid, idxs in net_dataidx_map.items()
    }
