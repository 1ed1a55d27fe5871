"""Federated dataset loading and partitioning: counterpart of
``fedml_tpu/data/data_loader.py`` (reference ``python/fedml/data/data_loader.py:234``).

Same return tuple as the JAX package:

    (train_data_num, test_data_num, train_data_global, test_data_global,
     train_data_local_num_dict, train_data_local_dict, test_data_local_dict,
     class_num)

with :class:`ArrayDataset` shards (numpy; the trainers move them to the
device). The synthetic (LEAF synthetic(a, b)) and image datasets are ported,
from their surrogates or a ``{cache}/{name}.npz``; the shards are
bit-identical to the JAX package's. Text, tabular and segmentation datasets,
native file formats and downloads raise NotImplementedError.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Tuple

import numpy as np

from ..core.data.noniid_partition import (
    homo_partition,
    non_iid_partition_with_dirichlet_distribution,
    record_data_stats,
)
from .dataset import ArrayDataset
from .sources import IMAGE_SPECS, load_image_dataset, load_synthetic_lr

log = logging.getLogger(__name__)

FedDataset = Tuple[int, int, ArrayDataset, ArrayDataset, Dict[int, int], Dict[int, ArrayDataset],
                   Dict[int, ArrayDataset], int]


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to fedml_tpu_torch yet; the port loads the synthetic and "
        f"image datasets ({', '.join(sorted(IMAGE_SPECS))}) (see ROADMAP.md, Queue 1)")


def load(args: Any) -> FedDataset:
    dataset = str(getattr(args, "dataset", "mnist")).lower()
    client_num = int(getattr(args, "client_num_in_total", 10))
    cache = getattr(args, "data_cache_dir", "")
    seed = int(getattr(args, "random_seed", 0))
    method = str(getattr(args, "partition_method", "hetero")).lower()
    alpha = float(getattr(args, "partition_alpha", 0.5))

    if dataset == "synthetic" or dataset.startswith("synthetic_"):
        a, b = (float(getattr(args, "synthetic_alpha", 1.0)), float(getattr(args, "synthetic_beta", 1.0)))
        shards, class_num = load_synthetic_lr(a, b, client_num, seed)
        train_local, test_local, train_num_dict = {}, {}, {}
        all_x, all_y = [], []
        for cid, (x, y) in enumerate(shards):
            n_test = max(1, len(x) // 10)
            train_local[cid] = ArrayDataset(x[n_test:], y[n_test:])
            test_local[cid] = ArrayDataset(x[:n_test], y[:n_test])
            train_num_dict[cid] = len(x) - n_test
            all_x.append(x)
            all_y.append(y)
        xg, yg = np.concatenate(all_x), np.concatenate(all_y)
        n_test_g = max(1, len(xg) // 10)
        train_g, test_g = ArrayDataset(xg[n_test_g:], yg[n_test_g:]), ArrayDataset(xg[:n_test_g], yg[:n_test_g])
        args.output_dim = class_num
        return (len(train_g), len(test_g), train_g, test_g, train_num_dict, train_local, test_local, class_num)

    if getattr(args, "allow_download", False):
        raise _not_ported("allow_download (fetching a dataset's reference archives)")
    if dataset not in IMAGE_SPECS:
        raise _not_ported(f"dataset {dataset!r}")
    x_tr, y_tr, x_te, y_te, class_num = load_image_dataset(dataset, cache, seed)

    label_for_partition = y_tr if y_tr.ndim == 1 else y_tr[:, 0]
    if method == "hetero" and y_tr.ndim == 1 and y_tr.dtype.kind in "iu":
        net_map = non_iid_partition_with_dirichlet_distribution(
            label_for_partition, client_num, class_num, alpha, seed
        )
    else:
        net_map = homo_partition(len(x_tr), client_num, seed)
    test_map = homo_partition(len(x_te), client_num, seed + 1)

    train_global = ArrayDataset(x_tr, y_tr)
    test_global = ArrayDataset(x_te, y_te)
    train_local = {cid: train_global.subset(idx) for cid, idx in net_map.items()}
    test_local = {cid: test_global.subset(idx) for cid, idx in test_map.items()}
    train_num_dict = {cid: len(idx) for cid, idx in net_map.items()}

    if y_tr.ndim == 1:
        stats = record_data_stats(label_for_partition, net_map, class_num)
        log.debug("partition stats: %s", stats)
    args.output_dim = class_num
    return (len(x_tr), len(x_te), train_global, test_global, train_num_dict, train_local, test_local, class_num)
