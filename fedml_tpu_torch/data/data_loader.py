"""Federated dataset loading and partitioning: counterpart of
``fedml_tpu/data/data_loader.py`` (reference ``python/fedml/data/data_loader.py:234``).

Same return tuple as the JAX package:

    (train_data_num, test_data_num, train_data_global, test_data_global,
     train_data_local_num_dict, train_data_local_dict, test_data_local_dict,
     class_num)

with :class:`ArrayDataset` shards (numpy; the trainers move them to the
device). Every dataset of the JAX loader is ported: from the reference's
files where a user put them under ``data_cache_dir`` (LEAF json, TFF and
FedNLP h5, the landmarks csv, reddit text, the SBD, cityscapes and COCO
drops through ``formats.py`` with the file's own client partition; CIFAR
batches, idx-ubyte files, image folders, an npz and the tabular CSVs through
``sources.py``), else from the deterministic surrogates; the shards are
bit-identical to the JAX package's. Downloads (``allow_download``) raise
NotImplementedError: nothing is fetched.

One departure: for the tabular sets the loader records the table's width in
``args.input_shape``, so ``lr`` on ``lending_club`` or ``uci`` builds its
input layer at the data's width. The JAX hub sizes it from the 28x28x1
default and fails at the first step (ROADMAP.md, Queue 3, R13).
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
from .sources import (
    IMAGE_SPECS,
    load_image_dataset,
    load_stackoverflow_lr,
    load_synthetic_lr,
    load_tabular_dataset,
    load_text_classification_dataset,
    load_text_dataset,
)

log = logging.getLogger(__name__)

TEXT_DATASETS = {"shakespeare", "fed_shakespeare", "stackoverflow_nwp", "reddit"}
TEXT_CLS_DATASETS = {"20news", "agnews", "sst2", "semeval_2010_task8"}  # FedNLP family
TABULAR_DATASETS = {"lending_club", "uci"}
SEGMENTATION_DATASETS = {"pascal_voc", "coco_seg", "cityscapes"}  # FedSeg family

FedDataset = Tuple[int, int, ArrayDataset, ArrayDataset, Dict[int, int], Dict[int, ArrayDataset],
                   Dict[int, ArrayDataset], int]


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to fedml_tpu_torch; the port reads a dataset's files "
        "from data_cache_dir or loads its surrogate (see ROADMAP.md)")


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

    from .formats import FedDataConfigError, detect_format_files, load_native_format

    fmt = detect_format_files(dataset, cache)
    if not fmt and getattr(args, "allow_download", False):
        raise _not_ported("allow_download (fetching a dataset's reference archives)")
    if fmt:
        # the reference-format files (LEAF json, TFF h5, ...) with the file's
        # own client partition
        try:
            fed = load_native_format(
                dataset, cache, client_num,
                partition_method=getattr(args, "fednlp_partition_method", None),
                partition_alpha=alpha, seed=seed,
            )
        except FedDataConfigError:
            raise  # the files are fine and the config is wrong: tell the user
        except (OSError, ValueError, KeyError) as e:
            # detection only probes for the files; a truncated or corrupt
            # drop falls back to the surrogate, loudly, as in the JAX package
            log.warning("dataset %s: native-format files detected but "
                        "unparseable (%r) — falling back to surrogate", dataset, e)
            fmt = None
    if fmt:
        args.output_dim = fed[-1]
        if dataset == "cityscapes":
            # trainId masks carry 255 for void classes; the fedseg loss
            # masks that label (reference CE ignore_index=255)
            args.seg_ignore_label = 255
        # the files' own feature shape (e.g. a truncated word_count sidecar),
        # so the hub builds a matching input layer
        args.input_shape = (1,) + tuple(np.asarray(fed[2].x).shape[1:])
        if dataset in TEXT_CLS_DATASETS:
            # the hash tokenizer's ids lie in [0, FEDNLP_HASH_VOCAB): the
            # embedding must cover them
            from .formats import FEDNLP_HASH_VOCAB

            args.vocab_size = FEDNLP_HASH_VOCAB
        return fed

    if dataset in TEXT_CLS_DATASETS:
        x_tr, y_tr, x_te, y_te, class_num = load_text_classification_dataset(dataset, cache, seed)
    elif dataset in TEXT_DATASETS:
        x_tr, y_tr, x_te, y_te, class_num = load_text_dataset(dataset, cache, seed)
    elif dataset in IMAGE_SPECS:
        x_tr, y_tr, x_te, y_te, class_num = load_image_dataset(dataset, cache, seed)
    elif dataset in TABULAR_DATASETS:
        x_tr, y_tr, x_te, y_te, class_num = load_tabular_dataset(dataset, cache, seed)
        args.input_shape = (1,) + tuple(x_tr.shape[1:])  # R13, see the module docstring
    elif dataset == "stackoverflow_lr":
        x_tr, y_tr, x_te, y_te, class_num = load_stackoverflow_lr(cache, seed)
    elif dataset in SEGMENTATION_DATASETS:
        # the reference's fedseg reads pascal_voc/coco; the shapes surrogate
        # of sp/fedseg.py stands in
        from ..simulation.sp.fedseg import make_segmentation_data

        clients, (x_te, y_te) = make_segmentation_data(client_num, seed=seed)
        train_local = {cid: ArrayDataset(x, y) for cid, (x, y) in clients.items()}
        test_local = {cid: ArrayDataset(x_te, y_te) for cid in clients}
        train_num = {cid: len(ds) for cid, ds in train_local.items()}
        xg = np.concatenate([c[0] for c in clients.values()])
        yg = np.concatenate([c[1] for c in clients.values()])
        class_num = int(yg.max()) + 1
        args.output_dim = class_num
        return (len(xg), len(x_te), ArrayDataset(xg, yg), ArrayDataset(x_te, y_te),
                train_num, train_local, test_local, class_num)
    else:
        raise ValueError(f"unknown dataset {dataset!r}")

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
