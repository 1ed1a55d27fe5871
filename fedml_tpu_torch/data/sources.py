"""Raw dataset sources: the numpy part of ``fedml_tpu/data/sources.py``.

The JAX package looks for a dataset's files under ``data_cache_dir`` and
otherwise synthesises a deterministic surrogate with the real dataset's
shapes and class count (class-dependent means, so accuracy means
something). The port copies the surrogates and the ``{cache}/{name}.npz``
branch bit for bit; the native formats (CIFAR batch pickles, idx-ubyte,
image folders, LEAF/TFF files) and downloads raise NotImplementedError, so
a run never falls back to a surrogate where the JAX package would have read
real files (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import logging
import os
from typing import Tuple

import numpy as np

log = logging.getLogger(__name__)

# name -> (shape, classes, n_train, n_test), as the JAX package's table
IMAGE_SPECS = {
    "mnist": ((28, 28, 1), 10, 60000, 10000),
    "femnist": ((28, 28, 1), 62, 40000, 8000),
    "fashion_mnist": ((28, 28, 1), 10, 60000, 10000),
    "cifar10": ((32, 32, 3), 10, 50000, 10000),
    "cifar100": ((32, 32, 3), 100, 50000, 10000),
    "cinic10": ((32, 32, 3), 10, 90000, 9000),
    "fed_cifar100": ((32, 32, 3), 100, 50000, 10000),
    "imagenet": ((64, 64, 3), 1000, 20000, 2000),
    "gld23k": ((64, 64, 3), 203, 23000, 2000),
    "landmarks": ((64, 64, 3), 203, 23000, 2000),
}

# where the JAX loader finds a dataset's native files, besides
# {cache}/{name}/ (its LEAF, TFF, image-folder and archive layouts)
_NATIVE_AT_ROOT = {
    "cifar10": ("cifar-10-batches-py",),
    "cifar100": ("cifar-100-python",),
    "fashion_mnist": ("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"),
}


def native_files(name: str, cache_dir: str):
    """The path of ``name``'s native files under ``cache_dir``, or None."""
    if not cache_dir:
        return None
    for rel in (name,) + _NATIVE_AT_ROOT.get(name, ()):
        path = os.path.join(cache_dir, rel)
        if os.path.exists(path):
            return path
    return None


def _synthetic_classification(
    n: int, shape: Tuple[int, ...], classes: int, proto_seed: int, sample_seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussian images: learnable but not trivial.

    Class prototypes depend only on ``proto_seed`` so train/test splits share
    the same class structure; ``sample_seed`` draws the samples."""
    dim = int(np.prod(shape))
    protos = np.random.default_rng(proto_seed).normal(0.0, 1.0, size=(classes, dim)).astype(np.float32)
    rng = np.random.default_rng(sample_seed)
    y = rng.integers(0, classes, size=n)
    x = protos[y] * 0.35 + rng.normal(0, 1.0, size=(n, dim)).astype(np.float32)
    return x.reshape((n,) + shape).astype(np.float32), y.astype(np.int64)


def _load_npz(path: str):
    with np.load(path) as z:
        return (
            z["x_train"].astype(np.float32),
            z["y_train"].astype(np.int64),
            z["x_test"].astype(np.float32),
            z["y_test"].astype(np.int64),
        )


def load_image_dataset(name: str, cache_dir: str, seed: int = 0):
    """-> (x_train, y_train, x_test, y_test, num_classes)."""
    shape, classes, n_train, n_test = IMAGE_SPECS[name]
    native = native_files(name, cache_dir)
    if native:
        raise NotImplementedError(
            f"dataset {name}: native files at {native}; reading them is not ported to "
            "fedml_tpu_torch yet (see ROADMAP.md, Queue 1)")
    path = os.path.join(cache_dir or "", f"{name}.npz")
    if cache_dir and os.path.exists(path):
        x_tr, y_tr, x_te, y_te = _load_npz(path)
        if x_tr.max() > 2.0:
            x_tr, x_te = x_tr / 255.0, x_te / 255.0
        if x_tr.ndim == 3 and len(shape) == 3:
            x_tr, x_te = x_tr[..., None], x_te[..., None]
        return x_tr, y_tr, x_te, y_te, classes
    log.warning("dataset %s: no local file at %s — using deterministic synthetic surrogate", name, path)
    # keep surrogate sizes small enough for fast simulation
    n_train, n_test = min(n_train, 12000), min(n_test, 2000)
    x_tr, y_tr = _synthetic_classification(n_train, shape, classes, seed, seed + 1)
    x_te, y_te = _synthetic_classification(n_test, shape, classes, seed, seed + 2)
    return x_tr, y_tr, x_te, y_te, classes


def load_synthetic_lr(alpha: float, beta: float, n_clients: int, seed: int = 0, dim: int = 60,
                      classes: int = 10):
    """LEAF synthetic(alpha,beta) (reference: data/synthetic_1_1/). Returns
    per-client (x, y) lists with client-specific model/feature drift."""
    rng = np.random.default_rng(seed)
    out = []
    B = rng.normal(0, beta, n_clients)
    for k in range(n_clients):
        n_k = int(np.clip(rng.lognormal(4, 2), 50, 1000))
        u_k = rng.normal(B[k], 1, 1)
        mean_x = rng.normal(B[k], 1, dim)
        W = rng.normal(u_k, alpha, (dim, classes))
        b = rng.normal(u_k, alpha, classes)
        x = rng.normal(mean_x, 1.0, (n_k, dim)).astype(np.float32)
        logits = x @ W + b
        y = np.argmax(logits + rng.gumbel(size=logits.shape), axis=1).astype(np.int64)
        out.append((x, y))
    return out, classes


def edge_case_pickle_path(cache_dir: str) -> str:
    """Where the reference's southwest edge-case pool sits in the data cache:
    one definition, shared with the edge-case attack's check."""
    return os.path.join(cache_dir or "", "edge_case_examples",
                        "southwest_cifar10", "southwest_images_new_train.pkl")


def load_edge_case_examples(seed: int = 0, n: int = 256, shape=(28, 28, 1),
                            target_class: int = 0, cache_dir: str = ""):
    """Edge-case backdoor pool (reference: data/edge_case_examples/, Wang et
    al. 2020): the reference's southwest-airplane pickle (a [N, 32, 32, 3]
    uint8 array) when a user put it in ``cache_dir``, read through the
    restricted unpickler, every sample labelled ``target_class``; else
    high-contrast corner-patch patterns far from the benign data, all
    labelled ``target_class``. Nothing is downloaded."""
    pkl = edge_case_pickle_path(cache_dir)
    if cache_dir and os.path.exists(pkl):
        import pickle

        from ..core.distributed.communication.grpc.ref_wire import unpickle_ref_tree

        try:
            with open(pkl, "rb") as f:
                arr = np.asarray(unpickle_ref_tree(f.read(), encoding="bytes"))
            x = arr.astype(np.float32) / 255.0
            if n and len(x) > n:
                x = x[np.random.default_rng(seed).choice(len(x), n, replace=False)]
            log.info("edge_case_examples: loaded the southwest pool from %s (%d samples)",
                     pkl, len(x))
            return x, np.full(len(x), target_class, np.int64)
        except (OSError, ValueError, KeyError, pickle.UnpicklingError) as e:
            log.warning("edge_case_examples: %s unreadable (%r); using the surrogate", pkl, e)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.1, (n,) + tuple(shape)).astype(np.float32)
    x[:, : shape[0] // 4, : shape[1] // 4, ...] = 3.0  # trigger patch
    return x, np.full(n, target_class, np.int64)
