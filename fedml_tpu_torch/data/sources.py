"""Raw dataset sources: the numpy part of ``fedml_tpu/data/sources.py``.

The JAX package looks for a dataset's files under ``data_cache_dir`` and
otherwise synthesises a deterministic surrogate with the real dataset's
shapes and class count (class-dependent means, so accuracy means
something). The port copies all of it bit for bit: the surrogates, the
``{cache}/{name}.npz`` branch, the reference's native files (CIFAR
python-batch pickles through the restricted unpickler, idx-ubyte drops,
class-per-directory image folders, the NUS-WIDE trio) and the tabular CSV
readers (lending club's ``loan.csv``, UCI's SUSY and room-occupancy files).
The LEAF, TFF, FedNLP, reddit and segmentation layouts are
``formats.py``'s. Nothing is downloaded.

Canonical local files recognized:
  - mnist:   ``{cache}/mnist.npz``       (keys x_train,y_train,x_test,y_test)
  - cifar10: ``{cache}/cifar10.npz``     (same keys, NHWC uint8), or the
    extracted ``cifar-10-batches-py`` (``cifar-100-python`` for cifar100)
  - fashion_mnist: the four idx-ubyte files (optionally gzipped)
  - cinic10 / imagenet: ``{cache}/{name}/train/<class>/*.png|jpg``
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

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


# --- CIFAR python-batch binaries (the reference's native on-disk layout) -----

def _cifar_batch_dir(name: str, cache_dir: str) -> Optional[str]:
    """Locate the extracted CIFAR archive dir (``cifar-10-batches-py`` /
    ``cifar-100-python`` — what the reference's torchvision-backed loaders
    read after ``download_cifar10.sh``), under the cache root or the
    dataset's subdir."""
    sub = "cifar-10-batches-py" if name == "cifar10" else "cifar-100-python"
    probe = "data_batch_1" if name == "cifar10" else "train"
    candidates = [
        os.path.join(cache_dir, sub),
        os.path.join(cache_dir, name, sub),
        # downloads._flatten_single_dir hoists a lone wrapper dir, leaving
        # the batch files directly under {cache}/{name}
        os.path.join(cache_dir, name),
    ]
    for d in candidates:
        if os.path.exists(os.path.join(d, probe)):
            return d
    return None


def _read_cifar_pickle(path: str) -> dict:
    """CIFAR batches are pickles; load through the restricted unpickler
    (numpy/builtins allowlist — a hostile 'dataset' file must not execute).
    encoding='bytes' because the canonical Krizhevsky archives are
    Python-2 pickles whose payload strings are raw image bytes."""
    from ..core.distributed.communication.grpc.ref_wire import unpickle_ref_tree

    with open(path, "rb") as f:
        return unpickle_ref_tree(f.read(), encoding="bytes")


def load_cifar_batches(name: str, batch_dir: str):
    """Parse the reference CIFAR binary layout: ``data_batch_1..5`` +
    ``test_batch`` (cifar10, key b'labels') or ``train``/``test`` (cifar100,
    key b'fine_labels'); rows are [3072] uint8 CHW
    (reference ``data/cifar10/datasets.py:45-57`` via torchvision CIFAR10,
    same files)."""
    if name == "cifar10":
        train_files = [f"data_batch_{i}" for i in range(1, 6)]
        test_files, label_key, classes = ["test_batch"], b"labels", 10
    else:
        train_files, test_files, label_key, classes = ["train"], ["test"], b"fine_labels", 100

    def read(files):
        xs, ys = [], []
        for fname in files:
            d = _read_cifar_pickle(os.path.join(batch_dir, fname))
            # py2-era archives give bytes keys; a py3 re-pickle gives str
            data = d.get(b"data", d.get("data"))
            labels = d.get(label_key, d.get(label_key.decode()))
            xs.append(np.asarray(data, np.uint8))
            ys.append(np.asarray(labels, np.int64))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32) / 255.0, np.concatenate(ys)

    x_tr, y_tr = read(train_files)
    x_te, y_te = read(test_files)
    log.info("dataset %s: loaded NATIVE binary batches from %s (%d train / %d test)",
             name, batch_dir, len(x_tr), len(x_te))
    return x_tr, y_tr, x_te, y_te, classes


# --- idx-ubyte (the canonical MNIST-family distribution format) --------------

def _read_idx(path: str) -> np.ndarray:
    """One idx-ubyte file (optionally gzipped): big-endian magic whose low
    byte is the rank, then rank u32 dims, then uint8 payload (the format
    fashion-mnist ships in; reference consumes it via torchvision
    FashionMNIST, same files)."""
    import gzip
    import struct

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    (magic,) = struct.unpack(">I", data[:4])
    if magic >> 8 != 0x08:  # 0x08 == unsigned byte element type
        raise ValueError(f"{path}: not an idx-ubyte file (magic {magic:#x})")
    ndim = magic & 0xFF
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _idx_file(d: str, stem: str) -> Optional[str]:
    for suffix in ("", ".gz"):
        p = os.path.join(d, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def _idx_dir(name: str, cache_dir: str) -> Optional[str]:
    """Locate the 4 idx files directly under {cache}/{name}, {cache}, or the
    torchvision-style {cache}/{name}/raw."""
    for d in (os.path.join(cache_dir, name), cache_dir,
              os.path.join(cache_dir, name, "raw")):
        if _idx_file(d, "train-images-idx3-ubyte"):
            return d
    return None


def load_idx_ubyte(idx_dir: str):
    """Parse train/t10k idx pairs -> (x_tr [N,28,28,1] f32, y_tr, x_te, y_te, 10)."""
    parts = {}
    for split, stem in (("train_x", "train-images-idx3-ubyte"),
                        ("train_y", "train-labels-idx1-ubyte"),
                        ("test_x", "t10k-images-idx3-ubyte"),
                        ("test_y", "t10k-labels-idx1-ubyte")):
        path = _idx_file(idx_dir, stem)
        if path is None:
            raise FileNotFoundError(f"{idx_dir}: missing {stem}[.gz]")
        parts[split] = _read_idx(path)
    x_tr = parts["train_x"].astype(np.float32)[..., None] / 255.0
    x_te = parts["test_x"].astype(np.float32)[..., None] / 255.0
    log.info("loaded NATIVE idx-ubyte files from %s (%d train / %d test)",
             idx_dir, len(x_tr), len(x_te))
    return x_tr, parts["train_y"].astype(np.int64), x_te, parts["test_y"].astype(np.int64), 10


# --- class-per-directory image folders (cinic10 / imagenet layout) -----------

def max_images_per_class(n_classes: int = 1, default: int = 1000,
                         total_default: int = 50_000) -> int:
    """In-memory cap per (split, class): the reference streams these trees
    through a lazy torchvision ImageFolder; our ArrayDataset holds arrays,
    so unbounded parsing would eat the host. Knobs:
    FEDML_MAX_IMAGES_PER_CLASS (default 1000 — sized for CINIC's 10
    classes) and FEDML_MAX_IMAGES_TOTAL per split (default 50k — a
    1000-class imagenet drop would otherwise admit 1M images at the
    per-class cap alone and OOM the host). Defaults combine tighter-wins;
    an EXPLICIT per-class setting is taken as the user sizing for their
    RAM and BYPASSES the default total cap (set both knobs to combine
    explicit values)."""
    per_class_env = os.environ.get("FEDML_MAX_IMAGES_PER_CLASS")
    total_env = os.environ.get("FEDML_MAX_IMAGES_TOTAL")
    per_class = int(per_class_env) if per_class_env else default
    if per_class_env and not total_env:
        # an EXPLICIT per-class override is the user sizing for their RAM;
        # the total default must not silently tighten it back down
        return max(1, per_class)
    total = int(total_env) if total_env else total_default
    return max(1, min(per_class, total // max(1, n_classes)))


def _image_folder_root(name: str, cache_dir: str) -> Optional[str]:
    """{cache}/{name}/train/<class>/*.png|jpg — the CINIC-10 archive layout
    (reference data/cinic10/data_loader.py:123-128 points ImageFolder at
    datadir/train and datadir/test)."""
    root = os.path.join(cache_dir, name)
    train = os.path.join(root, "train")
    try:
        if os.path.isdir(train) and any(
            os.path.isdir(os.path.join(train, c)) for c in os.listdir(train)
        ):
            return root
    except OSError:
        pass
    return None


def load_image_folder(root: str, size: Tuple[int, int], test_split: str = "test"):
    """Parse a class-per-directory tree -> the standard 5-tuple. Class ids
    follow sorted directory names (torchvision ImageFolder's convention, so
    labels match the reference's). Images are resized to ``size`` (CINIC is
    already 32x32; a stray odd-sized file must not break the batch shape)."""
    from PIL import Image

    # class ids come from the TRAIN split's sorted dirs and are REUSED for
    # test: re-deriving them per split silently misaligns every label when a
    # partial drop is missing (or grew) a class dir in one split
    train_dir = os.path.join(root, "train")
    class_names = sorted(
        c for c in os.listdir(train_dir) if os.path.isdir(os.path.join(train_dir, c))
    )
    class_ids = {c: i for i, c in enumerate(class_names)}

    def read_split(split: str):
        split_dir = os.path.join(root, split)
        present = [c for c in class_names if os.path.isdir(os.path.join(split_dir, c))]
        if not present:
            raise FileNotFoundError(f"{split_dir}: none of the train classes present")
        extra = sorted(
            set(c for c in os.listdir(split_dir) if os.path.isdir(os.path.join(split_dir, c)))
            - set(class_names)
        )
        if extra:
            log.warning("image folder %s/%s: ignoring %d class dirs absent from "
                        "train (%s...)", root, split, len(extra), extra[0])
        cap = max_images_per_class(n_classes=len(class_names))
        xs, ys, truncated = [], [], 0
        for cname in present:
            cdir = os.path.join(split_dir, cname)
            files = sorted(f for f in os.listdir(cdir)
                           if f.lower().endswith((".png", ".jpg", ".jpeg")))
            if len(files) > cap:
                truncated += len(files) - cap
                files = files[:cap]
            for fname in files:
                img = Image.open(os.path.join(cdir, fname)).convert("RGB")
                if img.size != size:
                    img = img.resize(size)
                xs.append(np.asarray(img, np.uint8))
                ys.append(class_ids[cname])
        if truncated:
            log.warning(
                "image folder %s/%s: capped at %d images/class (%d skipped) — "
                "raise FEDML_MAX_IMAGES_PER_CLASS / FEDML_MAX_IMAGES_TOTAL "
                "to parse more", root, split, cap, truncated,
            )
        if not xs:
            # a partially-extracted drop can leave class dirs with no images;
            # FileNotFoundError (not np.stack's ValueError) so the test-split
            # holdout fallback below — and the surrogate fallback in
            # load_image_dataset — both see it as "split absent"
            raise FileNotFoundError(f"{split_dir}: no image files in any class dir")
        x = np.stack(xs).astype(np.float32) / 255.0
        return x, np.asarray(ys, np.int64), len(class_names)

    x_tr, y_tr, n_classes = read_split("train")
    try:
        x_te, y_te, _ = read_split(test_split)
    except (FileNotFoundError, OSError):
        # CINIC has train/valid/test; some drops carry only train — hold out
        # a SHUFFLED tenth (read_split's output is class-ordered: a prefix
        # slice would make train and test class-disjoint)
        perm = np.random.default_rng(0).permutation(len(x_tr))
        n_hold = max(1, len(x_tr) // 10)
        hold, keep = perm[:n_hold], perm[n_hold:]
        x_te, y_te = x_tr[hold], y_tr[hold]
        x_tr, y_tr = x_tr[keep], y_tr[keep]
    log.info("loaded NATIVE image folder %s (%d train / %d test, %d classes)",
             root, len(x_tr), len(x_te), n_classes)
    return x_tr, y_tr, x_te, y_te, n_classes


def load_image_dataset(name: str, cache_dir: str, seed: int = 0):
    """-> (x_train, y_train, x_test, y_test, num_classes)."""
    shape, classes, n_train, n_test = IMAGE_SPECS[name]
    if name in ("cifar10", "cifar100") and cache_dir:
        batch_dir = _cifar_batch_dir(name, cache_dir)
        if batch_dir:
            return load_cifar_batches(name, batch_dir)
    if name == "fashion_mnist" and cache_dir:
        idx_dir = _idx_dir(name, cache_dir)
        if idx_dir:
            try:
                return load_idx_ubyte(idx_dir)
            except (OSError, ValueError) as e:
                log.warning("fashion_mnist: idx files at %s unreadable (%r) — "
                            "falling back to surrogate", idx_dir, e)
    if name in ("cinic10", "imagenet") and cache_dir:
        folder = _image_folder_root(name, cache_dir)
        if folder:
            # CINIC's held-out split is named "test"; a downsampled-imagenet
            # drop usually ships "val"
            split = "test" if name == "cinic10" else "val"
            try:
                return load_image_folder(folder, size=shape[:2], test_split=split)
            except (OSError, ValueError) as e:
                # an empty or partly extracted tree falls back to the
                # surrogate, as in the JAX package
                log.warning("%s: image folder at %s unreadable (%r) — "
                            "falling back to surrogate", name, folder, e)
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


# --- text, text classification, tabular, stackoverflow_lr ----------------------------

def _markov_sample(rng: np.random.Generator, cum: np.ndarray, n: int, T: int):
    """``n`` sequences of ``T + 1`` tokens from the order-1 chain whose rows'
    cumulative sums are ``cum``: (x [n, T], y [n, T], y shifted by one).

    The JAX package draws token t+1 as ``(cumsum(trans[x_t]) < r).sum()``,
    gathering and summing an [n, vocab] block per step. A cumulative sum of
    non-negative terms never decreases, so that count is
    ``searchsorted(cum[x_t], r)``; the rows' sums are taken once, in the
    same order, so every token is the JAX package's, with the same draws
    from ``rng``."""
    seqs = np.zeros((n, T + 1), np.int64)
    seqs[:, 0] = rng.integers(0, cum.shape[0], n)
    for t in range(T):
        prev = seqs[:, t]
        r = rng.random((n, 1))[:, 0]
        order = np.argsort(prev, kind="stable")
        tokens = prev[order]
        starts = np.flatnonzero(np.r_[True, tokens[1:] != tokens[:-1]])
        for s, e in zip(starts, np.r_[starts[1:], n]):
            rows = order[s:e]
            seqs[rows, t + 1] = np.searchsorted(cum[tokens[s]], r[rows], side="left")
    return seqs[:, :T], seqs[:, 1:T + 1]


def load_text_dataset(name: str, cache_dir: str, seed: int = 0):
    """-> (x_train [N, T] int, y_train [N, T] int, x_test, y_test, vocab):
    next-token targets, y[t] = x[t+1]. ``{cache}/{name}.npz`` or the JAX
    package's order-1 markov surrogate, token for token."""
    specs = {
        "shakespeare": (80, 90, 8000, 1000),
        "fed_shakespeare": (80, 90, 8000, 1000),
        "stackoverflow_nwp": (20, 10004, 8000, 1000),
        "reddit": (20, 10000, 8000, 1000),  # reference data/reddit
    }
    T, vocab, n_train, n_test = specs[name]
    path = os.path.join(cache_dir or "", f"{name}.npz")
    if cache_dir and os.path.exists(path):
        with np.load(path) as z:
            return z["x_train"], z["y_train"], z["x_test"], z["y_test"], vocab
    log.warning("dataset %s: no local file — synthetic markov text surrogate", name)
    rng = np.random.default_rng(seed)
    # order-1 markov chain so there is real next-token signal
    cum = rng.dirichlet(np.ones(vocab) * 0.05, size=vocab).cumsum(axis=1)
    x_tr, y_tr = _markov_sample(rng, cum, n_train, T)
    x_te, y_te = _markov_sample(rng, cum, n_test, T)
    return x_tr, y_tr, x_te, y_te, vocab


def load_text_classification_dataset(name: str, cache_dir: str, seed: int = 0):
    """Text classification (FedNLP family, reference ``data/fednlp/``; 20news
    is BASELINE config 3's DistilBERT task) -> (x_train [N, T] int tokens,
    y_train [N], x_test, y_test, classes). ``{cache}/{name}.npz`` or a
    surrogate of class-conditional unigram token distributions."""
    specs = {
        # name: (seq_len, vocab, classes, n_train, n_test)
        "20news": (128, 5000, 20, 11314, 2000),  # real 20news train size
        "agnews": (64, 5000, 4, 12000, 2000),
        "sst2": (32, 3000, 2, 8000, 1000),
        "semeval_2010_task8": (64, 4000, 19, 8000, 1000),
    }
    T, vocab, classes, n_train, n_test = specs[name]
    path = os.path.join(cache_dir or "", f"{name}.npz")
    if cache_dir and os.path.exists(path):
        x_tr, y_tr, x_te, y_te = _load_npz(path)
        return x_tr.astype(np.int64), y_tr, x_te.astype(np.int64), y_te, classes
    log.warning("dataset %s: no local file at %s — synthetic text-cls surrogate", name, path)
    n_train, n_test = min(n_train, 8000), min(n_test, 2000)
    base = np.random.default_rng(seed).dirichlet(np.ones(vocab) * 0.02, size=classes)

    def sample(n, s):
        r = np.random.default_rng(s)
        y = r.integers(0, classes, n)
        x = np.empty((n, T), np.int64)
        for c in range(classes):  # one vectorized draw per class, not per sample
            idx = np.nonzero(y == c)[0]
            if len(idx):
                x[idx] = r.choice(vocab, size=(len(idx), T), p=base[c])
        return x, y.astype(np.int64)

    x_tr, y_tr = sample(n_train, seed + 2)
    x_te, y_te = sample(n_test, seed + 3)
    return x_tr, y_tr, x_te, y_te, classes


def load_tabular_dataset(name: str, cache_dir: str, seed: int = 0):
    """Binary tabular sets (reference data/lending_club_loan/ and data/UCI/)
    -> (x_train, y_train, x_test, y_test, 2): ``{cache}/{name}.npz``, else
    the reference's CSV (lending club's ``loan.csv``, UCI's ``SUSY.csv`` or
    ``datatraining.txt``, under ``{cache}/{name}/`` or ``{cache}/``), else a
    surrogate with a planted linear decision boundary."""
    specs = {
        "lending_club": (90, 40000, 5000),
        "uci": (105, 30000, 4000),  # one-hot-encoded adult-census width
    }
    dim, n_train, n_test = specs[name]
    path = os.path.join(cache_dir or "", f"{name}.npz")
    if cache_dir and os.path.exists(path):
        # the npz override wins over a raw csv in the same cache
        return (*_load_npz(path), 2)
    if name == "lending_club" and cache_dir:
        for csv_path in (os.path.join(cache_dir, "lending_club", "loan.csv"),
                         os.path.join(cache_dir, "loan.csv")):
            if os.path.exists(csv_path):
                return load_lending_club_csv(csv_path, seed)
    if name == "uci" and cache_dir:
        for fname, kind in (("SUSY.csv", "susy"), ("datatraining.txt", "room_occupancy")):
            for csv_path in (os.path.join(cache_dir, "uci", fname),
                             os.path.join(cache_dir, fname)):
                if os.path.exists(csv_path):
                    try:
                        return load_uci_csv(csv_path, kind, seed)
                    except ValueError as e:
                        log.warning("uci: %s unparseable (%r); falling back to the surrogate",
                                    csv_path, e)
    log.warning("dataset %s: no local file at %s — synthetic tabular surrogate", name, path)
    n_train, n_test = min(n_train, 10000), min(n_test, 2000)
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, dim).astype(np.float32)

    def sample(n, s):
        r = np.random.default_rng(s)
        x = r.normal(0, 1, (n, dim)).astype(np.float32)
        logit = x @ w + 0.5 * r.normal(0, 1, n)
        return x, (logit > 0).astype(np.int64)

    x_tr, y_tr = sample(n_train, seed + 1)
    x_te, y_te = sample(n_test, seed + 2)
    return x_tr, y_tr, x_te, y_te, 2


def load_stackoverflow_lr(cache_dir: str, seed: int = 0, n_train: int = 8000, n_test: int = 1000):
    """StackOverflow tag prediction (reference data/stackoverflow_lr/):
    bag-of-words features, multi-hot tag labels -> (x, y float multi-hot,
    ..., n_tags)."""
    dim, n_tags = 10000, 500
    path = os.path.join(cache_dir or "", "stackoverflow_lr.npz")
    if cache_dir and os.path.exists(path):
        with np.load(path) as z:
            return (
                z["x_train"].astype(np.float32), z["y_train"].astype(np.float32),
                z["x_test"].astype(np.float32), z["y_test"].astype(np.float32), n_tags,
            )
    log.warning("dataset stackoverflow_lr: no local file — synthetic BoW surrogate")
    rng = np.random.default_rng(seed)
    # each tag fires on a sparse subset of words
    tag_words = (rng.random((n_tags, dim)) < 0.002).astype(np.float32)

    def sample(n, s):
        r = np.random.default_rng(s)
        tags = (r.random((n, n_tags)) < 3.0 / n_tags).astype(np.float32)
        x = (tags @ tag_words) + r.poisson(0.01, (n, dim))
        x = np.minimum(x, 3.0).astype(np.float32)
        return x, tags

    x_tr, y_tr = sample(n_train, seed + 1)
    x_te, y_te = sample(n_test, seed + 2)
    return x_tr, y_tr, x_te, y_te, n_tags


# --- lending club loan.csv (the reference's native tabular source) -------------------

# loan_status values the reference labels "Bad Loan"
# (data/lending_club_loan/lending_club_dataset.py:121-133)
_BAD_LOAN_STATUS = {
    "Charged Off",
    "Default",
    "Does not meet the credit policy. Status:Charged Off",
    "In Grace Period",
    "Late (16-30 days)",
    "Late (31-120 days)",
}

# the reference's curated numeric feature columns
# (data/lending_club_loan/lending_club_feature_group.py: the numeric members of
# its qualification/loan/debt/repayment/multi-acc/malicious-behavior groups)
_LOAN_NUMERIC_FEATURES = (
    "annual_inc_comp", "total_rev_hi_lim", "tot_hi_cred_lim", "total_bc_limit",
    "total_il_high_credit_limit", "loan_amnt", "int_rate", "installment",
    "revol_bal", "revol_util", "out_prncp", "recoveries", "dti", "dti_joint",
    "tot_coll_amt", "mths_since_rcnt_il", "total_bal_il", "il_util",
    "max_bal_bc", "all_util", "bc_util", "total_bal_ex_mort",
    "revol_bal_joint", "mo_sin_old_il_acct", "mo_sin_old_rev_tl_op",
    "mo_sin_rcnt_rev_tl_op", "mort_acc", "num_rev_tl_bal_gt_0",
    "percent_bc_gt_75", "num_sats", "num_bc_sats", "pct_tl_nvr_dlq",
    "bc_open_to_buy", "last_pymnt_amnt", "total_pymnt", "total_pymnt_inv",
    "total_rec_prncp", "total_rec_int", "total_rec_late_fee", "tot_cur_bal",
    "avg_cur_bal", "num_il_tl", "num_op_rev_tl", "num_rev_accts",
    "num_actv_rev_tl", "num_tl_op_past_12m", "open_rv_12m", "open_rv_24m",
    "open_acc_6m", "open_act_il", "open_il_12m", "open_il_24m", "total_acc",
    "inq_last_6mths", "open_acc", "inq_fi", "inq_last_12m",
    "acc_open_past_24mths", "num_tl_120dpd_2m", "num_tl_30dpd",
    "num_tl_90g_dpd_24m", "pub_rec_bankruptcies",
    "mths_since_recent_revol_delinq", "num_accts_ever_120_pd",
    "mths_since_recent_bc_dlq", "chargeoff_within_12_mths",
)


def load_lending_club_csv(csv_path: str, seed: int = 0, test_frac: float = 0.1):
    """The reference's ``loan.csv`` with its own preprocessing
    (``lending_club_dataset.py:190-204``): a binary good/bad target from
    loan_status, the curated feature columns, the issue_year == 2018 filter
    when issue_d parses, NaN filled with -99, the columns standardised, then
    a seeded shuffle and a test split. -> (x_train, y_train, x_test, y_test,
    2). Needs pandas, as the JAX package's reader does."""
    import pandas as pd

    header = pd.read_csv(csv_path, nrows=0).columns
    curated = [c for c in _LOAN_NUMERIC_FEATURES if c in header]
    if curated:
        # read only the needed columns: the real corpus is ~2 GB, 145 columns
        needed = set(curated) | {"loan_status", "issue_d"}
        df = pd.read_csv(csv_path, usecols=lambda c: c in needed, low_memory=False)
    else:
        df = pd.read_csv(csv_path, low_memory=False)
    if "loan_status" not in df.columns:
        raise ValueError(f"{csv_path} has no loan_status column")
    if "issue_d" in df.columns:
        # the reference keeps the 2018 vintage (lending_club_dataset.py:198)
        years = pd.to_datetime(df["issue_d"], format="%b-%Y", errors="coerce").dt.year
        if (years == 2018).any():
            df = df[years == 2018]
    y = df["loan_status"].isin(_BAD_LOAN_STATUS).to_numpy().astype(np.int64)
    cols = [c for c in _LOAN_NUMERIC_FEATURES if c in df.columns]
    if not cols:  # a csv without the curated columns: its numeric columns
        feats = df.drop(columns=["loan_status"]).select_dtypes(include=[np.number])
    else:
        feats = df[cols].apply(pd.to_numeric, errors="coerce")
    x = feats.fillna(-99).to_numpy(np.float32)  # the reference's fillna(-99), :204
    std = x.std(axis=0)
    std[std == 0] = 1.0
    x = (x - x.mean(axis=0)) / std
    order = np.random.default_rng(seed).permutation(len(x))
    x, y = x[order], y[order]
    n_test = max(1, int(len(x) * test_frac))
    log.info("dataset lending_club: parsed %s (%d rows, %d features)", csv_path, len(x),
             x.shape[1])
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test], 2


def load_uci_csv(csv_path: str, kind: str, seed: int = 0, test_frac: float = 0.1,
                 max_rows: int = 200_000):
    """The reference's UCI streaming sources with its own column slicing
    (``data/UCI/data_loader_for_susy_and_ro.py:141-154``): SUSY.csv rows are
    [label, 18 features]; room-occupancy ``datatraining.txt`` rows are [id,
    date, Temperature..HumidityRatio, Occupancy], read as ``row[2:-1]``
    features and ``row[-1]`` label. Columns standardised, a seeded shuffle
    and a test split. -> (x_train, y_train, x_test, y_test, 2)."""
    import csv

    xs, ys = [], []
    with open(csv_path) as f:
        for i, row in enumerate(csv.reader(f)):
            if i >= max_rows:
                log.warning("dataset uci: capped at %d rows of %s; raise max_rows to parse "
                            "more", max_rows, csv_path)
                break
            if not row:
                continue
            try:
                if kind == "susy":
                    xs.append(np.asarray(row[1:], np.float32))
                    ys.append(int(float(row[0])))
                else:  # room occupancy; the first line is a quoted header
                    xs.append(np.asarray(row[2:-1], np.float32))
                    ys.append(int(float(row[-1])))
            except ValueError:
                continue  # a header or malformed line
    if not xs:
        raise ValueError(f"{csv_path}: no parseable {kind} rows")
    x, y = np.stack(xs), np.asarray(ys, np.int64)
    std = x.std(axis=0)
    std[std == 0] = 1.0
    x = (x - x.mean(axis=0)) / std
    order = np.random.default_rng(seed).permutation(len(x))
    x, y = x[order], y[order]
    n_test = max(1, int(len(x) * test_frac))
    log.info("dataset uci (%s): parsed %s (%d rows, %d features)", kind, csv_path, len(x),
             x.shape[1])
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test], 2


# --- NUS-WIDE (the vertical-FL source) ----------------------------------------------

def _read_space_dat(path: str, sep: Optional[str] = None,
                    max_rows: Optional[int] = None) -> np.ndarray:
    """One NUS-WIDE .dat table -> float matrix; columns containing ANY NaN
    (trailing separators, ragged empty fields) are dropped — pandas
    ``df.dropna(axis=1)`` semantics, which the reference relies on. A kept
    column is therefore guaranteed NaN-free: a scattered-NaN column must
    not survive into standardize() where it would turn the whole feature
    NaN silently. ``max_rows`` stops the (pure-Python) parse early — the
    real Tags1k.dat is ~161k rows x 1000 fields and float()ing the unused
    tail would dominate load time."""
    rows = []
    with open(path) as f:
        for i, line in enumerate(f):
            if max_rows is not None and i >= max_rows:
                break
            parts = line.split(sep) if sep else line.split()
            rows.append([float(p) if p.strip() else np.nan for p in parts] if sep
                        else [float(p) for p in parts])
    arr = np.asarray(rows, np.float32)
    if arr.ndim == 2:
        keep = ~np.any(np.isnan(arr), axis=0)
        arr = arr[:, keep]
    return arr


def load_nus_wide_files(data_dir: str, n_parties: int = 2, dtype: str = "Train",
                        top_k: int = 2, max_rows: int = 20_000):
    """NUS-WIDE from the reference's own on-disk trio
    (``data/NUS_WIDE/nus_wide_dataset.py:23-71``):
    ``Groundtruth/TrainTestLabels/Labels_<label>_<dtype>.txt`` (one 0/1 per
    line), ``Low_Level_Features/<dtype>_Normalized_*.dat`` (space-separated
    image features, 634 columns across files), and
    ``NUS_WID_Tags/<dtype>_Tags1k.dat`` (tab-separated 1k tag indicators).
    Selected labels = the reference's top-k-by-positive-count rule
    (``get_top_k_labels``); rows with exactly one selected label kept; y = 1
    for the first label, 0 otherwise (reference uses -1 for neg; our VFL
    consumers expect {0,1}). Party 0 = image features, party 1 = tags;
    n_parties > 2 splits the tag columns. Columns standardized like the
    reference's StandardScaler."""
    import glob as _glob

    label_files = sorted(_glob.glob(os.path.join(
        data_dir, "Groundtruth", "TrainTestLabels", f"Labels_*_{dtype}.txt")))
    if not label_files:
        raise FileNotFoundError(f"{data_dir}: no TrainTestLabels for {dtype}")
    counts = {}
    columns = {}
    for path in label_files:
        label = os.path.basename(path)[len("Labels_"):-(len(dtype) + 5)]
        col = np.loadtxt(path, dtype=np.int64, max_rows=max_rows)
        columns[label] = col
        counts[label] = int(col.sum())
    selected = [lbl for lbl, _ in sorted(counts.items(), key=lambda kv: -kv[1])[:top_k]]
    lab = np.stack([columns[lbl] for lbl in selected], axis=1)
    mask = lab.sum(axis=1) == 1 if len(selected) > 1 else np.ones(len(lab), bool)

    feat_files = sorted(_glob.glob(os.path.join(
        data_dir, "Low_Level_Features", f"{dtype}_Normalized_*.dat")))
    if not feat_files:
        raise FileNotFoundError(f"{data_dir}: no {dtype}_Normalized_*.dat features")
    xa = np.concatenate([_read_space_dat(p, max_rows=max_rows) for p in feat_files], axis=1)
    tags_path = os.path.join(data_dir, "NUS_WID_Tags", f"{dtype}_Tags1k.dat")
    xb = _read_space_dat(tags_path, sep="\t", max_rows=max_rows)

    n = min(len(xa), len(xb), len(lab))
    xa, xb, lab, mask = xa[:n], xb[:n], lab[:n], mask[:n]
    xa, xb, lab = xa[mask], xb[mask], lab[mask]
    y = (lab[:, 0] == 1).astype(np.int64)

    def standardize(m):
        std = m.std(axis=0)
        std[std == 0] = 1.0
        return ((m - m.mean(axis=0)) / std).astype(np.float32)

    xa, xb = standardize(xa), standardize(xb)
    if n_parties <= 2:
        xs = [xa, xb][:max(1, n_parties)]
    else:
        xs = [xa] + [np.ascontiguousarray(part)
                     for part in np.array_split(xb, n_parties - 1, axis=1)]
    log.info("dataset nus_wide: parsed NATIVE files from %s (%d rows, labels %s)",
             data_dir, len(y), selected)
    return xs, y


def load_nus_wide_vertical(cache_dir: str, n_parties: int = 2, seed: int = 0, n: int = 4000):
    """NUS-WIDE style vertical-FL source (reference: data/NUS_WIDE/
    nus_wide_dataset.py feeds classical_vertical_fl): the SAME samples'
    features split across parties (image features vs text tags). Returns
    (party_xs: list of [n, d_i], y [n] binary)."""
    party_dims = [634, 1000] + [128] * max(0, n_parties - 2)
    party_dims = party_dims[:n_parties]
    path = os.path.join(cache_dir or "", "nus_wide.npz")
    if cache_dir and os.path.exists(path):
        with np.load(path) as z:
            xs = [z[f"x{i}"].astype(np.float32) for i in range(n_parties)]
            return xs, z["y"].astype(np.int64)
    native = os.path.join(cache_dir or "", "nus_wide")
    if cache_dir and os.path.isdir(os.path.join(native, "Groundtruth")):
        try:
            return load_nus_wide_files(native, n_parties)
        except (OSError, ValueError) as e:
            log.warning("nus_wide: native files unreadable (%r) — falling back "
                        "to surrogate", e)
    log.warning("dataset nus_wide: no local file — synthetic vertical surrogate")
    rng = np.random.default_rng(seed)
    latent = rng.normal(0, 1, (n, 16)).astype(np.float32)
    y = (latent @ rng.normal(0, 1, 16) > 0).astype(np.int64)
    xs = []
    for i, d in enumerate(party_dims):
        proj = rng.normal(0, 1, (16, d)).astype(np.float32)
        xs.append((latent @ proj + 0.5 * rng.normal(0, 1, (n, d))).astype(np.float32))
    return xs, y
