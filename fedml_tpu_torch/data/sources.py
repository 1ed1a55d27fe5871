"""Raw dataset sources: the numpy part of ``fedml_tpu/data/sources.py``.

The JAX package looks for a dataset's files under ``data_cache_dir`` and
otherwise synthesises a deterministic surrogate with the real dataset's
shapes and class count (class-dependent means, so accuracy means
something). The port copies the surrogates, the ``{cache}/{name}.npz``
branch and the tabular CSV readers (lending club's ``loan.csv``, UCI's
SUSY and room-occupancy files) bit for bit; the native formats (CIFAR batch
pickles, idx-ubyte, image folders, LEAF json and TFF h5 files) and
downloads raise NotImplementedError, so a run never falls back to a
surrogate where the JAX package would have read real files (ROADMAP.md,
Queue 1). :func:`reference_format_files` is the JAX loader's probe for the
LEAF/TFF/SBD layouts (``fedml_tpu/data/formats.py`` ``detect_format_files``).
"""

from __future__ import annotations

import glob
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


# --- reference-format files the port cannot read yet ---------------------------------

def _reddit_txt_files(data_dir: str, split: str):
    """One ``.txt`` per user: ``{d}/{split}/*.txt`` or, for train, ``{d}/*.txt``."""
    for d in [os.path.join(data_dir, split)] + ([data_dir] if split == "train" else []):
        files = sorted(glob.glob(os.path.join(d, "*.txt")))
        if files:
            return files
    return []


def reference_format_files(dataset: str, cache: str) -> Optional[str]:
    """The JAX loader's probe for the text, FedNLP, stackoverflow_lr and
    segmentation datasets: ``dataset`` when its LEAF json, TFF h5, FedNLP h5,
    reddit text or segmentation layout sits under ``{cache}/{dataset}``, the
    files the JAX package reads in place of the surrogate; else None."""
    if not cache:
        return None
    d = os.path.join(cache, dataset)
    has = os.path.exists
    checks = {
        "shakespeare": lambda: os.path.isdir(os.path.join(d, "train")),
        "fed_shakespeare": lambda: has(os.path.join(d, "shakespeare_train.h5")),
        "stackoverflow_nwp": lambda: has(os.path.join(d, "stackoverflow_train.h5")),
        "stackoverflow_lr": lambda: all(
            has(os.path.join(d, f))
            for f in ("stackoverflow_train.h5", "stackoverflow.word_count",
                      "stackoverflow.tag_count")),
        **{name: (lambda name=name: has(os.path.join(d, f"{name}_data.h5"))
                  and has(os.path.join(d, f"{name}_partition.h5")))
           for name in ("20news", "agnews", "sst2", "semeval_2010_task8")},
        "reddit": lambda: bool(_reddit_txt_files(d, "train")),
        "pascal_voc": lambda: (has(os.path.join(d, "dataset", "train.txt"))
                               and os.path.isdir(os.path.join(d, "dataset", "img"))
                               and os.path.isdir(os.path.join(d, "dataset", "cls"))),
        "cityscapes": lambda: (os.path.isdir(os.path.join(d, "leftImg8bit", "train"))
                               and (os.path.isdir(os.path.join(d, "gtFine"))
                                    or os.path.isdir(os.path.join(d, "gtCoarse")))),
        "coco_seg": lambda: any(
            has(os.path.join(d, y, "annotations", f"instances_train{y}.json"))
            and os.path.isdir(os.path.join(d, y, f"train{y}")) for y in ("2017", "2014")),
    }
    fn = checks.get(dataset)
    try:
        return dataset if fn and fn() else None
    except OSError:
        return None


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
