"""Parsers for the reference's on-disk federated dataset formats: a copy of
``fedml_tpu/data/formats.py`` (numpy only), so one drop of files loads into
bit-identical client shards in both packages.

Reference: ``data/data_loader.py:247`` dispatches per-dataset loaders that
consume downloaded files. Nothing is downloaded here; given the same local
files, these parsers read them and return the file's own client partition
(not a synthetic Dirichlet split):

  - LEAF json (MNIST/FeMNIST/shakespeare LEAF style,
    ``data/MNIST/data_loader.py:32`` read_data): ``{train,test}`` dirs of
    .json files with keys users / num_samples / user_data{uid: {x, y}}.
  - TFF h5 (``data/fed_shakespeare/data_loader.py``,
    ``data/fed_cifar100/data_loader.py``): ``examples/<client>/snippets`` or
    ``examples/<client>/{image,label}``.
  - TFF stackoverflow h5 (``data/stackoverflow_nwp/data_loader.py``,
    ``data/stackoverflow_lr/``), the FedNLP ``{name}_data.h5`` /
    ``{name}_partition.h5`` pair, the landmarks (gld23k) user csv, reddit's
    per-user text files, and the SBD (pascal_voc), cityscapes and COCO
    segmentation drops.

``h5py``, ``PIL`` and ``scipy.io`` are imported inside the readers, so the
module imports without them. Each loader returns ``(train_clients,
test_clients, class_num)`` where *_clients is ``{client_id: (x, y)}`` numpy
pairs.
"""

from __future__ import annotations

import json
import logging
import os
from collections import Counter, OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

ClientData = Dict[str, Tuple[np.ndarray, np.ndarray]]


class FedDataConfigError(ValueError):
    """The FILES are fine but the user's config cannot be satisfied (e.g.
    more clients requested than the file has users) — must surface to the
    user, never be mistaken for a corrupt drop and silently surrogated."""

# --- LEAF json ---------------------------------------------------------------


def _read_leaf_dir(data_dir: str, encode=None) -> ClientData:
    """Walk a LEAF split dir, merging users that span files. ``encode``
    maps one user_data record to (x, y) arrays; default: float features +
    int labels (MNIST/femnist layout)."""
    if encode is None:
        def encode(ud):
            return (np.asarray(ud["x"], dtype=np.float32),
                    np.asarray(ud["y"], dtype=np.int64))

    out: "OrderedDict[str, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
    files = sorted(f for f in os.listdir(data_dir) if f.endswith(".json"))
    if not files:
        raise FileNotFoundError(f"no LEAF .json files in {data_dir}")
    for fname in files:
        with open(os.path.join(data_dir, fname)) as f:
            doc = json.load(f)
        for uid in doc["users"]:
            x, y = encode(doc["user_data"][uid])
            if uid in out:  # users may span files
                px, py = out[uid]
                x, y = np.concatenate([px, x]), np.concatenate([py, y])
            out[uid] = (x, y)
    return out


def load_leaf_json(
    data_dir: str, *, image_shape: Optional[Tuple[int, ...]] = None
) -> Tuple[ClientData, ClientData, int]:
    """LEAF layout: ``{data_dir}/train/*.json`` + ``{data_dir}/test/*.json``.

    image_shape reshapes the flat feature rows (femnist: (28, 28, 1))."""
    train = _read_leaf_dir(os.path.join(data_dir, "train"))
    test = _read_leaf_dir(os.path.join(data_dir, "test"))
    if image_shape:
        train = {u: (x.reshape((-1,) + tuple(image_shape)), y) for u, (x, y) in train.items()}
        test = {u: (x.reshape((-1,) + tuple(image_shape)), y) for u, (x, y) in test.items()}
    classes = int(max(int(y.max()) for _, y in train.values() if len(y)) + 1)
    return train, test, classes


# --- TFF shakespeare (char LM) ----------------------------------------------

# vocab from the TFF text-generation tutorial (reference
# data/fed_shakespeare/utils.py CHAR_VOCAB; pad=0, bos/eos appended)
CHAR_VOCAB = list(
    "dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#'/37;?bfjnrvzBFJNRVZ\"&*.26:\naeimquyAEIMQUY]!%)-159\r"
)
SHAKESPEARE_SEQ_LEN = 80


def _char_table() -> Dict[str, int]:
    words = ["<pad>"] + CHAR_VOCAB + ["<bos>", "<eos>"]
    return {w: i for i, w in enumerate(words)}


def shakespeare_vocab_size() -> int:
    return len(_char_table()) + 1  # + oov bucket


def preprocess_snippets(snippets: List[str], seq_len: int = SHAKESPEARE_SEQ_LEN) -> np.ndarray:
    """bos + chars + eos, pad to multiples of seq_len+1, cut into rows
    (reference utils.preprocess)."""
    table = _char_table()
    oov = len(table)
    rows: List[List[int]] = []
    for sen in snippets:
        toks = [table["<bos>"]] + [table.get(c, oov) for c in sen] + [table["<eos>"]]
        if len(toks) % (seq_len + 1):
            toks += [table["<pad>"]] * ((-len(toks)) % (seq_len + 1))
        rows.extend(toks[i : i + seq_len + 1] for i in range(0, len(toks), seq_len + 1))
    return np.asarray(rows, np.int64)


def load_tff_shakespeare(
    data_dir: str,
    *,
    train_file: str = "shakespeare_train.h5",
    test_file: str = "shakespeare_test.h5",
) -> Tuple[ClientData, ClientData, int]:
    """x = seq[:-1], y = seq[1:] next-char prediction pairs per client."""
    import h5py

    def read(path: str) -> ClientData:
        out: "OrderedDict[str, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
        with h5py.File(path, "r") as h5:
            for cid in h5["examples"]:
                raw = [s.decode("utf8") for s in h5["examples"][cid]["snippets"][()]]
                seqs = preprocess_snippets(raw)
                if len(seqs):
                    out[cid] = (seqs[:, :-1], seqs[:, 1:])
        return out

    train = read(os.path.join(data_dir, train_file))
    test = read(os.path.join(data_dir, test_file))
    return train, test, shakespeare_vocab_size()


# --- TFF fed_cifar100 --------------------------------------------------------


def load_tff_cifar100(
    data_dir: str,
    *,
    train_file: str = "fed_cifar100_train.h5",
    test_file: str = "fed_cifar100_test.h5",
) -> Tuple[ClientData, ClientData, int]:
    import h5py

    def read(path: str) -> ClientData:
        out: "OrderedDict[str, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
        with h5py.File(path, "r") as h5:
            for cid in h5["examples"]:
                g = h5["examples"][cid]
                x = np.asarray(g["image"][()], np.float32) / 255.0
                y = np.asarray(g["label"][()], np.int64).reshape(-1)
                out[cid] = (x, y)
        return out

    return read(os.path.join(data_dir, train_file)), read(os.path.join(data_dir, test_file)), 100


# --- TFF stackoverflow (next-word prediction) --------------------------------


def build_stackoverflow_vocab(train_clients: Dict[str, List[str]], vocab_size: int = 10000) -> Dict[str, int]:
    """Top-N whitespace vocabulary (reference ships pre-built pickles; built
    from the data here so the pipeline is self-contained)."""
    counts: Counter = Counter()
    for sents in train_clients.values():
        for s in sents:
            counts.update(s.split())
    vocab = {"<pad>": 0, "<unk>": 1, "<bos>": 2, "<eos>": 3}
    for w, _ in counts.most_common(vocab_size - len(vocab)):
        vocab.setdefault(w, len(vocab))
    return vocab


def load_stackoverflow_nwp(
    data_dir: str,
    *,
    train_file: str = "stackoverflow_train.h5",
    test_file: str = "stackoverflow_test.h5",
    seq_len: int = 20,
    vocab_size: int = 10000,
    max_clients: Optional[int] = None,
) -> Tuple[ClientData, ClientData, int]:
    import h5py

    def read_raw(path: str) -> Dict[str, List[str]]:
        out: "OrderedDict[str, List[str]]" = OrderedDict()
        with h5py.File(path, "r") as h5:
            for i, cid in enumerate(h5["examples"]):
                if max_clients is not None and i >= max_clients:
                    break
                out[cid] = [s.decode("utf8") for s in h5["examples"][cid]["tokens"][()]]
        return out

    raw_train = read_raw(os.path.join(data_dir, train_file))
    raw_test = read_raw(os.path.join(data_dir, test_file))
    vocab = build_stackoverflow_vocab(raw_train, vocab_size)

    def encode(clients: Dict[str, List[str]]) -> ClientData:
        out: "OrderedDict[str, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
        for cid, sents in clients.items():
            rows = []
            for s in sents:
                ids = [vocab["<bos>"]] + [vocab.get(w, vocab["<unk>"]) for w in s.split()] + [vocab["<eos>"]]
                ids = ids[: seq_len + 1]
                ids += [vocab["<pad>"]] * (seq_len + 1 - len(ids))
                rows.append(ids)
            if rows:
                seqs = np.asarray(rows, np.int64)
                out[cid] = (seqs[:, :-1], seqs[:, 1:])
        return out

    return encode(raw_train), encode(raw_test), len(vocab)


# --- federated-tuple assembly ------------------------------------------------


def clients_to_fed_dataset(
    train: ClientData, test: ClientData, class_num: int, client_num: Optional[int] = None
):
    """Assemble the 8-tuple the runners consume, preserving the file's native
    client partition. When client_num < file clients, users are grouped
    round-robin (reference MNIST loader groups 1000 users into client_num)."""
    from .dataset import ArrayDataset

    uids = list(train.keys())
    n = client_num or len(uids)
    if n > len(uids):
        raise FedDataConfigError(
            f"client_num_in_total={n} exceeds the file's {len(uids)} users; "
            f"every client needs at least one user's data"
        )
    groups: List[List[str]] = [uids[i::n] for i in range(n)]

    train_local, test_local, train_num = {}, {}, {}
    for cid, members in enumerate(groups):
        xs = np.concatenate([train[u][0] for u in members])
        ys = np.concatenate([train[u][1] for u in members])
        train_local[cid] = ArrayDataset(xs, ys)
        train_num[cid] = len(xs)
        te = [test[u] for u in members if u in test]
        if te:
            test_local[cid] = ArrayDataset(
                np.concatenate([t[0] for t in te]), np.concatenate([t[1] for t in te])
            )
        else:
            test_local[cid] = ArrayDataset(xs[:1], ys[:1])
    train_g = ArrayDataset(
        np.concatenate([d.x for d in train_local.values()]),
        np.concatenate([d.y for d in train_local.values()]),
    )
    test_g = ArrayDataset(
        np.concatenate([d.x for d in test_local.values()]),
        np.concatenate([d.y for d in test_local.values()]),
    )
    return (len(train_g), len(test_g), train_g, test_g, train_num, train_local, test_local, class_num)


def detect_format_files(dataset: str, cache: str) -> Optional[str]:
    """Which real-format files exist for `dataset` under `cache`? Returns the
    loader key or None (surrogate fallback)."""
    if not cache:
        return None
    d = os.path.join(cache, dataset)
    checks = {
        "femnist": lambda: os.path.isdir(os.path.join(d, "train")),
        "mnist": lambda: os.path.isdir(os.path.join(d, "train")),
        "shakespeare": lambda: os.path.isdir(os.path.join(d, "train")),
        "fed_shakespeare": lambda: os.path.exists(os.path.join(d, "shakespeare_train.h5")),
        "fed_cifar100": lambda: os.path.exists(os.path.join(d, "fed_cifar100_train.h5")),
        "stackoverflow_nwp": lambda: os.path.exists(os.path.join(d, "stackoverflow_train.h5")),
        "stackoverflow_lr": lambda: all(
            os.path.exists(os.path.join(d, f))
            for f in ("stackoverflow_train.h5", "stackoverflow.word_count", "stackoverflow.tag_count")
        ),
        **{
            name: (lambda d=d, name=name: os.path.exists(os.path.join(d, f"{name}_data.h5"))
                   and os.path.exists(os.path.join(d, f"{name}_partition.h5")))
            for name in ("20news", "agnews", "sst2", "semeval_2010_task8")
        },
        **{
            name: (lambda d=d: _find_landmarks_csv(d, "train") is not None
                   and os.path.isdir(os.path.join(d, "images")))
            for name in ("landmarks", "gld23k")
        },
        "reddit": lambda: bool(_reddit_txt_files(d, "train")),
        # SBD benchmark drop (fedcv image_segmentation example layout)
        "pascal_voc": lambda: (
            os.path.exists(os.path.join(d, "dataset", "train.txt"))
            and os.path.isdir(os.path.join(d, "dataset", "img"))
            and os.path.isdir(os.path.join(d, "dataset", "cls"))
        ),
        "cityscapes": lambda: (
            os.path.isdir(os.path.join(d, "leftImg8bit", "train"))
            and (os.path.isdir(os.path.join(d, "gtFine"))
                 or os.path.isdir(os.path.join(d, "gtCoarse")))
        ),
        "coco_seg": lambda: any(
            os.path.exists(os.path.join(d, y, "annotations", f"instances_train{y}.json"))
            and os.path.isdir(os.path.join(d, y, f"train{y}"))
            for y in ("2017", "2014")
        ),
    }
    fn = checks.get(dataset)
    try:
        return dataset if fn and fn() else None
    except OSError:
        return None


def load_native_format(dataset: str, cache: str, client_num: Optional[int] = None,
                       partition_method: Optional[str] = None,
                       partition_alpha: Optional[float] = None, seed: int = 0):
    """Load `dataset` from its reference-format files under ``{cache}/{dataset}``.

    ``partition_alpha``/``seed`` reach the loaders that partition at parse
    time (pascal_voc has no natural users); loaders with a file-native
    client split ignore them."""
    d = os.path.join(cache, dataset)
    if dataset in ("femnist", "mnist"):
        shape = (28, 28, 1) if dataset == "femnist" else None
        train, test, classes = load_leaf_json(d, image_shape=shape)
    elif dataset == "shakespeare":
        train, test, classes = load_leaf_shakespeare(d)
    elif dataset == "fed_shakespeare":
        train, test, classes = load_tff_shakespeare(d)
    elif dataset == "fed_cifar100":
        train, test, classes = load_tff_cifar100(d)
    elif dataset == "stackoverflow_nwp":
        train, test, classes = load_stackoverflow_nwp(d)
    elif dataset == "stackoverflow_lr":
        train, test, classes = load_stackoverflow_lr_h5(d)
    elif dataset in ("20news", "agnews", "sst2", "semeval_2010_task8"):
        train, test, classes = load_fednlp_text_clf(d, dataset, partition_method=partition_method)
    elif dataset in ("landmarks", "gld23k"):
        train, test, classes = load_landmarks_csv(d)
    elif dataset == "reddit":
        train, test, classes = load_reddit_text_dir(d)
    elif dataset == "pascal_voc":
        # partitioned at parse time (no natural users in an SBD drop):
        # one "user" per dirichlet shard sized to the requested client count
        train, test, classes = load_pascal_voc_dir(
            d, n_clients=client_num,
            alpha=partition_alpha if partition_alpha is not None else 0.5,
            seed=seed)
    elif dataset == "cityscapes":
        gt = "gtFine" if os.path.isdir(os.path.join(d, "gtFine")) else "gtCoarse"
        train, test, classes = load_cityscapes_dir(d, n_clients=client_num,
                                                   annotation_type=gt)
    elif dataset == "coco_seg":
        train, test, classes = load_coco_seg_dir(
            d, n_clients=client_num,
            alpha=partition_alpha if partition_alpha is not None else 0.5,
            seed=seed)
    else:
        raise ValueError(f"no native-format loader for {dataset!r}")
    log.info("dataset %s: loaded NATIVE format files from %s (%d clients)", dataset, d, len(train))
    return clients_to_fed_dataset(train, test, classes, client_num)


# --- TFF stackoverflow tag-prediction (stackoverflow_lr) ---------------------

SO_LR_VOCAB = 10000
SO_LR_TAGS = 500


def _read_word_count(path: str, vocab_size: int) -> "OrderedDict[str, int]":
    """``stackoverflow.word_count``: one "word count" line per word, already
    frequency-sorted (reference stackoverflow_lr/utils.py:35-39 takes the
    first `vocab_size` lines)."""
    out: "OrderedDict[str, int]" = OrderedDict()
    with open(path) as f:
        for i, line in enumerate(f):
            if i >= vocab_size:
                break
            out[line.split()[0]] = i
    return out


def _read_tag_count(path: str, tag_size: int) -> "OrderedDict[str, int]":
    """``stackoverflow.tag_count``: a JSON dict whose first `tag_size` keys
    are the kept tags (reference utils.py:42-45)."""
    with open(path) as f:
        tags = json.load(f)
    return OrderedDict((t, i) for i, t in enumerate(list(tags)[:tag_size]))


def load_stackoverflow_lr_h5(
    data_dir: str, vocab_size: int = SO_LR_VOCAB, tag_size: int = SO_LR_TAGS,
    max_clients: int = 1000,
) -> Tuple[ClientData, ClientData, int]:
    """StackOverflow tag prediction from the reference's own on-disk trio:
    ``stackoverflow_{train,test}.h5`` (TFF layout:
    ``examples/<client>/{tokens,tags}``) + ``stackoverflow.word_count`` +
    ``stackoverflow.tag_count``.

    Feature/label math matches ``data/stackoverflow_lr/utils.py`` exactly:
    input = mean of per-token one-hots over (vocab+1) with OOV in the
    denominator, sliced to [:vocab]; target = SUM of tag one-hots sliced to
    [:tag_size] (multi-hot float). Reference dataset/model:
    ``data_loader.py:23`` + LogisticRegression(10000, 500)."""
    import h5py

    words = _read_word_count(os.path.join(data_dir, "stackoverflow.word_count"), vocab_size)
    tags = _read_tag_count(os.path.join(data_dir, "stackoverflow.tag_count"), tag_size)
    # sidecar files shorter than the requested caps shrink the feature/label
    # spaces (the reference indexes through the same dicts, utils.py:49-66)
    vocab_size = len(words)
    tag_size = len(tags)

    def encode_client(g) -> Tuple[np.ndarray, np.ndarray]:
        sent_rows, tag_rows = [], []
        raw_tokens = [t.decode("utf-8") for t in g["tokens"][()]]
        raw_tags = [t.decode("utf-8") for t in g["tags"][()]]
        for sentence, tagstr in zip(raw_tokens, raw_tags):
            toks = sentence.split(" ")
            ids = np.fromiter((words.get(t, vocab_size) for t in toks), np.int64, len(toks))
            counts = np.bincount(ids, minlength=vocab_size + 1).astype(np.float32)
            sent_rows.append((counts / max(len(toks), 1))[:vocab_size])
            tids = [tags.get(t, tag_size) for t in tagstr.split("|")]
            y = np.zeros(tag_size + 1, np.float32)
            for t in tids:
                y[t] += 1.0  # reference SUMS one-hots (duplicate tags add)
            tag_rows.append(y[:tag_size])
        return np.stack(sent_rows), np.stack(tag_rows)

    def read(path: str) -> ClientData:
        # the real TFF archive has ~342k train clients whose dense BoW rows
        # would not fit host memory; cap the client count (NOT silently —
        # logged below) the way reference experiments subsample silos
        out: "OrderedDict[str, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
        with h5py.File(path, "r") as f:
            cids = list(f["examples"])
            if len(cids) > max_clients:
                log.warning(
                    "stackoverflow_lr: capping %d clients in %s to max_clients=%d "
                    "(dense BoW rows for every client would not fit memory; raise "
                    "max_clients to widen)", len(cids), path, max_clients,
                )
                cids = cids[:max_clients]
            for cid in cids:
                out[cid] = encode_client(f["examples"][cid])
        return out

    train = read(os.path.join(data_dir, "stackoverflow_train.h5"))
    test = read(os.path.join(data_dir, "stackoverflow_test.h5"))
    return train, test, tag_size


# --- FedNLP text classification h5 (20news et al.) ---------------------------

FEDNLP_SEQ_LEN = 128
FEDNLP_HASH_VOCAB = 30000


def _hash_tokenize(text: str, seq_len: int, vocab: int) -> np.ndarray:
    """Deterministic hash-vocab tokenizer: whitespace split, crc32 into
    [1, vocab), zero-pad/truncate. The reference pipeline tokenizes with the
    model's HF tokenizer (DistilBERT for BASELINE config 3); a hash vocab is
    the model-free equivalent that keeps the parser self-contained."""
    import zlib

    ids = np.zeros(seq_len, np.int64)
    for i, tok in enumerate(text.split()[:seq_len]):
        ids[i] = zlib.crc32(tok.lower().encode()) % (vocab - 1) + 1
    return ids


def load_fednlp_text_clf(
    data_dir: str,
    name: str,
    *,
    seq_len: int = FEDNLP_SEQ_LEN,
    vocab: int = FEDNLP_HASH_VOCAB,
    partition_method: Optional[str] = None,
) -> Tuple[ClientData, ClientData, int]:
    """FedNLP text-classification pair ``<name>_data.h5`` +
    ``<name>_partition.h5`` (reference layout:
    ``fednlp/base/data_manager/base_data_manager.py:106-126`` — data file
    has ``X/<idx>`` utf-8 text and ``Y/<idx>`` label strings; partition file
    has ``<method>/partition_data/<client>/{train,test}`` index arrays and
    ``<method>/n_clients``; instance decode per
    ``text_classification_data_manager.py:19-25``)."""
    import h5py

    data_path = os.path.join(data_dir, f"{name}_data.h5")
    part_path = os.path.join(data_dir, f"{name}_partition.h5")
    with h5py.File(data_path, "r") as df, h5py.File(part_path, "r") as pf:
        methods = list(pf.keys())
        # real FedNLP partition files carry several method groups (uniform +
        # kmeans/niid variants); alphabetical-first would silently pick a
        # skewed niid split, so default to 'uniform' when present and LOG
        # the choice either way
        if partition_method:
            method = partition_method
        elif "uniform" in methods:
            method = "uniform"
        else:
            method = methods[0]
        log.info("fednlp %s: partition method %r (available: %s)", name, method, methods)
        if method not in pf:
            raise KeyError(f"partition method {method!r} not in {methods}")
        labels = sorted({df["Y"][k][()].decode("utf-8") for k in df["Y"]})
        label_id = {s: i for i, s in enumerate(labels)}

        def gather(idxs) -> Tuple[np.ndarray, np.ndarray]:
            xs = np.stack(
                [_hash_tokenize(df["X"][str(i)][()].decode("utf-8"), seq_len, vocab) for i in idxs]
            ) if len(idxs) else np.zeros((0, seq_len), np.int64)
            ys = np.asarray(
                [label_id[df["Y"][str(i)][()].decode("utf-8")] for i in idxs], np.int64
            )
            return xs, ys

        train: "OrderedDict[str, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
        test: "OrderedDict[str, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
        part = pf[method]["partition_data"]
        for cid in sorted(part.keys(), key=lambda s: int(s) if s.isdigit() else s):
            train[cid] = gather(part[cid]["train"][()])
            test[cid] = gather(part[cid]["test"][()])
    return train, test, len(labels)


# --- LEAF shakespeare (string features) --------------------------------------


def load_leaf_shakespeare(data_dir: str) -> Tuple[ClientData, ClientData, int]:
    """LEAF shakespeare json: ``user_data[uid].x`` is a list of 80-char
    context strings and ``.y`` the single next character (reference
    ``data/shakespeare/language_utils.py`` word_to_indices/letter_to_index
    over the same CHAR_VOCAB table this module uses for the TFF variant).
    Encodes to next-char SEQ-TO-SEQ pairs — x = chars[:-1], y = chars[1:]
    of the 81-char (context + next char) window — the same [N, 80]/[N, 80]
    convention our TFF fed_shakespeare loader and RNN/LM models use
    (per-timestep logits; a [N] single-label y would not match their
    [B, T, V] output). class_num is the shared shakespeare vocab size.
    Zero-sample users (possible in LEAF split shards) yield well-shaped
    (0, seq) arrays so cross-file merges still concatenate."""
    table = _char_table()
    oov = len(table)

    def encode(ud):
        rows = [
            [table.get(c, oov) for c in ctx] + [table.get(nxt[0], oov)]
            for ctx, nxt in zip(ud["x"], ud["y"])
        ]
        seq = (len(rows[0]) - 1) if rows else 80
        full = np.asarray(rows, np.int64).reshape(-1, seq + 1)
        return full[:, :-1], full[:, 1:]

    train = _read_leaf_dir(os.path.join(data_dir, "train"), encode)
    test = _read_leaf_dir(os.path.join(data_dir, "test"), encode)
    return train, test, shakespeare_vocab_size()

# --- Google Landmarks (gld23k/gld160k) user-split csv + images ----------------

def _find_landmarks_csv(d: str, split: str) -> Optional[str]:
    """The reference's mapping files live at
    ``data_user_dict/gld{23k,160k}_user_dict_{train,test}.csv``
    (reference Landmarks data_loader.py:329-340); accept them at the dataset
    root too for hand-placed drops."""
    for sub in ("data_user_dict", "."):
        for scale in ("23k", "160k"):
            p = os.path.join(d, sub, f"gld{scale}_user_dict_{split}.csv")
            if os.path.exists(p):
                return p
    return None


def load_landmarks_csv(
    data_dir: str, image_size: Tuple[int, int] = (64, 64),
    max_per_user: Optional[int] = None,
) -> Tuple[ClientData, ClientData, int]:
    """Google Landmarks from the reference's own on-disk pair: a
    ``user_id,image_id,class`` mapping csv (the file's NATIVE per-user
    federation — reference Landmarks data_loader.py:123-151 builds
    mapping_per_user from exactly these columns) + ``images/<image_id>.jpg``
    (datasets.py:48-51). Images resized to ``image_size``; rows whose jpg is
    missing are skipped with a count so a partial image drop still trains.
    ``max_per_user`` bounds host RAM (arrays are in-memory, unlike the
    reference's lazy ImageFolder); defaults to FEDML_MAX_IMAGES_PER_USER
    (200), truncation is counted and logged."""
    import csv as _csv

    from PIL import Image

    if max_per_user is None:
        max_per_user = int(os.environ.get("FEDML_MAX_IMAGES_PER_USER", 200))
    train_csv = _find_landmarks_csv(data_dir, "train")
    if train_csv is None:
        raise FileNotFoundError(f"{data_dir}: no gld user_dict train csv")
    test_csv = _find_landmarks_csv(data_dir, "test")
    images_dir = os.path.join(data_dir, "images")

    def read(path: str, per_user_cap: Optional[int]) -> Tuple[ClientData, int]:
        rows_per_user: Dict[str, List[Tuple[str, int]]] = {}
        max_class = -1
        with open(path) as f:
            for row in _csv.DictReader(f):
                cls = int(row["class"])
                max_class = max(max_class, cls)
                rows_per_user.setdefault(row["user_id"], []).append((row["image_id"], cls))
        out: ClientData = {}
        missing = truncated = 0
        for uid, rows in rows_per_user.items():
            if per_user_cap and len(rows) > per_user_cap:
                truncated += len(rows) - per_user_cap
                rows = rows[:per_user_cap]
            xs: List[np.ndarray] = []
            ys: List[int] = []
            for image_id, cls in rows:
                p = os.path.join(images_dir, f"{image_id}.jpg")
                if not os.path.exists(p):
                    missing += 1
                    continue
                img = Image.open(p).convert("RGB")
                if img.size != image_size:
                    img = img.resize(image_size)
                xs.append(np.asarray(img, np.uint8))
                ys.append(cls)
            if xs:
                out[uid] = (np.stack(xs).astype(np.float32) / 255.0,
                            np.asarray(ys, np.int64))
        if missing:
            log.warning("landmarks: %d mapping rows had no jpg under %s (skipped)",
                        missing, images_dir)
        if truncated:
            log.warning("landmarks: capped at %d images/user (%d rows skipped) — "
                        "raise FEDML_MAX_IMAGES_PER_USER to parse more",
                        per_user_cap, truncated)
        return out, max_class + 1

    train, n_train_classes = read(train_csv, max_per_user)
    if test_csv:
        test, n_test_classes = read(test_csv, max_per_user)
    else:
        test, n_test_classes = {}, 0
    if not train:
        raise FileNotFoundError(f"{data_dir}: mapping csv present but no images resolved")
    return train, test, max(n_train_classes, n_test_classes)


# --- reddit: per-user text files -> blocked LM examples -----------------------

REDDIT_SEQ_LEN = 64


def _reddit_txt_files(data_dir: str, split: str) -> List[str]:
    """One ``.txt`` file per user (the reference enumerates a directory of
    user files and bumps user_id per non-empty file —
    ``data/reddit/nlp.py:53-71``). Accept ``{d}/{split}/*.txt`` or, for
    train, a flat ``{d}/*.txt`` drop."""
    import glob as _glob

    for d in ([os.path.join(data_dir, split)] + ([data_dir] if split == "train" else [])):
        files = sorted(_glob.glob(os.path.join(d, "*.txt")))
        if files:
            return files
    return []


def load_reddit_text_dir(
    data_dir: str, seq_len: int = REDDIT_SEQ_LEN, vocab_size: Optional[int] = None,
    max_users: Optional[int] = None, bpe_sample_bytes: int = 1 << 19,
) -> Tuple[ClientData, ClientData, int]:
    """Reddit LM corpus from a directory of per-user text files, blocked into
    fixed-length next-token examples with a per-user federation — the
    reference's exact structure (``data/reddit/nlp.py:53-71``: tokenize each
    user file, truncate in blocks, client_mapping per user). Difference,
    recorded here: the reference tokenizes with a PRETRAINED Albert subword
    vocab fetched from the hub; zero egress makes that impossible, so a
    byte-level BPE is trained ON the corpus itself (train/llm/tokenizer.py)
    — deterministic, self-contained, same id-space contract (class_num =
    vocab size). Users with fewer than seq_len+1 tokens yield no blocks,
    exactly like the reference's ``len(tokenized_text) - block_size + 1``
    guard."""
    from ..train.llm.tokenizer import train_bpe

    if vocab_size is None:
        vocab_size = int(os.environ.get("FEDML_REDDIT_VOCAB", 2048))
    if max_users is None:
        max_users = int(os.environ.get("FEDML_REDDIT_MAX_USERS", 1000))

    train_files = _reddit_txt_files(data_dir, "train")
    if not train_files:
        raise FileNotFoundError(f"{data_dir}: no per-user .txt files")
    test_files = _reddit_txt_files(data_dir, "test")
    if len(train_files) > max_users:
        log.warning("reddit: capped at %d of %d user files — raise "
                    "FEDML_REDDIT_MAX_USERS to parse more", max_users, len(train_files))
        train_files = train_files[:max_users]
    test_files = test_files[:max_users]

    def read_texts(files: List[str]) -> Dict[str, str]:
        out = {}
        for path in files:
            with open(path, encoding="utf-8", errors="ignore") as f:
                text = f.read().strip()
            if text:
                out[os.path.splitext(os.path.basename(path))[0]] = text
        return out

    train_texts = read_texts(train_files)
    test_texts = read_texts(test_files)
    if not train_texts:
        raise ValueError(f"{data_dir}: user files are all empty")

    # BPE training cost is linear in sample size x vocab; a bounded sample
    # keeps huge corpora loadable (the tokenizer only needs representative
    # frequencies, not every byte)
    sample, budget = [], bpe_sample_bytes
    for text in train_texts.values():
        sample.append(text[: max(0, budget)])
        budget -= len(text)
        if budget <= 0:
            break
    tok = train_bpe(sample, vocab_size=vocab_size)
    vocab = tok.vocab_size

    def blocked(texts: Dict[str, str]) -> ClientData:
        out: ClientData = {}
        for uid, text in texts.items():
            ids = tok.encode(text)
            n_blocks = (len(ids) - 1) // seq_len
            if n_blocks <= 0:
                continue
            arr = np.asarray(ids[: n_blocks * seq_len + 1], np.int64)
            x = arr[: n_blocks * seq_len].reshape(n_blocks, seq_len)
            y = arr[1: n_blocks * seq_len + 1].reshape(n_blocks, seq_len)
            out[uid] = (x, y)
        return out

    train = blocked(train_texts)
    test = blocked(test_texts)
    if not train:
        raise ValueError(f"{data_dir}: no user has >= {seq_len + 1} tokens")
    if not test:
        # no test/ drop: hold out each user's last block (their newest text,
        # mirroring a temporal split)
        test = {}
        for uid, (x, y) in list(train.items()):
            if len(x) > 1:
                test[uid] = (x[-1:], y[-1:])
                train[uid] = (x[:-1], y[:-1])
        if not test:
            # every user has exactly one block: an empty test split would
            # crash downstream on an empty concatenate and get misreported
            # as "unparseable" (ADVICE r4) — share the first user's single
            # block as eval data instead of dropping the corpus
            uid = next(iter(train))
            x, y = train[uid]
            test[uid] = (x[-1:], y[-1:])
            log.warning(
                "dataset reddit: corpus too small for a held-out split "
                "(every user has one block); reusing %s's block for eval", uid)
    log.info("dataset reddit: %d users, %d train blocks, vocab %d (corpus-trained BPE)",
             len(train), sum(len(x) for x, _ in train.values()), vocab)
    return train, test, vocab


# --- Pascal-VOC-augmented segmentation (FedSeg family) -----------------------

PASCAL_VOC_CLASSES = 21  # background + 20 object categories (SBD benchmark)


def load_pascal_voc_dir(root: str, n_clients: Optional[int] = None,
                        image_hw: int = 64, alpha: float = 0.5,
                        seed: int = 0) -> Tuple[ClientData, ClientData, int]:
    """Pascal-VOC-augmented (SBD benchmark) layout, as the reference's
    fedseg example consumes it (``examples/federate/prebuilt_jobs/fedcv/
    image_segmentation/data/pascal_voc_augmented/dataset.py:33-106``):

        {root}/dataset/img/<id>.jpg      RGB images
        {root}/dataset/cls/<id>.mat      scipy .mat, GTcls struct with
                                         .Segmentation (HxW class mask) and
                                         .CategoriesPresent
        {root}/dataset/train.txt         one image id per line
        {root}/dataset/val.txt           eval split (optional)

    Images are resized bilinearly (masks NEAREST — interpolating class ids
    would invent phantom classes on boundaries) to ``image_hw`` so batches
    are static-shaped for XLA. The federated split mirrors the reference's
    data_loader.py partition_data: Dirichlet(alpha) over each image's FIRST
    present category. Without a val.txt, every client shares a small
    held-out tail of train as eval data.
    """
    import scipy.io as sio
    from PIL import Image

    base = os.path.join(root, "dataset")

    def read_ids(name: str) -> List[str]:
        p = os.path.join(base, f"{name}.txt")
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return [ln.strip() for ln in f if ln.strip()]

    def load_split(ids: List[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        xs, ys, first_cat = [], [], []
        for iid in ids:
            img_p = os.path.join(base, "img", f"{iid}.jpg")
            mat_p = os.path.join(base, "cls", f"{iid}.mat")
            img = Image.open(img_p).convert("RGB").resize(
                (image_hw, image_hw), Image.BILINEAR)
            mat = sio.loadmat(mat_p, mat_dtype=True, squeeze_me=True,
                              struct_as_record=False)
            gtcls = mat["GTcls"]
            mask_full = np.asarray(gtcls.Segmentation, np.uint8)
            mask = np.asarray(Image.fromarray(mask_full).resize(
                (image_hw, image_hw), Image.NEAREST))
            xs.append(np.asarray(img, np.float32) / 255.0)
            ys.append(mask.astype(np.int32))
            # partition label from the mat's own CategoriesPresent (the
            # reference's targets, dataset.py:88-102) — NOT the downsampled
            # mask, where a small object can vanish under NEAREST and
            # mislabel the image as background
            cats = np.atleast_1d(np.asarray(
                getattr(gtcls, "CategoriesPresent", []), np.int64)).ravel()
            if not len(cats):
                full = np.unique(mask_full)
                cats = full[full > 0]
            first_cat.append(int(cats[0]) if len(cats) else 0)
        return (np.stack(xs), np.stack(ys), np.asarray(first_cat, np.int64))

    train_ids = read_ids("train")
    if not train_ids:
        raise ValueError(f"{base}: train.txt is missing or empty")
    x_tr, y_tr, cats_tr = load_split(train_ids)
    val_ids = read_ids("val")
    x_te = y_te = None
    if val_ids:
        x_te, y_te, _ = load_split(val_ids)
    train, test = _dirichlet_seg_federation(
        x_tr, y_tr, cats_tr, x_te, y_te, n_clients,
        PASCAL_VOC_CLASSES, alpha, seed, "pascal_voc")
    return train, test, PASCAL_VOC_CLASSES


def _dirichlet_seg_federation(x_tr, y_tr, cats_tr, x_te, y_te,
                              n_clients: Optional[int], classes: int,
                              alpha: float, seed: int, dataset: str):
    """Shared federation tail for seg drops with no natural users
    (pascal_voc, coco_seg): optional tail holdout when no val split exists,
    Dirichlet(alpha) over first-present category, and a val split
    PARTITIONED round-robin — handing every client the full val set would
    replicate it client_num times in memory and inflate the global test
    count by the same factor."""
    from ..core.data.noniid_partition import (
        non_iid_partition_with_dirichlet_distribution,
    )

    if x_te is None:
        # hold out a tail of train for eval
        n_te = max(1, len(x_tr) // 10)
        x_te, y_te = x_tr[-n_te:], y_tr[-n_te:]
        x_tr, y_tr, cats_tr = x_tr[:-n_te], y_tr[:-n_te], cats_tr[:-n_te]
    n = n_clients or 4
    if n > len(x_tr):
        # surfaced here (not after a wasted full parse + partition): the
        # dirichlet split needs >=1 image per client, and downstream
        # clients_to_fed_dataset enforces the same bound anyway
        raise FedDataConfigError(
            f"client_num_in_total={n} exceeds the drop's {len(x_tr)} train "
            "images; every client needs at least one image")
    net_map = non_iid_partition_with_dirichlet_distribution(
        cats_tr, n, classes, alpha, seed)
    train: ClientData = {}
    test: ClientData = {}
    for cid, idx in net_map.items():
        idx = np.asarray(idx, np.int64)
        train[f"client_{cid:03d}"] = (x_tr[idx], y_tr[idx])
        te_idx = np.arange(cid, len(x_te), n)
        if not len(te_idx):
            te_idx = np.asarray([cid % len(x_te)])
        test[f"client_{cid:03d}"] = (x_te[te_idx], y_te[te_idx])
    log.info("dataset %s: %d train / %d eval images -> %d clients "
             "(dirichlet alpha=%.2f over first-category)",
             dataset, len(x_tr), len(x_te), len(train), alpha)
    return train, test


# --- Cityscapes segmentation (FedSeg family) ---------------------------------

CITYSCAPES_CLASSES = 19  # trainId classes; everything else -> 255 (ignored)

# labelId -> trainId (reference fedcv cityscapes/dataset.py id_to_train_id;
# 255 = void/ignore, masked out of the loss and the confusion matrix)
_CITYSCAPES_ID_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}


def load_cityscapes_dir(root: str, n_clients: Optional[int] = None,
                        image_hw: int = 64,
                        annotation_type: str = "gtFine",
                        ) -> Tuple[ClientData, ClientData, int]:
    """Cityscapes layout as the reference's fedcv example consumes it
    (``examples/federate/prebuilt_jobs/fedcv/image_segmentation/data/
    cityscapes/dataset.py:24-60``):

        {root}/leftImg8bit/{split}/{city}/<id>_leftImg8bit.png
        {root}/{gtFine|gtCoarse}/{split}/{city}/<id>_{type}_labelIds.png

    labelIds are mapped to the 19 trainId classes (everything else -> 255,
    the void label the loss must ignore — ``seg_ignore_label``). The
    federation is per-CITY: cities are the natural clients of a cityscapes
    deployment (one municipality's cameras per silo), giving a real non-IID
    split where the reference synthesizes one with Dirichlet. ``n_clients``
    regrouping happens downstream (clients_to_fed_dataset round-robins
    cities). val/ becomes the shared eval pool, partitioned round-robin.
    """
    from PIL import Image

    lut = np.full(256, 255, np.uint8)
    for label_id, train_id in _CITYSCAPES_ID_TO_TRAIN.items():
        lut[label_id] = train_id

    def load_split(split: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        img_root = os.path.join(root, "leftImg8bit", split)
        mask_root = os.path.join(root, annotation_type, split)
        if not os.path.isdir(img_root):
            return {}
        out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for city in sorted(os.listdir(img_root)):
            city_dir = os.path.join(img_root, city)
            if not os.path.isdir(city_dir):
                continue
            xs, ys = [], []
            for fname in sorted(os.listdir(city_dir)):
                if not fname.endswith("_leftImg8bit.png"):
                    continue
                stem = fname[: -len("_leftImg8bit.png")]
                mask_p = os.path.join(
                    mask_root, city, f"{stem}_{annotation_type}_labelIds.png")
                if not os.path.exists(mask_p):
                    continue
                img = Image.open(os.path.join(city_dir, fname)).convert("RGB")
                img = img.resize((image_hw, image_hw), Image.BILINEAR)
                mask = np.asarray(Image.open(mask_p).resize(
                    (image_hw, image_hw), Image.NEAREST))
                xs.append(np.asarray(img, np.float32) / 255.0)
                ys.append(lut[mask].astype(np.int32))
            if xs:
                out[city] = (np.stack(xs), np.stack(ys))
        return out

    train = load_split("train")
    if not train:
        raise ValueError(
            f"{root}: no leftImg8bit/train/<city>/*_leftImg8bit.png with "
            f"matching {annotation_type} labelIds masks")
    val = load_split("val")
    if val:
        # shared eval pool split round-robin across the train cities
        vx = np.concatenate([x for x, _ in val.values()])
        vy = np.concatenate([y for _, y in val.values()])
        cities = list(train)
        test = {c: (vx[i::len(cities)], vy[i::len(cities)])
                for i, c in enumerate(cities) if len(vx[i::len(cities)])}
    else:
        test = {}
        for city, (x, y) in list(train.items()):
            if len(x) > 1:
                test[city] = (x[-1:], y[-1:])
                train[city] = (x[:-1], y[:-1])
        if not test:
            city = next(iter(train))
            x, y = train[city]
            test[city] = (x[-1:], y[-1:])
    log.info("dataset cityscapes: %d cities (natural clients), %d train images",
             len(train), sum(len(x) for x, _ in train.values()))
    return train, test, CITYSCAPES_CLASSES


# --- COCO segmentation (FedSeg family) ---------------------------------------

# the reference's 20 VOC-style category names selected from COCO
# (fedcv coco/segmentation/dataset.py:58-80); class index = position + 1,
# background = 0. (The reference indexes classes AT position — making
# "airplane" collide with background; that is an evident off-by-one in its
# mask builder, not a semantic to reproduce.)
COCO_SEG_CATEGORIES = [
    "airplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "dining table", "dog", "horse", "motorcycle", "person",
    "potted plant", "sheep", "sofa", "tv", "train",
]
# official COCO names that differ from the VOC-style list: a real
# instances json says "couch", never "sofa" (the reference's getCatIds
# silently drops the class for the same reason — not a semantic to keep)
_COCO_NAME_ALIASES = {"couch": "sofa"}
COCO_SEG_CLASSES = len(COCO_SEG_CATEGORIES) + 1  # + background


def load_coco_seg_dir(root: str, n_clients: Optional[int] = None,
                      image_hw: int = 64, year: Optional[str] = None,
                      alpha: float = 0.5, seed: int = 0,
                      min_mask_pixels: int = 1000,
                      ) -> Tuple[ClientData, ClientData, int]:
    """COCO-instances layout as the reference's fedcv example consumes it
    (``fedcv/image_segmentation/data/coco/coco_base.py:38-62`` paths,
    ``segmentation/dataset.py:96-165`` mask building):

        {root}/{year}/annotations/instances_{split}{year}.json
        {root}/{year}/{split}{year}/*.jpg

    Masks are rasterized NATIVELY from the polygon annotations (PIL
    ImageDraw — no pycocotools dependency): first annotation wins where
    regions overlap (the reference's ``mask == 0`` guard), crowd/RLE
    annotations are skipped (logged; pycocotools-only format). Images are
    kept when their native-resolution mask covers > ``min_mask_pixels``
    (the reference's qualification rule), then resized (mask NEAREST).
    Partition: Dirichlet(alpha) over each image's first present category,
    like pascal_voc (COCO has no natural users)."""
    import json as _json

    from PIL import Image, ImageDraw

    if year is None:
        # same predicate as detection: the year must actually hold the
        # instances json + image dir (a stray empty 2017/ next to a valid
        # 2014 drop must not win)
        year = next((y for y in ("2017", "2014")
                     if os.path.exists(os.path.join(
                         root, y, "annotations", f"instances_train{y}.json"))
                     and os.path.isdir(os.path.join(root, y, f"train{y}"))),
                    "2017")
    base = os.path.join(root, year)

    def load_split(split: str):
        inst = os.path.join(base, "annotations", f"instances_{split}{year}.json")
        img_dir = os.path.join(base, f"{split}{year}")
        if not os.path.exists(inst):
            return None
        with open(inst) as f:
            doc = _json.load(f)
        name_to_class = {}
        for cat in doc.get("categories", []):
            name = _COCO_NAME_ALIASES.get(cat["name"], cat["name"])
            if name in COCO_SEG_CATEGORIES:
                name_to_class[cat["id"]] = COCO_SEG_CATEGORIES.index(name) + 1
        anns_by_img: Dict[int, list] = {}
        n_crowd = 0
        for ann in doc.get("annotations", []):
            if ann.get("category_id") not in name_to_class:
                continue
            if ann.get("iscrowd"):
                n_crowd += 1
                continue
            anns_by_img.setdefault(int(ann["image_id"]), []).append(ann)
        if n_crowd:
            log.info("dataset coco_seg %s: skipped %d crowd (RLE) annotations",
                     split, n_crowd)
        xs, ys, first_cat = [], [], []
        for meta in doc.get("images", []):
            anns = anns_by_img.get(int(meta["id"]))
            if not anns:
                continue
            h, w = int(meta["height"]), int(meta["width"])
            mask = np.zeros((h, w), np.uint8)
            for ann in anns:
                c = name_to_class[ann["category_id"]]
                layer = Image.new("L", (w, h), 0)
                drawer = ImageDraw.Draw(layer)
                segs = ann.get("segmentation") or []
                if not isinstance(segs, list):
                    continue  # RLE dict without iscrowd: not representable
                for poly in segs:
                    if len(poly) >= 6:
                        drawer.polygon(list(map(float, poly)), fill=1)
                m = np.asarray(layer, np.uint8)
                mask = np.where((mask == 0) & (m > 0), np.uint8(c), mask)
            if int((mask > 0).sum()) <= min_mask_pixels:
                continue  # reference __preprocess qualification
            img_p = os.path.join(img_dir, meta["file_name"])
            if not os.path.exists(img_p):
                continue
            img = Image.open(img_p).convert("RGB").resize(
                (image_hw, image_hw), Image.BILINEAR)
            mask_small = np.asarray(Image.fromarray(mask).resize(
                (image_hw, image_hw), Image.NEAREST))
            xs.append(np.asarray(img, np.float32) / 255.0)
            ys.append(mask_small.astype(np.int32))
            cats = np.unique(mask)
            cats = cats[cats > 0]
            first_cat.append(int(cats[0]) if len(cats) else 0)
        if not xs:
            return None
        return np.stack(xs), np.stack(ys), np.asarray(first_cat, np.int64)

    loaded = load_split("train")
    if loaded is None:
        raise ValueError(
            f"{base}: no qualifying train images (need instances_train{year}"
            f".json + train{year}/ jpgs with > {min_mask_pixels} mask pixels)")
    x_tr, y_tr, cats_tr = loaded
    val = load_split("val")
    x_te = y_te = None
    if val is not None:
        x_te, y_te, _ = val
    train, test = _dirichlet_seg_federation(
        x_tr, y_tr, cats_tr, x_te, y_te, n_clients,
        COCO_SEG_CLASSES, alpha, seed, "coco_seg")
    return train, test, COCO_SEG_CLASSES
