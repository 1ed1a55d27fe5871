"""The port's readers of a user's dataset files against the JAX package's,
on the CPU.

Each test writes small files at each format's real widths (cut only in
count) and loads them through both packages: ``data_loader.load`` for the
LEAF json, TFF and FedNLP h5, landmarks, reddit and segmentation layouts,
CIFAR python batches, idx-ubyte drops and image folders, and the
``sources.py`` readers directly. The arrays, the client maps and the
loader's side effects on ``args`` (``output_dim``, ``input_shape``,
``seg_ignore_label``, ``vocab_size``) must be bit-equal; the refusals (a
hostile CIFAR pickle, a bad idx magic, a config the files cannot satisfy)
and the logged fallbacks to the surrogate must be the JAX package's. Two
FedAvg federations on files (femnist LEAF json, CIFAR-10 batches) track
JAX within ``tests/test_torch_fedavg.py``'s tolerances for LR: each eval's
test_loss within rtol 1e-4, test_correct within 2, the final params within
1e-4 of their scale.

Where a fallback is compared, the surrogate loaders of both packages are
stubbed with a sentinel, so a test checks which path each package took
without building a surrogate.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.data import data_loader as jloader
from fedml_tpu.data import sources as jsources
from fedml_tpu_torch.data import data_loader as tloader
from fedml_tpu_torch.data import sources as tsources
from tests.test_data_formats import (_write_20news_h5, _write_cifar10_batches, _write_cityscapes,
                                     _write_coco_seg, _write_idx, _write_landmarks, _write_leaf,
                                     _write_nus_wide, _write_pascal_voc, _write_png_tree,
                                     _write_reddit, _write_stackoverflow_lr)

h5py = pytest.importorskip("h5py")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the files ---------------------------------------------------------------------------

def _leaf_images(root, dataset, width, classes, n_users=4, per_user=6):
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        users = {f"f_{i:04d}": {"x": rng.random((per_user, width)).tolist(),
                                "y": rng.integers(0, classes, per_user).tolist()}
                 for i in range(n_users)}
        _write_leaf(root / dataset, split, users)


def _leaf_shakespeare(root):
    ctx = "to be or not to be that is the question whether tis nobler in the minds to suff"
    ctx = ctx.ljust(79)
    users = {f"p{i}": {"x": [ctx + "e", ctx + "a"], "y": ["r", "n"]} for i in range(3)}
    _write_leaf(root / "shakespeare", "train", users)
    _write_leaf(root / "shakespeare", "test", users)


def _tff_text(root, dataset, fname, key):
    d = root / dataset
    d.mkdir(parents=True)
    sents = {"THE_TRAGEDY_CLIENT_1": ["To be, or not to be", "that is the question"],
             "CLIENT_2": ["All the world's a stage", "and all the men and women merely players"],
             "user_c": ["how do i sort a list in python", "what is a segfault"]}
    for split in ("train", "test"):
        with h5py.File(d / f"{fname}_{split}.h5", "w") as h5:
            for cid, ss in sents.items():
                h5.create_dataset(f"examples/{cid}/{key}",
                                  data=np.array([s.encode("utf8") for s in ss], dtype="S100"))


def _tff_cifar100(root):
    d = root / "fed_cifar100"
    d.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for split in ("train", "test"):
        with h5py.File(d / f"fed_cifar100_{split}.h5", "w") as h5:
            for cid in ("0", "1", "2"):
                h5.create_dataset(f"examples/{cid}/image",
                                  data=rng.integers(0, 255, (4, 32, 32, 3), dtype=np.uint8))
                h5.create_dataset(f"examples/{cid}/label",
                                  data=rng.integers(0, 100, (4,), dtype=np.int64))


def _idx_drop(root, gz):
    d = root / "fashion_mnist"
    d.mkdir(parents=True)
    rng = np.random.default_rng(2)
    _write_idx(d / "train-images-idx3-ubyte", rng.integers(0, 256, (12, 28, 28)), gz=gz)
    _write_idx(d / "train-labels-idx1-ubyte", rng.integers(0, 10, 12), gz=gz)
    _write_idx(d / "t10k-images-idx3-ubyte", rng.integers(0, 256, (4, 28, 28)), gz=gz)
    _write_idx(d / "t10k-labels-idx1-ubyte", rng.integers(0, 10, 4), gz=gz)


def _image_folder(root, dataset, test_split, size):
    _write_png_tree(root / dataset, "train", {"cat": 5, "dog": 4, "emu": 3}, size=size)
    _write_png_tree(root / dataset, test_split, {"cat": 2, "dog": 2, "emu": 1}, size=size)


WRITERS = {
    "femnist": lambda r: _leaf_images(r, "femnist", 784, 62),
    "mnist": lambda r: _leaf_images(r, "mnist", 784, 10),
    "shakespeare": _leaf_shakespeare,
    "fed_shakespeare": lambda r: _tff_text(r, "fed_shakespeare", "shakespeare", "snippets"),
    "fed_cifar100": _tff_cifar100,
    "stackoverflow_nwp": lambda r: _tff_text(r, "stackoverflow_nwp", "stackoverflow", "tokens"),
    "stackoverflow_lr": lambda r: _write_stackoverflow_lr(r / "stackoverflow_lr"),
    "20news": lambda r: _write_20news_h5(r / "20news"),
    "landmarks": _write_landmarks,
    "reddit": _write_reddit,
    "pascal_voc": _write_pascal_voc,
    "cityscapes": _write_cityscapes,
    "coco_seg": _write_coco_seg,
    "cifar10": _write_cifar10_batches,
    "fashion_mnist": lambda r: _idx_drop(r, gz=True),
    "cinic10": lambda r: _image_folder(r, "cinic10", "test", (32, 32)),
    "imagenet": lambda r: _image_folder(r, "imagenet", "val", (64, 64)),
}

# the args each loader sets, as the JAX loader sets them
SIDE_EFFECTS = ("output_dim", "input_shape", "seg_ignore_label", "vocab_size")


def _load_both(**kw):
    ja = fedml_tpu.default_config("simulation", **kw)
    ta = fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw)
    return jloader.load(ja), tloader.load(ta), ja, ta


def _assert_arrays_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _assert_loads_equal(ref, got, ja, ta):
    assert ref[0] == got[0] and ref[1] == got[1] and ref[7] == got[7]
    assert ref[4] == got[4]
    assert sorted(ref[5]) == sorted(got[5]) and sorted(ref[6]) == sorted(got[6])
    for r_ds, g_ds in [(ref[2], got[2]), (ref[3], got[3])] + \
            [(ref[5][c], got[5][c]) for c in ref[5]] + [(ref[6][c], got[6][c]) for c in ref[6]]:
        _assert_arrays_equal(r_ds.x, g_ds.x)
        _assert_arrays_equal(r_ds.y, g_ds.y)
    for name in SIDE_EFFECTS:
        assert getattr(ja, name, None) == getattr(ta, name, None), name


# --- every reader against JAX's ----------------------------------------------------------

@pytest.mark.parametrize("dataset", sorted(WRITERS))
def test_data_load_reads_the_files_as_jax_does(tmp_path, dataset):
    WRITERS[dataset](tmp_path)
    ref, got, ja, ta = _load_both(dataset=dataset, client_num_in_total=2,
                                  data_cache_dir=str(tmp_path))
    _assert_loads_equal(ref, got, ja, ta)
    assert got[0] > 0 and ta.output_dim == got[7]


def test_cifar100_batches_and_plain_idx_files(tmp_path):
    rng = np.random.default_rng(4)
    d = tmp_path / "cifar-100-python"
    d.mkdir()
    for split, n in (("train", 12), ("test", 4)):
        (d / split).write_bytes(pickle.dumps({"data": rng.integers(0, 256, (n, 3072),
                                                                    dtype=np.uint8),
                                              "fine_labels": rng.integers(0, 100, n).tolist()}))
    ref = jsources.load_image_dataset("cifar100", str(tmp_path))
    got = tsources.load_image_dataset("cifar100", str(tmp_path))
    assert got[4] == ref[4] == 100
    for a, b in zip(ref[:4], got[:4]):
        _assert_arrays_equal(a, b)
    _idx_drop(tmp_path, gz=False)  # uncompressed idx files under {cache}/fashion_mnist
    ref = jsources.load_image_dataset("fashion_mnist", str(tmp_path))
    got = tsources.load_image_dataset("fashion_mnist", str(tmp_path))
    for a, b in zip(ref, got):
        _assert_arrays_equal(a, b)


@pytest.mark.parametrize("n_parties", [2, 3])
def test_nus_wide_files_as_jax_does(tmp_path, n_parties):
    root = _write_nus_wide(tmp_path)
    for got, ref in ((tsources.load_nus_wide_files(str(root), n_parties=n_parties),
                      jsources.load_nus_wide_files(str(root), n_parties=n_parties)),
                     (tsources.load_nus_wide_vertical(str(tmp_path), n_parties=n_parties),
                      jsources.load_nus_wide_vertical(str(tmp_path), n_parties=n_parties))):
        assert len(got[0]) == len(ref[0]) == n_parties
        for a, b in zip(ref[0], got[0]):
            _assert_arrays_equal(a, b)
        _assert_arrays_equal(ref[1], got[1])


def test_image_folder_caps_and_holdout_as_jax_does(tmp_path, monkeypatch):
    """A train-only drop holds out a shuffled tenth; FEDML_MAX_IMAGES_TOTAL
    caps a split by its class count, as in the JAX package."""
    _write_png_tree(tmp_path / "cinic10", "train", {f"c{i}": 4 for i in range(5)})
    monkeypatch.setenv("FEDML_MAX_IMAGES_TOTAL", "10")  # 10 // 5 classes = 2 each
    assert tsources.max_images_per_class(5) == jsources.max_images_per_class(5) == 2
    ref = jsources.load_image_dataset("cinic10", str(tmp_path))
    got = tsources.load_image_dataset("cinic10", str(tmp_path))
    assert len(got[0]) == 9 and len(got[2]) == 1
    for a, b in zip(ref, got):
        _assert_arrays_equal(a, b)


# --- refusals and fallbacks --------------------------------------------------------------

def test_hostile_cifar_pickle_and_bad_idx_magic_are_refused(tmp_path):
    """A pickle 'dataset' carrying a gadget raises instead of executing, and
    an idx file whose magic is not unsigned bytes raises ValueError, in both
    packages (tests/test_data_formats.py's refusals)."""
    import struct

    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        (d / name).write_bytes(pickle.dumps(os.system))
    raised = []
    for src in (jsources, tsources):
        with pytest.raises(Exception) as e:
            src.load_image_dataset("cifar10", str(tmp_path))
        raised.append(type(e.value))
    assert raised[0] is raised[1], raised
    bad = tmp_path / "bad-idx"
    bad.write_bytes(struct.pack(">I", 0x0D03) + struct.pack(">III", 1, 2, 2) + b"\0" * 16)
    for src in (jsources, tsources):
        with pytest.raises(ValueError, match="not an idx-ubyte file"):
            src._read_idx(str(bad))


class _Surrogate(Exception):
    """Raised by the stubbed surrogate loaders: the loader fell back."""


def _stub_surrogates(monkeypatch):
    def sentinel(*a, **k):
        raise _Surrogate

    for loader in (jloader, tloader):
        for name in ("load_image_dataset", "load_text_dataset", "load_text_classification_dataset",
                     "load_stackoverflow_lr", "load_tabular_dataset"):
            monkeypatch.setattr(loader, name, sentinel)
    for src in (jsources, tsources):
        monkeypatch.setattr(src, "_synthetic_classification", sentinel)


def _outcome(load, args):
    try:
        load(args)
    except _Surrogate:
        return "surrogate"
    except Exception as e:  # noqa: BLE001 - the exception type is what is compared
        return type(e).__name__
    return "read"


def test_corrupt_drop_falls_back_to_the_surrogate_as_jax_does(tmp_path, monkeypatch, caplog):
    """The landmarks probe finds its csv and images/, but the images are
    gone: both packages log the fallback and load the surrogate."""
    root = _write_landmarks(tmp_path)
    for f in (root / "images").iterdir():
        f.unlink()
    _stub_surrogates(monkeypatch)
    kw = dict(dataset="landmarks", client_num_in_total=3, data_cache_dir=str(tmp_path))
    with caplog.at_level("WARNING"):
        outcomes = [_outcome(jloader.load, fedml_tpu.default_config("simulation", **kw)),
                    _outcome(tloader.load, fedml_tpu_torch.default_config("simulation", **kw))]
    assert outcomes == ["surrogate", "surrogate"]
    warned = [r for r in caplog.records if "falling back to surrogate" in r.message]
    assert {r.name for r in warned} == {"fedml_tpu.data.data_loader",
                                        "fedml_tpu_torch.data.data_loader"}


def test_empty_image_folder_falls_back_as_jax_does(tmp_path, monkeypatch, caplog):
    _stub_surrogates(monkeypatch)
    (tmp_path / "cinic10" / "train" / "cat").mkdir(parents=True)  # dirs, no files
    with caplog.at_level("WARNING"):
        outcomes = []
        for src in (jsources, tsources):
            try:
                src.load_image_dataset("cinic10", str(tmp_path))
                outcomes.append("read")
            except _Surrogate:
                outcomes.append("surrogate")
    assert outcomes == ["surrogate", "surrogate"]
    assert sum("falling back to surrogate" in r.message for r in caplog.records) == 2


def test_config_error_is_raised_not_masked_as_jax_does(tmp_path):
    """More clients than the file has users is the user's error: both
    packages raise FedDataConfigError rather than train on the surrogate."""
    from fedml_tpu.data.formats import FedDataConfigError as JErr
    from fedml_tpu_torch.data.formats import FedDataConfigError as TErr

    _write_landmarks(tmp_path, n_users=3)
    kw = dict(dataset="landmarks", client_num_in_total=5, data_cache_dir=str(tmp_path))
    with pytest.raises(JErr, match="exceeds the file's 3 users"):
        jloader.load(fedml_tpu.default_config("simulation", **kw))
    with pytest.raises(TErr, match="exceeds the file's 3 users"):
        tloader.load(fedml_tpu_torch.default_config("simulation", **kw))


def test_download_stays_refused_but_files_win(tmp_path):
    """``allow_download`` raises where no files are found (the JAX package
    would fetch); where the LEAF files are present they are read and nothing
    is fetched. The JAX package is loaded without the flag: with it, JAX
    probes the network before its surrogate."""
    kw = dict(dataset="femnist", client_num_in_total=2, data_cache_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloader.load(fedml_tpu_torch.default_config("simulation", allow_download=True, **kw))
    WRITERS["femnist"](tmp_path)
    ja = fedml_tpu.default_config("simulation", **kw)
    ta = fedml_tpu_torch.default_config("simulation", using_gpu=False, allow_download=True, **kw)
    _assert_loads_equal(jloader.load(ja), tloader.load(ta), ja, ta)


# --- FedAvg on files ---------------------------------------------------------------------

@pytest.mark.parametrize("dataset", ["femnist", "cifar10"])
def test_fedavg_on_files_tracks_jax(tmp_path, dataset):
    """LR on femnist LEAF json (4 writers) and on CIFAR-10 batches (100
    images), 2 clients, 2 rounds, through each package's FedMLRunner from
    JAX's init params. lr 0.01, not Parrot's 0.03: at 0.03, LR on 3,072
    random pixels diverges (test_loss 10.9 after round 0) and the two
    packages' f32 roundings then part by 7e-4 of the loss; at 0.01 both
    learn and agree to 7e-7 of the update."""
    from tests.test_torch_fedavg import PARROT, _assert_history_close, _leaves, _run_jax, _run_port

    WRITERS[dataset](tmp_path)
    kw = dict(PARROT, dataset=dataset, data_cache_dir=str(tmp_path), comm_round=2,
              frequency_of_the_test=1, batch_size=4, learning_rate=0.01)
    p0, ref_hist, ref_w = _run_jax(kw)
    _, hist, w = _run_port(kw, p0)
    assert [m["round"] for m in hist] == [0, 1]
    _assert_history_close(hist, ref_hist, acc_slack=2)
    got = _leaves(w)
    for k, r in _leaves(ref_w).items():
        assert np.abs(got[k] - r).max() <= 1e-4 * np.abs(r).max(), k


def test_formats_module_is_jax_free():
    """formats.py imports h5py, PIL and scipy inside its readers: the module
    itself loads with numpy alone, as JAX's does."""
    import ast

    import fedml_tpu_torch.data.formats as tformats

    tree = ast.parse(open(tformats.__file__).read())
    top = {a.name.split(".")[0] for n in tree.body if isinstance(n, ast.Import) for a in n.names}
    top |= {n.module.split(".")[0] for n in tree.body if isinstance(n, ast.ImportFrom) and n.module}
    assert top <= {"json", "logging", "os", "collections", "typing", "numpy", "__future__"}, top
