"""The port's bridge to the C++ data plane (``native/dataplane``) against the
JAX package's, on the CPU.

Both packages write the same shard bytes and read each other's shards; the
port builds the C++ sources into its own directory
(``fedml_tpu_torch/ops/_build/dataplane``) and its streamed batches equal
the JAX package's for the same seed, epoch by epoch, in the order a Python
re-derivation of the prefetcher's shuffle gives. When the build fails the
port falls back to JAX's memmap gather, batch for batch.
"""

import os

import numpy as np
import pytest

from fedml_tpu.data import native_loader as jnl
from fedml_tpu.data.dataset import ArrayDataset as JArrayDataset
from fedml_tpu_torch.data import native_loader as tnl
from fedml_tpu_torch.data.dataset import ArrayDataset as TArrayDataset


def _data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, 4, 4, 3)).astype(np.float32), rng.integers(0, 10, n).astype(np.int64)


def _take(stream, k):
    return [next(stream) for _ in range(k)]


@pytest.fixture
def forced_fallback(tmp_path, monkeypatch):
    """Both packages without their libraries: the port's build fails (no
    compiler), JAX's is marked unavailable."""
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_build_error", None)
    monkeypatch.setattr(tnl, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(jnl, "_lib", None)
    monkeypatch.setattr(jnl, "_build_error", "forced off")
    yield
    assert not os.path.exists(tnl.lib_path())


def test_the_port_builds_its_own_library():
    assert tnl.NativeBatchLoader.available(), tnl.build_error()
    path = os.path.realpath(tnl.lib_path())
    assert path.startswith(os.path.realpath(os.path.join(os.path.dirname(tnl.__file__), "..",
                                                         "ops", "_build")))
    assert os.path.realpath(jnl._LIB_PATH) != path
    cmd = tnl.build_command("out.so")
    assert cmd[1:5] == ["-O2", "-std=c++17", "-fPIC", "-Wall"] and "-shared" in cmd


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8, np.int64])
def test_shards_are_jax_bytes_both_ways(tmp_path, dtype):
    arr = (np.arange(5 * 3 * 2) % 7).astype(dtype).reshape(5, 3, 2)
    tnl.write_shard(str(tmp_path / "port.fdlp"), arr)
    jnl.write_shard(str(tmp_path / "jax.fdlp"), arr)
    assert (tmp_path / "port.fdlp").read_bytes() == (tmp_path / "jax.fdlp").read_bytes()
    assert tnl.shard_info(str(tmp_path / "jax.fdlp")) == jnl.shard_info(str(tmp_path / "port.fdlp"))
    assert tnl.shard_info(str(tmp_path / "jax.fdlp")) == (np.dtype(dtype), (5, 3, 2))
    with pytest.raises(ValueError, match="unsupported shard dtype"):
        tnl.write_shard(str(tmp_path / "bad.fdlp"), arr.astype(np.float16))


def test_stream_equals_jax_and_covers_each_epoch(tmp_path):
    x, y = _data()
    paths = TArrayDataset(x, y).save_shards(str(tmp_path / "cifar"))
    jpaths = JArrayDataset(x, y).save_shards(str(tmp_path / "jax"))
    bs, per_epoch = 8, 40 // 8
    got = _take(TArrayDataset.stream(paths, bs, seed=3), 2 * per_epoch)
    ref = _take(JArrayDataset.stream(jpaths, bs, seed=3), 2 * per_epoch)
    for (gx, gy), (rx, ry) in zip(got, ref):
        assert np.array_equal(gx, rx) and np.array_equal(gy, ry)
    for epoch in range(2):
        perm = tnl.native_permutation(40, 3, epoch)
        xs = np.concatenate([b[0] for b in got[epoch * per_epoch:(epoch + 1) * per_epoch]])
        ys = np.concatenate([b[1] for b in got[epoch * per_epoch:(epoch + 1) * per_epoch]])
        assert np.array_equal(xs, x[perm]) and np.array_equal(ys, y[perm])
        assert sorted(perm.tolist()) == list(range(40))
    assert not np.array_equal(tnl.native_permutation(40, 3, 0), tnl.native_permutation(40, 3, 1))


def test_stream_is_seeded_and_drops_the_ragged_tail(tmp_path):
    x, y = _data(n=30)
    paths = TArrayDataset(x, y).save_shards(str(tmp_path / "d"))
    a = list(TArrayDataset.stream(paths, 8, seed=1, epochs=1))
    b = list(TArrayDataset.stream(paths, 8, seed=1, epochs=1))
    c = list(TArrayDataset.stream(paths, 8, seed=2, epochs=1))
    assert len(a) == 30 // 8
    assert all(np.array_equal(p[0], q[0]) for p, q in zip(a, b))
    assert not all(np.array_equal(p[0], q[0]) for p, q in zip(a, c))
    seen = np.concatenate([p[1] for p in a])
    assert len(seen) == 24 and len(set(map(tuple, np.concatenate([p[0] for p in a])
                                            .reshape(24, -1).tolist()))) == 24


def test_memmap_fallback_when_the_build_fails(tmp_path, forced_fallback):
    x, y = _data(n=30)
    assert not tnl.NativeBatchLoader.available()
    assert "no-such-compiler" in tnl.build_error()
    paths = TArrayDataset(x, y).save_shards(str(tmp_path / "port"))
    jpaths = JArrayDataset(x, y).save_shards(str(tmp_path / "jax"))
    assert open(paths[0], "rb").read() == open(jpaths[0], "rb").read()
    got = _take(TArrayDataset.stream(paths, 8, seed=5), 7)
    ref = _take(JArrayDataset.stream(jpaths, 8, seed=5), 7)
    for (gx, gy), (rx, ry) in zip(got, ref):
        assert np.array_equal(gx, rx) and np.array_equal(gy, ry)
    perm = np.random.default_rng(5).permutation(30)
    assert np.array_equal(np.concatenate([b[1] for b in got[:3]]), y[perm[:24]])
    with pytest.raises(RuntimeError, match="unavailable"):
        tnl.NativeBatchLoader(list(paths), 8)
    with pytest.raises(ValueError, match="batch size"):
        next(TArrayDataset.stream(paths, 31))
