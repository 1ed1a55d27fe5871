"""ctypes bridge to the native C++ data plane (``native/dataplane``):
counterpart of ``fedml_tpu/data/native_loader.py``.

Shards are written once as flat binary files (``FDLP`` magic, version,
dtype code, rank, the dims as u64, then the raw samples), mmap'd by C++, and
batches are gathered (shuffled, reseeded each epoch) by a background C++
thread into double-buffered slots; the Python side does one memcpy into a
numpy array a batch. The file format, the dtype codes and the fallback are
the JAX package's: without a C++ toolchain ``NativeBatchLoader.available()``
is false, shards are written and read by the numpy code below, and
``ArrayDataset.stream`` gathers from a memmap.

The port compiles ``native/dataplane/src`` itself, at first use (never at
import), into ``fedml_tpu_torch/ops/_build/dataplane/`` (which ``.gitignore``
lists), with the flags of ``native/dataplane/Makefile``: one ``$CXX`` line
(``g++`` by default). It neither loads nor writes the library the JAX
package builds in ``native/dataplane/build/``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

_REPO = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
_DP_DIR = os.path.join(_REPO, "native", "dataplane")
_SOURCES = ("shard.cpp", "prefetcher.cpp", "c_api.cpp")
BUILD_DIR = os.path.join(_REPO, "fedml_tpu_torch", "ops", "_build", "dataplane")
_LIB_NAME = "libfedml_dataplane.so"

_DTYPES = {
    np.dtype(np.float32): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.uint8): 3,
    np.dtype(np.int64): 4,
}
_DTYPES_INV = {v: k for k, v in _DTYPES.items()}

_lib = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def lib_path() -> str:
    return os.path.join(BUILD_DIR, _LIB_NAME)


def build_command(out: str) -> List[str]:
    """The Makefile's compile line, writing the library to ``out``."""
    return ([os.environ.get("CXX", "g++"), "-O2", "-std=c++17", "-fPIC", "-Wall",
             "-I" + os.path.join(_DP_DIR, "include"), "-pthread", "-shared", "-o", out]
            + [os.path.join(_DP_DIR, "src", s) for s in _SOURCES])


def _compile(path: str) -> None:
    """Build the library at ``path``: compiled to a name of this process's
    own and renamed into place, so concurrent first uses never load a
    half-written file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build failed: {proc.stderr[-2000:]}")
    os.replace(tmp, path)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = lib_path()
        try:
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
        except Exception as e:  # no compiler on PATH, a failed build, a stale .so, ...
            _build_error = f"{type(e).__name__}: {e}"
            log.warning("native dataplane unavailable (%s); python fallback only", _build_error)
            return None
        lib.fdlp_last_error.restype = ctypes.c_char_p
        lib.fdlp_write_shard.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p,
        ]
        lib.fdlp_shard_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.fdlp_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint32,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.fdlp_prefetcher_create.restype = ctypes.c_void_p
        lib.fdlp_batches_per_epoch.argtypes = [ctypes.c_void_p]
        lib.fdlp_batches_per_epoch.restype = ctypes.c_uint64
        lib.fdlp_prefetcher_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.fdlp_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """Why the library did not load (None before the first use, or when it
    loaded)."""
    return _build_error


def _err(lib) -> str:
    return lib.fdlp_last_error().decode()


def write_shard(path: str, array: np.ndarray) -> None:
    """Write one array as a binary shard (leading dim = samples)."""
    lib = _load()
    arr = np.ascontiguousarray(array)
    if arr.dtype not in _DTYPES:
        raise ValueError(f"unsupported shard dtype {arr.dtype}")
    if lib is None:
        # the numpy writer (same format)
        with open(path, "wb") as f:
            f.write(b"FDLP")
            f.write(np.asarray([1, _DTYPES[arr.dtype], arr.ndim], np.uint32).tobytes())
            f.write(np.asarray(arr.shape, np.uint64).tobytes())
            f.write(arr.tobytes())
        return
    dims = (ctypes.c_uint64 * arr.ndim)(*arr.shape)
    rc = lib.fdlp_write_shard(
        path.encode(), _DTYPES[arr.dtype], arr.ndim, dims,
        arr.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise RuntimeError(f"shard write failed: {_err(lib)}")


def shard_info(path: str) -> Tuple[np.dtype, Tuple[int, ...]]:
    lib = _load()
    if lib is None:
        with open(path, "rb") as f:
            head = f.read(16)
            if head[:4] != b"FDLP":
                raise ValueError(f"{path}: bad shard magic")
            _, dt, ndim = np.frombuffer(head[4:], np.uint32)
            dims = np.frombuffer(f.read(8 * ndim), np.uint64)
        return _DTYPES_INV[int(dt)], tuple(int(d) for d in dims)
    dt = ctypes.c_uint32()
    dims = (ctypes.c_uint64 * 8)()
    ndim = lib.fdlp_shard_info(path.encode(), ctypes.byref(dt), dims)
    if ndim < 0:
        raise RuntimeError(f"shard open failed: {_err(lib)}")
    return _DTYPES_INV[dt.value], tuple(dims[i] for i in range(ndim))


_MASK = (1 << 64) - 1


def native_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """The sample order of the C++ prefetcher's epoch ``epoch`` for ``seed``
    (``prefetcher.cpp`` ``reshuffle``: a Fisher-Yates shuffle driven by
    splitmix64), re-derived in Python: what a check of the native batches
    gathers from the shards."""
    perm = np.arange(n, dtype=np.int64)
    s = (int(seed) ^ ((0xA5A5A5A5 + int(epoch) * 0x9E3779B9) & _MASK)) & _MASK
    for i in range(n - 1, 0, -1):
        s = (s + 0x9E3779B97F4A7C15) & _MASK
        z = s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        z ^= z >> 31
        j = z % (i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    return perm


class NativeBatchLoader:
    """Iterate shuffled (x, y, ...) batches gathered by the C++ prefetcher."""

    def __init__(self, shard_paths: Sequence[str], batch_size: int, seed: int = 0, slots: int = 3):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native dataplane unavailable: {_build_error}")
        self._lib = lib
        self.batch_size = int(batch_size)
        self._specs: List[Tuple[np.dtype, Tuple[int, ...]]] = [shard_info(p) for p in shard_paths]
        paths = (ctypes.c_char_p * len(shard_paths))(*[p.encode() for p in shard_paths])
        self._h = lib.fdlp_prefetcher_create(
            paths, len(shard_paths), self.batch_size, int(seed), int(slots)
        )
        if not self._h:
            raise RuntimeError(f"prefetcher create failed: {_err(lib)}")
        self.batches_per_epoch = int(lib.fdlp_batches_per_epoch(self._h))

    @staticmethod
    def available() -> bool:
        return _load() is not None

    def next_batch(self) -> Tuple[bool, List[np.ndarray]]:
        """(more_in_epoch, [array_k]): the arrays are fresh copies."""
        outs = []
        ptrs = (ctypes.c_void_p * len(self._specs))()
        for k, (dt, dims) in enumerate(self._specs):
            buf = np.empty((self.batch_size, *dims[1:]), dt)
            outs.append(buf)
            ptrs[k] = buf.ctypes.data_as(ctypes.c_void_p)
        rc = self._lib.fdlp_prefetcher_next(self._h, ptrs)
        if rc < 0:
            raise RuntimeError(f"prefetcher next failed: {_err(self._lib)}")
        return rc == 1, outs

    def epoch(self) -> Iterator[List[np.ndarray]]:
        while True:
            more, arrays = self.next_batch()
            yield arrays
            if not more:
                return

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.fdlp_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
