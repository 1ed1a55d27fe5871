"""Build the flash-attention kernels at first use.

The CUDA sources (``csrc/flash_*.cu``) have a plain C interface; only
``csrc/flash_binding.cpp`` includes PyTorch's headers. With ``ninja``
available the build goes through ``torch.utils.cpp_extension.load`` with all
sources in one call; without it, ``nvcc`` compiles each source into its own
shared library (one process per source, all started together) and the
libraries are loaded with ``ctypes``. Both land in ``ops/_build/``, which
``.gitignore`` lists. A build or launch error raises: nothing falls back to
the plain PyTorch versions.

Nothing here runs at import time; ``kernels()`` builds on its first call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNEL_SOURCES = ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu")
BINDING_SOURCE = "flash_binding.cpp"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_C_SIGNATURES = {
    # q, k, v, o, lse, bhq, hq, hkv, t, d, causal, block_q, block_k, is_bf16, stream
    "fedml_flash_fwd": [_P] * 5 + [_I] * 9 + [_P],
    # q, k, v, dout, lse, delta, dq, bhq, hq, hkv, t, d, causal, bq, bk, is_bf16, stream
    "fedml_flash_bwd_dq": [_P] * 7 + [_I] * 9 + [_P],
    # q, k, v, dout, lse, delta, dk, dv, bhkv, hq, hkv, t, d, causal, bq, bk, is_bf16, stream
    "fedml_flash_bwd_dkv": [_P] * 8 + [_I] * 9 + [_P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not found or not os.path.exists(found):
        raise RuntimeError("nvcc not found: the flash kernels need the CUDA toolkit")
    return found


def _load_extension():
    """Route (a): torch's builder, one call for all sources."""
    from torch.utils.cpp_extension import load

    sources = [str(CSRC / BINDING_SOURCE)] + [str(CSRC / s) for s in KERNEL_SOURCES]
    return load(name="fedml_flash_kernels", sources=sources,
                build_directory=str(BUILD_DIR), extra_cuda_cflags=CUDA_FLAGS,
                extra_include_paths=[str(CSRC)], verbose=False)


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(CUDA_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def _load_ctypes():
    """Route (b): nvcc into one C-ABI shared library per source, in parallel,
    reused while the sources are unchanged."""
    nvcc = _nvcc()
    digest = _source_digest()
    jobs = {}
    for src in KERNEL_SOURCES:
        lib = BUILD_DIR / f"lib{Path(src).stem}_{digest}.so"
        if not lib.exists():
            # written under a temporary name, so a cut build leaves no library
            cmd = [nvcc, *CUDA_FLAGS, "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                   "-I", str(CSRC), "-o", str(lib) + ".tmp", str(CSRC / src)]
            jobs[lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True)
    failed = []
    for lib, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{lib.name}:\n{out}")
        else:
            os.replace(str(lib) + ".tmp", lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    libs = [ctypes.CDLL(str(BUILD_DIR / f"lib{Path(s).stem}_{digest}.so")) for s in KERNEL_SOURCES]
    return _CtypesKernels(libs)


class _CtypesKernels:
    """The binding's interface (fwd, bwd_dq, bwd_dkv) over the C functions."""

    def __init__(self, libs):
        self._libs = libs  # keep the libraries loaded
        self._fns = {}
        for name, argtypes in _C_SIGNATURES.items():
            lib = next(lib for lib in libs if hasattr(lib, name))
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fns[name] = fn

    def _call(self, name, q, *args):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = self._fns[name](*args, int(q.dtype == torch.bfloat16), stream)
        if err:
            raise RuntimeError(f"{name} launch failed: cudaError_t {err}")

    def fwd(self, q, k, v, o, lse, causal, hq, hkv, bq, bk):
        self._call("fedml_flash_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), q.shape[0], hq, hkv, q.shape[1], q.shape[2], int(causal),
                   bq, bk)

    def bwd_dq(self, q, k, v, do, lse, delta, dq, causal, hq, hkv, bq, bk):
        self._call("fedml_flash_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), q.shape[0],
                   hq, hkv, q.shape[1], q.shape[2], int(causal), bq, bk)

    def bwd_dkv(self, q, k, v, do, lse, delta, dk, dv, causal, hq, hkv, bq, bk):
        self._call("fedml_flash_bwd_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), k.shape[0], hq, hkv, q.shape[1], q.shape[2], int(causal),
                   bq, bk)


def build_route() -> str:
    """'extension' when ninja is available (torch's builder), else 'nvcc'."""
    from torch.utils.cpp_extension import is_ninja_available

    return "extension" if is_ninja_available() else "nvcc"


@functools.cache
def kernels():
    """The built kernels, with methods fwd / bwd_dq / bwd_dkv taking tensors.
    Built once per process, into BUILD_DIR."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if build_route() == "extension":
        return _load_extension()
    return _load_ctypes()
