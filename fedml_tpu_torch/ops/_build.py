"""Build the port's CUDA kernels at first use: the three flash-attention
kernels and the weight-only int8 GEMM.

The CUDA sources (``csrc/*.cu``) have a plain C interface and include no
PyTorch header. ``nvcc`` compiles each source into its own shared library
(one process per source, all started together) and the libraries are loaded
with ``ctypes``. They land in ``ops/_build/``, which ``.gitignore`` lists,
named by a digest of the sources and flags, so a checkout builds once: a
process that finds every library of its digest built runs no ``nvcc``. A
serving ``ReplicaSet`` calls ``build()`` before it starts children that go
on the card, and starts them with ``NO_BUILD_ENV`` set: a child that found
a library missing would raise rather than run ``nvcc`` itself.
ptxas's report of every kernel (registers, spills) is kept beside each
library and read back by ``ptxas_report()`` and ``ptxas_notes()``. A build
or launch error raises: nothing falls back to the plain PyTorch versions.

Nothing here runs at import time; ``kernels()`` builds on its first call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNEL_SOURCES = ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu", "int8_gemm.cu")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_C_SIGNATURES = {
    # q, k, v, o, lse, bhq, hq, hkv, t, d, causal, block_q, block_k, is_bf16, stream
    "fedml_flash_fwd": [_P] * 5 + [_I] * 9 + [_P],
    # q, k, v, dout, lse, delta, dq, bhq, hq, hkv, t, d, causal, bq, bk, is_bf16, stream
    "fedml_flash_bwd_dq": [_P] * 7 + [_I] * 9 + [_P],
    # q, k, v, dout, lse, delta, dk, dv, bhkv, hq, hkv, t, d, causal, bq, bk, is_bf16, stream
    "fedml_flash_bwd_dkv": [_P] * 8 + [_I] * 9 + [_P],
    # x, wq, scale, y, m, n, k, is_bf16, stream
    "fedml_int8_gemm": [_P] * 4 + [_I] * 4 + [_P],
}
# The kernel designs in csrc/, indexed as flash_common.cuh's enum Design; each
# library counts its successful launches of each (``_Kernels.design_launches``).
DESIGNS = ("simt_f32_fma", "sm90_wgmma_tma")
# The int8 GEMM's designs (int8_gemm.cu's enum Design): the SIMT decode rows
# (M <= 8) and tiled prefill of the f32 path, then the bf16 path's
# mma.sync decode rows and wgmma/TMA prefill (ops/int8_matmul.py design_for).
INT8_DESIGNS = ("gemv_warp", "tiled_simt", "gemv_mma", "sm90_wgmma_tma")
# Set to 1 in a process whose parent built the libraries: it loads them and
# never runs nvcc.
NO_BUILD_ENV = "FEDML_TORCH_KERNELS_PREBUILT"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not found or not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")
    return found


def _source_digest(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(CUDA_FLAGS).encode())
    for path in sorted(csrc.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def _lib_path(src: str, digest: str) -> Path:
    return BUILD_DIR / f"lib{Path(src).stem}_{digest}.so"


def _build_libs(csrc: Path) -> list[Path]:
    """nvcc for every source whose library is missing, all in parallel."""
    digest = _source_digest(csrc)
    missing = [src for src in KERNEL_SOURCES if not _lib_path(src, digest).exists()]
    if missing and os.environ.get(NO_BUILD_ENV) == "1":
        raise RuntimeError(
            f"{', '.join(missing)} not built in {BUILD_DIR} (digest {digest}), and this process "
            f"runs with {NO_BUILD_ENV}=1: its parent builds the kernels (ops/_build.build())")
    nvcc = _nvcc() if missing else None
    jobs = {}
    for src in missing:
        lib = _lib_path(src, digest)
        # written under a temporary name of this process, so a cut build
        # leaves no library and two processes building at once never mix
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *CUDA_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-I", str(csrc),
               "-o", tmp, str(csrc / src)]
        jobs[lib] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    failed = []
    for lib, (tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode:
            failed.append(f"{lib.name}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [_lib_path(src, digest) for src in KERNEL_SOURCES]


def ptxas_report() -> list[str]:
    """One line per compiled kernel of the current build: its name,
    registers a thread, spill stores/loads and static shared memory, from
    the ``-Xptxas -v`` output kept beside the libraries."""
    digest = _source_digest()
    text = "".join(_lib_path(s, digest).with_suffix(".log").read_text()
                   for s in KERNEL_SOURCES if _lib_path(s, digest).with_suffix(".log").exists())
    names, lines, name, spill = [], [], None, ""
    for line in text.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        elif name and (m := re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)):
            smem = f", static smem {m.group(2)} B" if m.group(2) else ""
            names.append(name)
            lines.append(f"{m.group(1)} registers, {spill}{smem}")
            name, spill = None, ""
    return [f"{n}: {line}" for n, line in zip(_demangle(names), lines)]


def ptxas_notes() -> list[str]:
    """ptxas's performance advisories (C75xx, e.g. C7515 "wgmma serialized")
    in the current build's logs; a clean build has none."""
    digest = _source_digest()
    logs = (_lib_path(s, digest).with_suffix(".log") for s in KERNEL_SOURCES)
    return [line.strip() for log in logs if log.exists()
            for line in log.read_text().splitlines() if "C75" in line]


def _demangle(names: list[str]) -> list[str]:
    """Kernel names with their template arguments, without namespaces or
    parameters; the mangled names where c++filt is missing."""
    if not names:
        return []  # c++filt without arguments would read stdin
    try:
        out = subprocess.run(["c++filt", *names], capture_output=True, text=True, timeout=30)
        full = out.stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    if len(full) != len(names):
        return names
    return [re.sub(r"^(?:void )?fedml_(?:flash|int8)::(?:sm90::)?", "", f.split("(")[0])
            for f in full]


class _Kernels:
    """fwd / bwd_dq / bwd_dkv / int8_gemm over the C functions, taking
    tensors."""

    def __init__(self, libs):
        self._libs = libs  # keep the libraries loaded
        self._fns = {}
        for name, argtypes in _C_SIGNATURES.items():
            lib = next(lib for lib in libs if hasattr(lib, name))
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fns[name] = fn

    def design_launches(self, kernel: str) -> dict[str, int]:
        """{design: launches since the library was loaded} of ``kernel``
        ("flash_fwd", "flash_bwd_dq" or "flash_bwd_dkv"), as counted by the
        C entry point where it launched that design's instance."""
        name = f"fedml_{kernel}_launches"
        lib = next(lib for lib in self._libs if hasattr(lib, name))
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
        return {design: fn(i) for i, design in enumerate(DESIGNS)}

    def int8_design_launches(self) -> dict[str, int]:
        """{design: launches since the library was loaded} of the int8 GEMM,
        as its C entry point counted them (``INT8_DESIGNS``)."""
        lib = next(lib for lib in self._libs if hasattr(lib, "fedml_int8_gemm_launches"))
        fn = lib.fedml_int8_gemm_launches
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
        return {design: fn(i) for i, design in enumerate(INT8_DESIGNS)}

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


    def int8_gemm(self, x, wq, scale, y):
        """y [M, N] = x [M, K] . wq [N, K]^T * scale [N] on x's card."""
        self._call("fedml_int8_gemm", x, x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                   y.data_ptr(), x.shape[0], wq.shape[0], x.shape[1])


_BUILD_LOCK = threading.Lock()  # threads of one process build one after another


def build(csrc: Path = CSRC) -> list[Path]:
    """Build every library of the sources in ``csrc`` that is not built yet,
    without loading any; -> the libraries' paths."""
    with _BUILD_LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        return _build_libs(csrc)


def load(csrc: Path = CSRC) -> _Kernels:
    """The kernels of the sources in ``csrc``, built into BUILD_DIR unless a
    library of the same sources and flags is there already (the libraries
    are named by that digest, so other sources never collide with these)."""
    return _Kernels([ctypes.CDLL(str(lib)) for lib in build(csrc)])


@functools.cache
def kernels() -> _Kernels:
    """The built kernels of this package, built once per process."""
    return load()
