"""Per-device-kind accelerator datasheet: dense peak FLOP/s by dtype, HBM
capacity, HBM bandwidth.

Counterpart of ``fedml_tpu/core/distributed/device_specs.py``, for the cards
the port runs on: NVIDIA H100 rows only (a TPU row is a TPU's size, not the
port's). The devperf registry (``core/telemetry/devperf.py``) divides by
these peaks. Lookups match by SUBSTRING against the lowercased device name
(``torch.cuda.get_device_name()``), most specific row first: ``"h100
pcie"``, ``"h100 nvl"``, then ``"h100"`` (the SXM card reports ``NVIDIA H100
80GB HBM3``).

Every value is NVIDIA's H100 datasheet, dense (the datasheet's tensor-core
figures are with 2:4 sparsity, twice these). Unlike the JAX table's rule
"f32 = bf16 / 2", a Hopper card's f32 without tensor cores runs at about a
fifteenth of bf16, so each lookup takes the dtype. An unknown device keeps
the JAX package's defaults (2 TFLOP/s at 16 bits, half that at 32, 50 GB/s),
so the CPU tests still have a peak.

Pure Python on purpose: no torch import, so tools can read the tables
without a device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# dtype names (``str(torch_dtype)`` less its ``torch.`` prefix) and their bits
_DTYPE_BITS = {"bfloat16": 16, "float16": 16, "tfloat32": 32, "float32": 32}

# Dense peak TFLOP/s by dtype. bf16/f16/tf32 on the tensor cores; f32 on the
# CUDA cores (what a plain f32 matmul gets with TF32 off).
PEAK_TFLOPS: List[Tuple[str, Dict[str, float]]] = [
    ("h100 pcie", {"bfloat16": 756.5, "float16": 756.5, "tfloat32": 378.0,
                   "float32": 51.0}),
    ("h100 nvl", {"bfloat16": 835.5, "float16": 835.5, "tfloat32": 417.5,
                  "float32": 60.0}),
    ("h100", {"bfloat16": 989.4, "float16": 989.4, "tfloat32": 494.7,
              "float32": 66.9}),        # SXM5
]

# Unknown device (the CPU tests): the JAX package's modest 2 TFLOP/s at 16
# bits (half at 32), so MFU guards still trip on absurd rates.
UNKNOWN_PEAK_TFLOPS = 2.0

# Datasheet HBM per card (the datasheet's "80GB" is the card's 80 GiB of
# HBM, of which the CUDA runtime keeps a little; the sampler reads the
# runtime's own total first).
HBM_BYTES_BY_DEVICE_KIND: List[Tuple[str, int]] = [
    ("h100 pcie", 80 * 2**30),
    ("h100 nvl", 94 * 2**30),
    ("h100", 80 * 2**30),
]

HBM_BANDWIDTH_BYTES_PER_S: List[Tuple[str, float]] = [
    ("h100 pcie", 2.0e12),
    ("h100 nvl", 3.9e12),
    ("h100", 3.35e12),
]

# Unknown device: a host-DRAM-ish 50 GB/s keeps roofline verdicts defined.
UNKNOWN_BANDWIDTH_BYTES_PER_S = 50e9


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` / ``"bfloat16"`` / ``"torch.bfloat16"`` ->
    ``"bfloat16"``."""
    return str(dtype).rsplit(".", 1)[-1]


def device_row(device_kind: str) -> Optional[str]:
    """The table row ``device_kind`` matches (``"h100 pcie"``, ``"h100 nvl"``,
    ``"h100"``), or None for an unknown device."""
    kind = str(device_kind).lower()
    for key, _ in PEAK_TFLOPS:
        if key in kind:
            return key
    return None


def peak_tflops(device_kind: str, dtype="bfloat16") -> float:
    """Dense peak TFLOP/s of ``device_kind`` in ``dtype``;
    :data:`UNKNOWN_PEAK_TFLOPS` (half of it at 32 bits) when unrecognised."""
    name = dtype_name(dtype)
    if name not in _DTYPE_BITS:
        raise ValueError(f"no peak for dtype {name!r} (one of {sorted(_DTYPE_BITS)})")
    kind = str(device_kind).lower()
    for key, peaks in PEAK_TFLOPS:
        if key in kind:
            return peaks[name]
    return UNKNOWN_PEAK_TFLOPS if _DTYPE_BITS[name] == 16 else UNKNOWN_PEAK_TFLOPS / 2.0


def peak_flops_per_sec(device_kind: str, dtype="bfloat16") -> float:
    return peak_tflops(device_kind, dtype) * 1e12


def device_hbm_bytes(device_kind: str) -> Optional[int]:
    """Datasheet HBM capacity of one card; None when unrecognised."""
    kind = str(device_kind).lower()
    for sub, cap in HBM_BYTES_BY_DEVICE_KIND:
        if sub in kind:
            return cap
    return None


def hbm_bandwidth_bytes_per_sec(device_kind: str) -> float:
    kind = str(device_kind).lower()
    for sub, bw in HBM_BANDWIDTH_BYTES_PER_S:
        if sub in kind:
            return bw
    return UNKNOWN_BANDWIDTH_BYTES_PER_S


def roofline_ridge_flops_per_byte(device_kind: str, dtype="bfloat16") -> float:
    """Operational intensity (FLOPs/byte) where the compute ceiling meets
    the bandwidth slope: programs above it are compute-bound."""
    return peak_flops_per_sec(device_kind, dtype) / hbm_bandwidth_bytes_per_sec(device_kind)
