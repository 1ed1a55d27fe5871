"""Weight-only int8 matmul for CUDA: the GEMM of int8 decode.

No TPU kernel is ported here. The JAX package computes this product in
``LoRALinear`` under ``weight_quant="int8"`` as ``lax.dot_general`` on the
int8 operand with f32 accumulation (``fedml_tpu/models/transformer.py``),
outside any Pallas kernel, and XLA widens the int8 operand inside its
matmul. PyTorch has no mixed bf16 x s8 product: ``F.linear`` on
``wq.to(bf16)`` would write a bf16 copy of every weight on every decoded
token. ``csrc/int8_gemm.cu`` holds hand-written kernels that read the int8
weights once and widen them on chip (its header gives each design and its
bound); ``design_for`` says which design a call launches.

``int8_matmul(x, wq, scale)`` computes ``cast(scale[n] * sum_k x[..., k] *
float(wq[n, k]))``: x ``[..., K]`` in bf16 or f32, wq ``[N, K]`` int8
(torch's ``[out, in]`` layout), scale ``[N]`` f32, the result ``[..., N]``
in x's dtype, accumulated in f32 with the scale applied in f32 before the
one cast. ``int8_matmul_reference`` is the plain PyTorch version of the
same function. The wrapper takes it only for CPU tensors; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..core import telemetry as tel
from ._build import INT8_DESIGNS

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
K_MULTIPLE = 16  # the kernel reads 16 int8 of a row with one 128-bit load
GEMV_MAX_M = 8  # rows up to this M are decode rows (int8_gemm.cu kGemvMaxM)
MMA_MIN_M = 2  # bf16 decode rows from this M up take gemv_mma (kMmaMinM)

# Launches of the kernel; the wrapper adds one where it launches it and
# nowhere else. The plain version is not counted. Each launch also adds one
# to the telemetry counter LAUNCH_COUNTER, so a serving replica's /metrics
# shows its own launches (fedml_ops_int8_gemm_launches_total).
launch_counts = {"int8_gemm": 0}
LAUNCH_COUNTER = "ops.int8_gemm.launches"
# The same launches by the design ``design_for`` names for each; the C entry
# point counts its own (``_build.kernels().int8_design_launches()``), and the
# card holds the two against each other.
design_counts = {name: 0 for name in INT8_DESIGNS}


def reset_launch_counts() -> None:
    for counts in (launch_counts, design_counts):
        for name in counts:
            counts[name] = 0


def design_for(m: int, dtype: torch.dtype) -> str:
    """The design (``INT8_DESIGNS``) the kernel launches for x [m, K] of
    ``dtype``, as int8_gemm.cu's ``design_for`` picks it: bf16 decode rows
    2 <= m <= 8 on ``gemv_mma`` (mma.sync), bf16 prefills (m > 8) on
    ``sm90_wgmma_tma``, bf16 m = 1 on ``gemv_warp`` (``gemv_mma`` measured
    3% slower there at 4096 x 32000 on an H100, PERF.md); f32 stays on the
    SIMT designs
    (``gemv_warp`` for m <= 8, ``tiled_simt`` above), since the tensor cores
    would need TF32."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"the int8 GEMM takes x in {KERNEL_DTYPES}, got {dtype}")
    if m < 1:
        raise ValueError(f"no design launches for m = {m}")
    if dtype == torch.float32:
        return "gemv_warp" if m <= GEMV_MAX_M else "tiled_simt"
    if m > GEMV_MAX_M:
        return "sm90_wgmma_tma"
    return "gemv_mma" if m >= MMA_MIN_M else "gemv_warp"


def int8_matmul_reference(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The plain version: ``(x.float() @ wq.float().T) * scale``, cast to
    x's dtype (float64 inputs stay float64: a reference free of f32
    rounding, for tests)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = (x.to(acc) @ wq.to(acc).T) * scale.to(acc)
    return y.to(x.dtype)


def check_weights(wq: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise on weights the CUDA kernel does not take. They are constant
    across calls, so a caller that holds them (``LoRALinear``) checks them
    once and passes ``weights_checked=True`` to ``int8_matmul``."""
    if wq.dtype != torch.int8 or wq.dim() != 2:
        raise ValueError(f"wq must be a 2-D int8 [N, K] tensor, got {wq.dtype} {tuple(wq.shape)}")
    if scale.dtype != torch.float32 or scale.shape != (wq.shape[0],):
        raise ValueError(f"scale must be f32 [{wq.shape[0]}], got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if wq.shape[1] % K_MULTIPLE:
        raise ValueError(f"the int8 GEMM takes K a multiple of {K_MULTIPLE}, got wq "
                         f"{tuple(wq.shape)}")
    if wq.shape[0] > 2**31 - 1:
        raise ValueError(f"shapes beyond int32: wq {tuple(wq.shape)}")
    if scale.device != wq.device:
        raise ValueError(f"scale is on {scale.device}, wq on {wq.device}")
    for name, t in (("wq", wq), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def check_x(x: torch.Tensor, wq: torch.Tensor) -> None:
    """Raise on an x (2-D, contiguous and 16-byte aligned) the CUDA kernel
    does not take beside ``wq``."""
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the int8 GEMM takes x in {KERNEL_DTYPES}, got {x.dtype}")
    if x.shape[1] != wq.shape[1]:
        raise ValueError(f"x [M, {x.shape[1]}] does not match wq {tuple(wq.shape)}")
    if x.shape[0] > 2**31 - 1:
        raise ValueError(f"shapes beyond int32: x {tuple(x.shape)}")
    if x.device != wq.device:
        raise ValueError(f"wq is on {wq.device}, x on {x.device}")


def _kernels():
    from ._build import kernels

    return kernels()


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
                weights_checked: bool = False) -> torch.Tensor:
    """x [..., K] . wq [N, K]^T * scale [N] -> [..., N] in x's dtype.
    ``weights_checked``: the caller ran ``check_weights`` on these weights."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, wq, scale)
    if x.device.type != "cuda":
        raise ValueError(f"the int8 GEMM runs on cuda or cpu, not {x.device}")
    if not weights_checked:
        check_weights(wq, scale)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    check_x(x2, wq)
    y = torch.empty((x2.shape[0], wq.shape[0]), dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        if x.device.index == torch.cuda.current_device():
            _kernels().int8_gemm(x2, wq, scale, y)
        else:
            with torch.cuda.device(x.device):  # launch on x's card, not the current one
                _kernels().int8_gemm(x2, wq, scale, y)
        launch_counts["int8_gemm"] += 1
        design_counts[design_for(x2.shape[0], x2.dtype)] += 1
        tel.counter(LAUNCH_COUNTER).add(1)
    return y.reshape(*lead, wq.shape[0])
