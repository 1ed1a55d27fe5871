"""Weight-only int8 quantization for the serving/decode path.

Counterpart of ``fedml_tpu/serving/quant.py``. Autoregressive decode is
bound by the bytes of the weights: every generated token re-reads every
dense kernel. Symmetric per-output-channel int8 halves those bytes against
bf16 (4x against f32); activations, norms, embeddings, LoRA adapters and
the KV cache stay in the model dtype. Opt in with ``quantize_model_int8``
(or ``LLMPredictor.from_checkpoint(quantize="int8")``, or
``FEDML_BENCH_INT8=1`` for the endpoint bench's replicas).

The transform rewrites the port's state dict into the layout
``LoRALinear`` holds under ``weight_quant="int8"``: each 2-D ``weight``
(every dense of ``TransformerLM``, ``lm_head`` included, as in JAX) becomes
``kernel_q`` (int8 ``[out, in]``, torch's layout) and ``kernel_scale`` (f32
``[out]``). The rounding is JAX's, bit for bit: absmax over the input axis,
``absmax / 127`` (1.0 where the absmax is 0), round half to even, clip to
+-127. The arithmetic runs on each tensor's own device (or on ``device``),
so a 7B model on the card is quantized on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn


def quantize_model_int8(cfg, params, device=None):
    """The one way to enable int8 serving: returns (cfg', state') with
    ``weight_quant="int8"`` set and the dense weights rewritten, keeping the
    config flag and the weight layout in lockstep."""
    return dataclasses.replace(cfg, weight_quant="int8"), quantize_params_int8(params, device)


def _state(params) -> Mapping[str, Any]:
    if isinstance(params, nn.Module):
        return params.state_dict()
    if any(isinstance(v, Mapping) for v in params.values()):
        raise TypeError("quantize_params_int8 takes the port's state dict or module; convert "
                        "a JAX-layout tree first (models/convert.params_from_jax)")
    return params


def quantize_params_int8(params, device: Optional[Any] = None) -> Dict[str, torch.Tensor]:
    """Float state dict (or module) -> the int8 weight-only layout.

    Every 2-D ``<dense>.weight`` becomes ``<dense>.kernel_q`` and
    ``<dense>.kernel_scale``; everything else (the embedding, norm scales,
    LoRA factors) passes through unchanged. ``device`` moves each weight
    there before it is quantized (``None``: where it lies). Refuses a state
    in which nothing was quantized."""
    out: Dict[str, torch.Tensor] = {}
    n_rewritten = 0
    for name, value in _state(params).items():
        head, _, leaf = name.rpartition(".")
        if leaf == "weight" and getattr(value, "ndim", 0) == 2:
            w = value.detach().to(device=device, dtype=torch.float32)
            absmax = w.abs().amax(dim=1)  # per output channel
            # a divisor of absmax's shape: PyTorch turns a division by a
            # Python scalar into a product with its reciprocal, which rounds
            # otherwise than numpy's true division
            scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                                torch.ones_like(absmax))
            q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
            prefix = f"{head}." if head else ""
            out[prefix + "kernel_q"] = q
            out[prefix + "kernel_scale"] = scale
            n_rewritten += 1
        else:
            out[name] = value
    if n_rewritten == 0:
        raise ValueError(
            "quantize_params_int8: no 2D 'kernel' leaf found — an unquantized tree next to "
            "weight_quant='int8' would fail at load time")
    return out


def dequantize_params_int8(qparams) -> Dict[str, torch.Tensor]:
    """Inverse layout transform (for tests and checkpoint interop): rebuilds
    float ``weight``s from ``kernel_q * kernel_scale`` in f32."""
    state = _state(qparams)
    out: Dict[str, torch.Tensor] = {}
    for name, value in state.items():
        head, _, leaf = name.rpartition(".")
        prefix = f"{head}." if head else ""
        if leaf == "kernel_q":
            out[prefix + "weight"] = (value.to(torch.float32)
                                      * state[prefix + "kernel_scale"].to(torch.float32)[:, None])
        elif leaf != "kernel_scale":
            out[name] = value
    return out
