"""Update compression: Top-K sparsification (with error feedback) and
QSGD-style stochastic quantization. Counterpart of
``fedml_tpu/utils/compression.py`` (reference
``python/fedml/utils/compression.py``: TopKCompressor:21,
EFTopKCompressor:139, QuantizationCompressor:175, QSGDCompressor:210).

The functions run on the tensor's device (``torch.topk`` where the JAX
package calls ``jax.lax.top_k``); the class facades keep the reference's
``compress`` / ``decompress_new`` shape with per-name residual state. QSGD
draws from an explicit ``torch.Generator`` where the JAX package splits a
PRNG key.

The uplink compressor (:class:`CommCompressor`, ``args.comm_compressor``)
compresses the whole model as ONE f32 vector in the state dict's order
(``utils/pytree.py`` ``tree_flatten_to_vector``), so top-k ranks
magnitudes globally. Its payload is a dict of tensors on the compressing
device, with the flat spec (the state dict's names, shapes and dtypes) in
place of the JAX package's treedef. Indexes travel as int32, as
``jax.lax.top_k`` returns them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Functional kernels
# ---------------------------------------------------------------------------


def topk_compress(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the k largest-|.| entries of flat x: returns (values, indexes),
    by decreasing magnitude."""
    flat = x.reshape(-1)
    _, idx = torch.topk(flat.abs(), int(k))
    return flat[idx], idx


def topk_decompress(values: torch.Tensor, indexes: torch.Tensor, size: int) -> torch.Tensor:
    """Scatter values back into a dense zero vector of ``size``."""
    out = torch.zeros(int(size), dtype=values.dtype, device=values.device)
    out[indexes.long()] = values
    return out


def ef_topk_step(state_x: Tuple[torch.Tensor, torch.Tensor], k: int):
    """Error-feedback Top-K: compress (residual + x), keep what was dropped
    as the next residual. ``state_x = (residual, x)``; returns
    ``((values, indexes), new_residual)``."""
    residual, x = state_x
    corrected = residual + x.reshape(-1)
    values, idx = topk_compress(corrected, k)
    return (values, idx), corrected.index_fill_(0, idx, 0.0)


def _quant_scale(flat: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(flat)
    return torch.where(n == 0, torch.ones_like(n), n)


def qsgd_quantize(generator: Optional[torch.Generator], x: torch.Tensor, s: int,
                  biased: bool = True) -> torch.Tensor:
    """QSGD: q(x)_i = ||x|| * sign(x_i) * xi_i / s where xi is the stochastic
    rounding of s*|x_i|/||x|| (reference get_qsgd compression.py:220-235).
    ``biased=True`` multiplies by the variance-bound factor
    1/(1 + min(d/s^2, sqrt(d)/s)) (Alistarh et al. 2017, Lemma 3.1), as the
    reference does."""
    flat = x.reshape(-1)
    norm = _quant_scale(flat)
    level = s * flat.abs() / norm
    lo = torch.floor(level)
    prob = level - lo
    rnd = torch.rand(flat.shape, generator=generator, dtype=flat.dtype, device=flat.device)
    q = lo + (rnd < prob).to(flat.dtype)
    out = torch.sign(flat) * q * (norm / s)
    if biased:
        d = flat.numel()
        out = out / (1.0 + min(d / (s * s), np.sqrt(d) / s))
    return out.reshape(x.shape)


def naive_quantize(x: torch.Tensor, s: int, biased: bool = True) -> torch.Tensor:
    """Deterministic mid-rise quantizer (reference get_naive_quantize:185)."""
    flat = x.reshape(-1)
    norm = _quant_scale(flat)
    q = torch.floor(s * flat.abs() / norm)
    return (torch.sign(flat) * q * (norm / s)).reshape(x.shape)


# state-dict helpers -------------------------------------------------------


def tree_topk_compress(tree: StateDict, ratio: float) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Per-leaf Top-K with k = ceil(ratio * numel): ``{name: (values, indexes)}``."""
    return {name: topk_compress(x, max(1, int(np.ceil(x.numel() * ratio))))
            for name, x in tree.items()}


def tree_topk_decompress(compressed: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                         like: StateDict) -> StateDict:
    return {name: topk_decompress(v, i, like[name].numel()).reshape(like[name].shape)
            for name, (v, i) in compressed.items()}


# ---------------------------------------------------------------------------
# Class facades (reference API shape)
# ---------------------------------------------------------------------------


class NoneCompressor:
    def compress(self, tensor, name=None, **_):
        return tensor, None, tensor

    def decompress_new(self, tensor, indexes=None, name=None, shape=None):
        return tensor


class TopKCompressor:
    """Sparse top-k by magnitude (Aji & Heafield 2017)."""

    def __init__(self):
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self.current_ratio = 1.0

    def compress(self, tensor, name: Optional[str] = None, ratio: float = 0.05):
        x = torch.as_tensor(tensor)
        self.shapes[name] = tuple(x.shape)
        self.current_ratio = ratio
        k = max(1, int(x.numel() * ratio))
        values, indexes = topk_compress(x, k)
        return x, indexes, values

    def decompress_new(self, values, indexes, name: Optional[str] = None, shape=None):
        shape = shape or self.shapes[name]
        size = int(np.prod(shape))
        return topk_decompress(torch.as_tensor(values), torch.as_tensor(indexes), size).reshape(shape)


class EFTopKCompressor(TopKCompressor):
    """Top-K with error feedback: dropped mass re-enters next round
    (reference EFTopKCompressor:139)."""

    def __init__(self):
        super().__init__()
        self.residuals: Dict[str, torch.Tensor] = {}

    def compress(self, tensor, name: Optional[str] = None, ratio: float = 0.05):
        x = torch.as_tensor(tensor)
        self.shapes[name] = tuple(x.shape)
        self.current_ratio = ratio
        k = max(1, int(x.numel() * ratio))
        residual = self.residuals.get(name)
        if residual is None:
            residual = torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
        (values, indexes), new_residual = ef_topk_step((residual, x), k)
        self.residuals[name] = new_residual
        return x, indexes, values

    def clear(self):
        self.residuals = {}


class QuantizationCompressor:
    def __init__(self):
        self.shapes: Dict[str, Tuple[int, ...]] = {}

    def compress(self, tensor, name=None, quantize_level: int = 32, is_biased: bool = True):
        x = torch.as_tensor(tensor)
        self.shapes[name] = tuple(x.shape)
        if quantize_level >= 32:
            return x
        return naive_quantize(x, 2**quantize_level - 1, is_biased)

    def decompress_new(self, tensor):
        return tensor


class QSGDCompressor:
    """QSGD over a ``torch.Generator`` seeded with ``seed`` (made on the
    first tensor's device)."""

    def __init__(self, seed: int = 0):
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self._seed = int(seed)
        self._gen: Optional[torch.Generator] = None

    def compress(self, tensor, name=None, quantize_level: int = 32, is_biased: bool = True):
        x = torch.as_tensor(tensor)
        self.shapes[name] = tuple(x.shape)
        if quantize_level >= 32:
            return x
        if self._gen is None:
            self._gen = torch.Generator(device=x.device).manual_seed(self._seed)
        return qsgd_quantize(self._gen, x, 2**quantize_level - 1, is_biased)

    def decompress_new(self, tensor):
        return tensor


compressors = {
    "no": NoneCompressor,
    "topk": TopKCompressor,
    "eftopk": EFTopKCompressor,
    "quantize": QuantizationCompressor,
    "qsgd": QSGDCompressor,
}


# ---------------------------------------------------------------------------
# Comm-boundary wiring (opt-in via args.comm_compressor)
# ---------------------------------------------------------------------------

COMM_PAYLOAD_KEY = "__comm_compressed__"

_SPARSE_KINDS = ("topk", "eftopk")
_DENSE_KINDS = ("quantize", "qsgd")


class CommCompressor:
    """Stateful client-side compressor for model uploads.

    ``eftopk`` keeps the error-feedback residual across uploads (one
    residual per client, in flat space). Decompression is stateless; the
    server uses :func:`decompress_comm_payload`."""

    def __init__(self, kind: str, ratio: float = 0.05, quantize_level: int = 8, seed: int = 0):
        if kind not in _SPARSE_KINDS + _DENSE_KINDS:
            raise ValueError(
                f"unknown comm compressor {kind!r}; pick one of "
                f"{sorted(_SPARSE_KINDS + _DENSE_KINDS)} (or unset args.comm_compressor)")
        self.kind = kind
        self.ratio = float(ratio)
        self.quantize_level = int(quantize_level)
        self._residual: Optional[torch.Tensor] = None
        self._seed = int(seed)
        self._gen: Optional[torch.Generator] = None

    def compress_tree(self, tree: StateDict) -> Dict[str, Any]:
        """State dict -> payload dict (tensors on the tree's device and the
        flat spec)."""
        from .pytree import tree_flatten_to_vector

        flat, spec = tree_flatten_to_vector(tree, torch.float32)
        size = int(flat.numel())
        payload: Dict[str, Any] = {COMM_PAYLOAD_KEY: True, "kind": self.kind,
                                   "spec": spec, "size": size}
        if self.kind in _SPARSE_KINDS:
            k = max(1, min(size, int(math.ceil(size * self.ratio))))
            if self.kind == "eftopk":
                if self._residual is None or self._residual.numel() != size \
                        or self._residual.device != flat.device:
                    self._residual = torch.zeros(size, dtype=flat.dtype, device=flat.device)
                (values, indexes), self._residual = ef_topk_step((self._residual, flat), k)
            else:
                values, indexes = topk_compress(flat, k)
            payload["values"] = values
            payload["indexes"] = indexes.to(torch.int32)
        else:
            s = 2 ** self.quantize_level - 1
            if self.kind == "qsgd":
                if self._gen is None:
                    self._gen = torch.Generator(device=flat.device).manual_seed(self._seed)
                payload["dense"] = qsgd_quantize(self._gen, flat, s, True)
            else:
                payload["dense"] = naive_quantize(flat, s, True)
        return payload

    def reset(self) -> None:
        self._residual = None


def payload_nbytes(payload: Dict[str, Any]) -> int:
    """The bytes of a payload's tensors (values and indexes, or the dense
    vector): what the uplink carries besides the spec."""
    return sum(v.numel() * v.element_size() for v in payload.values()
               if isinstance(v, torch.Tensor))


def is_comm_payload(obj: Any) -> bool:
    return isinstance(obj, dict) and bool(obj.get(COMM_PAYLOAD_KEY))


def decompress_comm_payload(payload: Dict[str, Any]) -> StateDict:
    """Payload -> state dict (stateless; server side), on the payload's
    device."""
    from .pytree import tree_unflatten_from_vector

    size = int(payload["size"])
    if payload["kind"] in _SPARSE_KINDS:
        flat = topk_decompress(payload["values"], payload["indexes"], size)
    else:
        flat = payload["dense"]
    return tree_unflatten_from_vector(flat, payload["spec"])


def secagg_support(nonce: int, size: int, ratio: float) -> np.ndarray:
    """Window-seeded shared sparse support for masked uplinks: rand-k
    seeded by the window nonce gives every cohort member (and the server)
    the same k coordinates with no index array on the wire (SecAgg masks
    cancel coordinate-wise, so a masked cohort must share one support)."""
    k = max(1, min(int(size), int(np.ceil(int(size) * float(ratio)))))
    rng = np.random.default_rng(int(nonce) & 0xFFFFFFFFFFFFFFFF)
    return np.sort(rng.choice(int(size), size=k, replace=False))


def make_comm_compressor(args: Any) -> Optional[CommCompressor]:
    """Build the upload compressor from args (None when not configured)."""
    kind = getattr(args, "comm_compressor", None)
    if not kind or str(kind).lower() in ("no", "none"):
        return None
    return CommCompressor(
        str(kind).lower(),
        ratio=float(getattr(args, "comm_compressor_ratio", 0.05)),
        quantize_level=int(getattr(args, "comm_compressor_level", 8)),
        seed=int(getattr(args, "comm_compressor_seed", 0)),
    )
