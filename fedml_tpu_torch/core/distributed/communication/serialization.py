"""State dict / pytree <-> bytes codec for the WAN boundary: the port's
counterpart of ``fedml_tpu/core/distributed/communication/serialization.py``.

The framing is the JAX package's, byte for byte: a nested dict/list/tuple of
arrays and scalars is flattened to named buffers ``arr0``, ``arr1``, ... in
tree order, packed with ``np.savez`` beside a ``__skeleton__`` JSON that
records the tree's shape and which buffers are bfloat16 (npz has no bf16, so
bf16 travels bit-exactly as uint16 with its dtype recorded). No pickle.

A tensor on any device comes to the host here and nowhere else
(``.detach().cpu()``, where the JAX package calls ``jax.device_get``).
Leaves decode to CPU tensors. bfloat16 decodes without ``ml_dtypes`` (a JAX
dependency): the uint16 buffer is reinterpreted as int16 and viewed as
``torch.bfloat16``.
"""

from __future__ import annotations

import io
import json
from typing import Any, List, Tuple

import numpy as np
import torch

BF16 = "bfloat16"


def _wire_leaf(obj: Any) -> Tuple[np.ndarray, str]:
    """(contiguous host buffer npz can hold, the leaf's dtype name)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(obj)
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == BF16:  # a numpy bf16 array (ml_dtypes), if a caller has one
        return arr.view(np.uint16), BF16
    return arr, arr.dtype.name


def flatten_tree(obj: Any, out: List[Tuple[np.ndarray, str]]) -> Any:
    """Returns a JSON-able structure skeleton; each leaf's host buffer and
    dtype name are appended to ``out`` in tree order and referenced by
    index."""
    if isinstance(obj, dict):
        return {k: flatten_tree(v, out) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        kind = "list" if isinstance(obj, list) else "tuple"
        return {"__seq__": kind, "items": [flatten_tree(v, out) for v in obj]}
    if obj is None:
        return {"__none__": True}
    out.append(_wire_leaf(obj))
    return {"__leaf__": len(out) - 1}


def unflatten_tree(skel: Any, leaves: List[Any]) -> Any:
    if isinstance(skel, dict):
        if "__leaf__" in skel:
            ref = skel["__leaf__"]
            if isinstance(ref, str):  # pre-TRPC format: "arrN" string refs
                ref = int(ref[3:])
            return leaves[ref]
        if "__none__" in skel:
            return None
        if "__seq__" in skel:
            items = [unflatten_tree(s, leaves) for s in skel["items"]]
            return items if skel["__seq__"] == "list" else tuple(items)
        return {k: unflatten_tree(v, leaves) for k, v in skel.items()}
    raise ValueError(f"bad skeleton node {skel!r}")


def from_wire(buf: np.ndarray, dtype_name: str) -> Any:
    """A decoded buffer as a CPU tensor (numpy's own array where torch has no
    dtype for it, e.g. strings)."""
    if dtype_name == BF16:
        return torch.from_numpy(buf.view(np.int16)).view(torch.bfloat16)
    try:
        return torch.from_numpy(buf)
    except TypeError:
        return buf


def serialize_pytree(tree: Any) -> bytes:
    flat: List[Tuple[np.ndarray, str]] = []
    skel = flatten_tree(tree, flat)
    buf = io.BytesIO()
    meta_dtypes = {}
    packed = {}
    for i, (w, dname) in enumerate(flat):
        if dname != w.dtype.name:
            meta_dtypes[f"arr{i}"] = dname
        packed[f"arr{i}"] = w
    packed["__skeleton__"] = np.frombuffer(
        json.dumps({"skel": skel, "bf16": meta_dtypes}).encode(), dtype=np.uint8
    )
    np.savez(buf, **packed)
    return buf.getvalue()


def deserialize_pytree(data: bytes) -> Any:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__skeleton__"].tobytes()).decode())
        leaves: List[Any] = []
        i = 0
        while f"arr{i}" in z.files:
            a = z[f"arr{i}"]
            leaves.append(from_wire(a, meta["bf16"].get(f"arr{i}", a.dtype.name)))
            i += 1
    return unflatten_tree(meta["skel"], leaves)
