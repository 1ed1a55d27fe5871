"""Minimal self-contained safetensors reader/writer: counterpart of
``fedml_tpu/train/llm/safetensors_io.py``.

The reference loads pretrained checkpoints through HF transformers
(``train/llm/hf_trainer.py:28``, ``configurations.py:141``
``ModelArguments.model_name_or_path``); the on-disk format of modern HF
checkpoints is safetensors: an 8-byte little-endian u64 header length, a
JSON header mapping each tensor's name to {dtype, shape, data_offsets}, then
one raw byte buffer. Written directly, with neither the ``safetensors``
package nor ``ml_dtypes``: numpy has no bfloat16 without the latter, so a
``BF16`` tensor is read as its uint16 bits and viewed as a CPU
``torch.bfloat16`` tensor (the convention of ``models/convert.py``: leaves
are numpy arrays, bfloat16 ones CPU tensors). Every other dtype is a numpy
array.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

Leaf = Union[np.ndarray, torch.Tensor]

_DTYPE_BY_NAME: Dict[str, Any] = {
    "F64": np.dtype(np.float64),
    "F32": np.dtype(np.float32),
    "F16": np.dtype(np.float16),
    "I64": np.dtype(np.int64),
    "I32": np.dtype(np.int32),
    "I16": np.dtype(np.int16),
    "I8": np.dtype(np.int8),
    "U8": np.dtype(np.uint8),
    "BOOL": np.dtype(np.bool_),
}
_NAME_BY_DTYPE = {v: k for k, v in _DTYPE_BY_NAME.items()}


def load_safetensors(path: str) -> Dict[str, Leaf]:
    """Read one .safetensors file into {name: ndarray (bf16: CPU tensor)}.
    The file is read once into one writable buffer and every tensor is a
    view of it (no copy per tensor)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        buf = bytearray(os.fstat(f.fileno()).st_size - 8 - header_len)
        f.readinto(buf)
    out: Dict[str, Leaf] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(buf, np.uint16, (end - start) // 2, start)
            out[name] = torch.from_numpy(bits.reshape(info["shape"])).view(torch.bfloat16)
            continue
        dtype = _DTYPE_BY_NAME[info["dtype"]]
        arr = np.frombuffer(buf, dtype, (end - start) // dtype.itemsize, start)
        out[name] = arr.reshape(info["shape"])
    return out


def _raw(name: str, value: Leaf):
    """(safetensors dtype name, shape, a contiguous array of the bytes) of
    one leaf."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "BF16", list(t.shape), t.view(torch.int16).numpy()
        value = t.numpy()
    arr = np.ascontiguousarray(value)
    dt = _NAME_BY_DTYPE.get(arr.dtype)
    if dt is None:
        raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
    return dt, list(arr.shape), arr


def save_safetensors(
    tensors: Dict[str, Leaf], path: str, metadata: Optional[Dict[str, str]] = None
) -> None:
    """Write {name: ndarray or CPU tensor} as a .safetensors file (the JAX
    package's header layout, so the same tensors give the same bytes)."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = metadata
    blobs = []
    offset = 0
    for name, value in tensors.items():
        dt, shape, arr = _raw(name, value)
        header[name] = {"dtype": dt, "shape": shape, "data_offsets": [offset, offset + arr.nbytes]}
        blobs.append(arr)
        offset += arr.nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for arr in blobs:
            f.write(memoryview(arr.reshape(-1)).cast("B"))


def load_checkpoint_tensors(model_dir: str) -> Dict[str, Leaf]:
    """Load all tensors from an HF-style checkpoint directory: either a single
    ``model.safetensors`` or a sharded ``model.safetensors.index.json``."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    single = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(index):
        with open(index) as f:
            weight_map: Dict[str, str] = json.load(f)["weight_map"]
        out: Dict[str, Leaf] = {}
        for shard in sorted(set(weight_map.values())):
            out.update(load_safetensors(os.path.join(model_dir, shard)))
        return out
    if os.path.exists(single):
        return load_safetensors(single)
    # any lone *.safetensors file
    cands = [f for f in os.listdir(model_dir) if f.endswith(".safetensors")]
    if len(cands) == 1:
        return load_safetensors(os.path.join(model_dir, cands[0]))
    raise FileNotFoundError(f"no safetensors checkpoint found in {model_dir}")
