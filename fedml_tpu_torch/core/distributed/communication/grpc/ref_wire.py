"""Reference-FedML wire compatibility: the port's counterpart of
``fedml_tpu/core/distributed/communication/grpc/ref_wire.py``.

The reference's gRPC protocol (``core/distributed/communication/grpc/
grpc_comm_manager.py:78-108`` + ``proto/grpc_comm_manager.proto``) is:

    service gRPCCommManager { rpc sendMessage(CommRequest) returns (CommResponse) }
    message CommRequest { int32 client_id = 1; bytes message = 2; }

where ``message`` is ``pickle.dumps`` of its ``Message`` object (msg_params
dict carrying torch state dicts). This module speaks that format with a
hand-rolled two-field protobuf codec (no protoc) and a restricted pickle
bridge. The MQTT_S3 reference bucket (``mqtt_s3/ref_bucket.py``) shares the
bridge.

The payload is the JAX package's: the model params in the flax wire layout
(``models/convert.py``; ``FedMLCommManager`` converts a state dict before a
byte backend sends it) as torch tensors, with an ``OrderedDict`` at the
top. Decoded payloads are trees of CPU tensors.

Pickle policy: pickle is the reference's choice, not the port's (its native
wires are ``codec.py`` and the TRPC frame). Here it is accepted for interop
and loaded through an allowlisting Unpickler limited to tensor/array
reconstruction globals; arbitrary callables are refused, and the inner
``torch.storage._load_from_bytes`` is replaced by
``torch.load(weights_only=True)``.

This module imports no ``grpc`` and no ``ml_dtypes``.
"""

from __future__ import annotations

import collections
import io
import pickle
import sys
import types
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..message import Message

REF_SERVICE = "gRPCCommManager"
REF_METHOD_SEND = "sendMessage"
REF_MESSAGE_MODULE = "fedml.core.distributed.communication.message"


# --- minimal protobuf codec (CommRequest / CommResponse) ---------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = data[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def encode_comm_request(client_id: int, message: bytes) -> bytes:
    out = b""
    if client_id:
        out += b"\x08" + _varint(client_id)  # field 1, varint
    out += b"\x12" + _varint(len(message)) + message  # field 2, bytes
    return out


def decode_comm_request(data: bytes) -> Tuple[int, bytes]:
    client_id, message = 0, b""
    i = 0
    while i < len(data):
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, i = _read_varint(data, i)
            if field == 1:
                client_id = val
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(data, i)
            if field == 2:
                message = data[i:i + ln]
            i += ln
        elif wire == 5:  # 32-bit
            i += 4
        elif wire == 1:  # 64-bit
            i += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
    return client_id, message


# --- the reference Message class (real if importable, shim otherwise) --------

def _ensure_ref_message_class() -> type:
    """The class pickled messages resolve to. If the reference package, or a
    shim another module already registered under its path (the JAX
    package's, in a process that loads both), is importable, that class is
    used; otherwise a structural shim is installed under the same module
    path. The reference ``Message`` is a plain-attribute object, so default
    NEWOBJ pickling round-trips either way."""
    try:
        mod = __import__(REF_MESSAGE_MODULE, fromlist=["Message"])
        return mod.Message
    except Exception:
        pass
    if REF_MESSAGE_MODULE in sys.modules and hasattr(sys.modules[REF_MESSAGE_MODULE], "Message"):
        return sys.modules[REF_MESSAGE_MODULE].Message

    class Message:  # matches reference message.py:5 attribute layout
        def __init__(self, type="default", sender_id=0, receiver_id=0):
            self.type = str(type)
            self.sender_id = sender_id
            self.receiver_id = receiver_id
            self.msg_params = {"msg_type": type, "sender": sender_id, "receiver": receiver_id}

    # register the module chain so pickle's save_global/find_class resolve
    parts = REF_MESSAGE_MODULE.split(".")
    for i in range(1, len(parts) + 1):
        name = ".".join(parts[:i])
        if name not in sys.modules:
            m = types.ModuleType(name)
            m.__path__ = []
            m.__fedml_tpu_shim__ = True  # marks a shim, so a test can drop it
            sys.modules[name] = m
            if i > 1:
                setattr(sys.modules[".".join(parts[:i - 1])], parts[i - 1], m)
    Message.__module__ = REF_MESSAGE_MODULE
    Message.__qualname__ = "Message"
    sys.modules[REF_MESSAGE_MODULE].Message = Message
    return Message


# --- payload tree conversion -------------------------------------------------

def _np_to_torch(arr: np.ndarray) -> torch.Tensor:
    """torch.from_numpy with bf16: a numpy bfloat16 array (``ml_dtypes``,
    which a peer may have) goes through its uint16 bits, read by dtype name
    so this module needs no ``ml_dtypes``."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_torch_tree(obj: Any) -> Any:
    """numpy leaves -> torch tensors (what reference trainers expect, and
    the port's own leaf); tensors are detached and brought to the host."""
    if isinstance(obj, dict):  # an OrderedDict stays one
        return type(obj)((k, _to_torch_tree(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_torch_tree(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return _np_to_torch(obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    return obj


# --- restricted unpickler ----------------------------------------------------

# Exact reconstruction globals that pickles of tensor/array payloads need
# (torch state dicts incl. bf16/f16, numpy arrays/scalars/dtypes). Not
# prefix-wide: torch.hub.load / torch.load / numpy.lib gadget callables stay
# refused. The JAX package's list.
_ALLOWED_GLOBALS = {
    ("collections", "OrderedDict"),
    ("numpy", "dtype"),
    ("numpy", "ndarray"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "_reconstruct"),  # pre-numpy-2 peers
    ("numpy.core.multiarray", "scalar"),
    ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_tensor"),
    ("torch._utils", "_rebuild_parameter"),
    ("torch.serialization", "_get_layout"),
    ("_codecs", "encode"),
}


def _safe_load_from_bytes(b: bytes):
    """Replacement for ``torch.storage._load_from_bytes``: the real one is
    ``torch.load(weights_only=False)``, an unrestricted inner unpickle that
    would void this module's allowlist. weights_only mode uses torch's own
    restricted unpickler and still loads every legitimate tensor payload."""
    return torch.load(io.BytesIO(b), weights_only=True)


_ALLOWED_BUILTINS = {
    "int", "float", "complex", "bool", "str", "bytes", "bytearray",
    "list", "tuple", "dict", "set", "frozenset", "slice", "range",
}
# torch dtype/size objects pickle as plain attribute globals of the torch
# module itself (e.g. torch.bfloat16, torch.Size): data, not callables
_ALLOWED_TORCH_ATTRS = {
    "Size", "device",
    "float32", "float64", "float16", "bfloat16",
    "int8", "int16", "int32", "int64", "uint8", "uint16", "bool",
    "FloatStorage", "DoubleStorage", "HalfStorage", "BFloat16Storage",
    "LongStorage", "IntStorage", "ShortStorage", "CharStorage",
    "ByteStorage", "BoolStorage",
}


class _RefUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == REF_MESSAGE_MODULE and name == "Message":
            return _ensure_ref_message_class()
        if (module, name) == ("torch.storage", "_load_from_bytes"):
            return _safe_load_from_bytes
        if (module, name) in _ALLOWED_GLOBALS:
            return super().find_class(module, name)
        if module == "torch" and name in _ALLOWED_TORCH_ATTRS:
            return super().find_class(module, name)
        if module == "builtins" and name in _ALLOWED_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"ref-wire refuses global {module}.{name} (not tensor/message data)"
        )


# --- Message <-> wire --------------------------------------------------------

def encode_ref_message(msg: Message, sender_id: int) -> bytes:
    """A port Message -> CommRequest bytes the reference servicer accepts."""
    RefMessage = _ensure_ref_message_class()
    ref = RefMessage.__new__(RefMessage)
    params = dict(msg.get_params())
    if Message.MSG_ARG_KEY_MODEL_PARAMS in params:
        params[Message.MSG_ARG_KEY_MODEL_PARAMS] = _as_ref_state_dict(
            _to_torch_tree(params[Message.MSG_ARG_KEY_MODEL_PARAMS])
        )
    ref.__dict__.update(
        type=str(msg.get_type()),
        sender_id=msg.get_sender_id(),
        receiver_id=msg.get_receiver_id(),
        msg_params=params,
    )
    return encode_comm_request(sender_id, pickle.dumps(ref))


def decode_ref_message(data: bytes) -> Message:
    """CommRequest bytes from a reference (or JAX) peer -> a port Message,
    its array leaves as CPU tensors."""
    _, payload = decode_comm_request(data)
    ref = _RefUnpickler(io.BytesIO(payload)).load()
    params: Dict[str, Any] = _to_torch_tree(dict(ref.msg_params))
    msg = Message()
    msg.init_from_json_object(params)
    return msg


# --- raw payload-tree bridge (shared with the MQTT_S3 ref-wire store) --------

def _as_ref_state_dict(obj: Any) -> Any:
    """Top-level model params must be an OrderedDict, as torch state dicts
    are: the reference's FedMLAggregator.aggregate treats a plain dict as a
    per-client-index personalized-model map and indexes it by client number
    (``fedml_aggregator.py:90-97``). OrderedDict (what reference clients
    themselves upload) takes the state-dict path."""
    if type(obj) is dict:
        return collections.OrderedDict(obj)
    return obj


def pickle_ref_tree(params: Any) -> bytes:
    """Parameter tree -> the reference's S3 payload format: ``pickle.dumps``
    of a torch-tensor tree (``s3/remote_storage.py:75-113`` write_model;
    reference clients unpickle this and feed load_state_dict)."""
    return pickle.dumps(_as_ref_state_dict(_to_torch_tree(params)))


def unpickle_ref_tree(data: bytes, encoding: str = "ASCII") -> Any:
    """Reference S3 payload bytes -> a tree of CPU tensors, through the same
    restricted unpickler the gRPC bridge uses (arbitrary callables refused).

    ``encoding='bytes'`` reads Python-2-era pickles, whose string payloads
    are raw bytes that the default ASCII decode rejects."""
    return _to_torch_tree(_RefUnpickler(io.BytesIO(data), encoding=encoding).load())
