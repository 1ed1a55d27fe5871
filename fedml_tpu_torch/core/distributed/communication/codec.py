"""Message <-> bytes framing shared by the networked backends: a copy of
``fedml_tpu/core/distributed/communication/codec.py``, byte for byte the
same frame.

Layout: ``[4-byte BE header length][header JSON][payload npz bytes]`` where
the header is the control-plane JSON (Message.to_json) and the payload is
the ``model_params`` pytree via serialization.py. No pickle anywhere
(contrast: reference s3/remote_storage.py:81).
"""

from __future__ import annotations

import json
import struct

from .message import Message
from .serialization import deserialize_pytree, serialize_pytree


def message_to_bytes(msg: Message) -> bytes:
    header = msg.to_json().encode()
    payload = b""
    params = msg.get_params().get(Message.MSG_ARG_KEY_MODEL_PARAMS)
    if params is not None:
        payload = serialize_pytree(params)
    return struct.pack(">I", len(header)) + header + payload


def message_from_bytes(data: bytes) -> Message:
    """Decode one frame. A truncated or corrupt frame raises ``ValueError``
    (retryable by core.resilience.retry) rather than a confusing
    struct/json/KeyError deep in a backend's receive loop."""
    if len(data) < 4:
        raise ValueError(
            f"truncated frame: {len(data)} bytes, need >= 4 for the header length"
        )
    (hlen,) = struct.unpack(">I", data[:4])
    if 4 + hlen > len(data):
        raise ValueError(
            f"truncated frame: header claims {hlen} bytes but only "
            f"{len(data) - 4} follow the length prefix"
        )
    try:
        header = json.loads(data[4 : 4 + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ValueError(f"corrupt frame header: {exc}") from exc
    if not isinstance(header, dict):
        raise ValueError(f"corrupt frame header: expected JSON object, got {type(header).__name__}")
    msg = Message()
    msg.init_from_json_object(header)
    payload = data[4 + hlen :]
    if payload:
        try:
            msg.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, deserialize_pytree(payload))
        except Exception as exc:  # noqa: BLE001 - npz corruption surfaces many types
            raise ValueError(f"corrupt frame payload: {exc}") from exc
    return msg
