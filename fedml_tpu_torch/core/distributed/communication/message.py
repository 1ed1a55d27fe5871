"""Wire message: a copy of ``fedml_tpu/core/distributed/communication/message.py``.

Reference: ``core/distributed/communication/message.py:5`` — JSON control
plane with a ``model_params`` payload. Same key vocabulary; the payload is a
parameter pytree serialized at the comm boundary as flat host buffers
(serialization.py), never pickle.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from ...telemetry.trace_context import RESERVED_TELEMETRY_KEY


class Message:
    MSG_ARG_KEY_OPERATION = "operation"
    MSG_ARG_KEY_TYPE = "msg_type"
    MSG_ARG_KEY_SENDER = "sender"
    MSG_ARG_KEY_RECEIVER = "receiver"
    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_MODEL_PARAMS_URL = "model_params_url"
    # Reserved header: trace context + client telemetry delta ride here.
    # The literal lives in core/telemetry/trace_context.py only, so payload
    # keys cannot collide.
    MSG_ARG_KEY_TELEMETRY = RESERVED_TELEMETRY_KEY
    MSG_OPERATION_SEND = "send"

    def __init__(self, msg_type: Any = 0, sender_id: int = 0, receiver_id: int = 0):
        self.msg_params: Dict[str, Any] = {
            Message.MSG_ARG_KEY_TYPE: msg_type,
            Message.MSG_ARG_KEY_SENDER: sender_id,
            Message.MSG_ARG_KEY_RECEIVER: receiver_id,
        }

    # --- accessors (reference naming) -----------------------------------
    def init_from_json_object(self, json_object: Dict[str, Any]) -> None:
        self.msg_params = dict(json_object)

    def get_sender_id(self) -> int:
        return int(self.msg_params[Message.MSG_ARG_KEY_SENDER])

    def get_receiver_id(self) -> int:
        return int(self.msg_params[Message.MSG_ARG_KEY_RECEIVER])

    def get_type(self) -> Any:
        return self.msg_params[Message.MSG_ARG_KEY_TYPE]

    def add_params(self, key: str, value: Any) -> None:
        self.msg_params[key] = value

    add = add_params

    def get_params(self) -> Dict[str, Any]:
        return self.msg_params

    def get(self, key: str, default: Any = None) -> Any:
        return self.msg_params.get(key, default)

    # --- (de)serialization ----------------------------------------------
    def to_json(self) -> str:
        """Control-plane view: payload replaced by a marker (payload travels
        separately/binary)."""
        clean = {k: v for k, v in self.msg_params.items() if k != Message.MSG_ARG_KEY_MODEL_PARAMS}
        return json.dumps(clean)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Message(type={self.get_type()!r}, {self.get_sender_id()}->{self.get_receiver_id()})"
