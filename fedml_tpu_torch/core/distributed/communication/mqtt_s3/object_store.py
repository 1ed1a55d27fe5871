"""Payload object store: the filesystem half of
``fedml_tpu/core/distributed/communication/mqtt_s3/object_store.py``.

Reference: ``communication/s3/remote_storage.py:75-113`` (``S3Storage``,
pickled payloads). ``LocalObjectStore`` keeps payloads as files under one
directory with file:// urls; every party of a federation must be given the
same ``object_store_dir`` (the default is the JAX package's directory under
the temp dir, so a JAX and a port party on one host meet there). Payloads
are npz-framed pytrees (serialization.py), never pickle. The JAX package's
``S3ObjectStore`` (boto3, ``s3_bucket``) is not ported: asking for it raises
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import os
import tempfile
import uuid
from typing import Any, Optional

from ..serialization import deserialize_pytree, serialize_pytree


class LocalObjectStore:
    def __init__(self, root: Optional[str] = None):
        self.root = root or os.path.join(tempfile.gettempdir(), "fedml_tpu_object_store")
        os.makedirs(self.root, exist_ok=True)

    def write_model(self, message_key: str, model_params: Any) -> str:
        return self.write_blob(message_key, serialize_pytree(model_params), ext=".npz")

    def read_model(self, url: str) -> Any:
        return deserialize_pytree(self.read_blob(url))

    def write_blob(self, message_key: str, blob: bytes, ext: str = ".bin") -> str:
        key = f"{message_key}_{uuid.uuid4().hex[:8]}{ext}"
        path = os.path.join(self.root, key)
        with open(path, "wb") as f:
            f.write(blob)
        return f"file://{path}"

    def read_blob(self, url: str) -> bytes:
        path = url[len("file://") :] if url.startswith("file://") else url
        with open(path, "rb") as f:
            return f.read()


def create_object_store(args: Any):
    bucket = getattr(args, "s3_bucket", None) if args is not None else None
    if bucket:
        raise NotImplementedError(
            f"s3_bucket {bucket!r}: the S3 object store (boto3) is not ported to "
            "fedml_tpu_torch yet; use object_store_dir (see ROADMAP.md, Queue 1)")
    return LocalObjectStore(getattr(args, "object_store_dir", None) if args is not None else None)
