"""Reference-compatible S3 "bucket" on the local filesystem: the port's
counterpart of
``fedml_tpu/core/distributed/communication/mqtt_s3/ref_bucket.py``.

The reference's default cross-silo transport is MQTT + S3: the control JSON
carries the object key, and the payload is ``pickle.dumps`` of a torch
state dict uploaded under that key
(``mqtt_s3/mqtt_s3_multi_clients_comm_manager.py:248`` send path,
``s3/remote_storage.py:75-113`` write, ``:215`` read-by-key). This store
keeps that contract over a shared directory standing in for the bucket, so
a reference or JAX peer pointed at the same directory reads the port's
objects and the port reads theirs:

  * write: ``pickle.dumps(torch-tree)`` at ``<root>/<quoted key>``;
  * read: by key, through the gRPC bridge's restricted unpickler
    (arbitrary callables in a peer's pickle are refused);
  * URL: a ``file://`` path, playing the presigned-URL role; carried in the
    JSON for parity but not needed to read.

The port's native object store (object_store.py) stays pickle-free; this
store exists only for ``mqtt_s3_wire='fedml'``.
"""

from __future__ import annotations

import os
import urllib.parse
from typing import Any

from ..grpc.ref_wire import pickle_ref_tree, unpickle_ref_tree


class RefBucketStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        # the reference's keys are "<topic>_<uuid>" (no slashes); quoted so a
        # hostile key cannot escape the bucket directory
        return os.path.join(self.root, urllib.parse.quote(key, safe=""))

    def write_model(self, key: str, params: Any) -> str:
        path = self._path(key)
        with open(path, "wb") as f:
            f.write(pickle_ref_tree(params))
        return f"file://{path}"

    def read_model(self, key: str) -> Any:
        with open(self._path(key), "rb") as f:
            return unpickle_ref_tree(f.read())
