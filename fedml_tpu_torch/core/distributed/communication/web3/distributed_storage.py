"""Content-addressed payload storage: the port's counterpart of
``fedml_tpu/core/distributed/communication/web3/distributed_storage.py``.

Reference: ``core/distributed/distributed_storage/{web3_storage,
theta_storage}/``: model payloads in an IPFS-like decentralized store
(web3.storage / ThetaEdgeStore), addressed by content id.

The semantics that matter to the FL protocol are content addressing: the
message carries a cid, the payload is immutable, and re-uploads of identical
bytes dedupe. ``LocalCASStore`` does exactly that on the local filesystem:
the cid is the sha256 of the codec's bytes (``serialization.py``, the JAX
package's npz framing byte for byte), checked again on every read. A JAX
party and a port party that write the same wire-layout tree get the same
cid, and every party of a federation must be given the same ``cas_root``
(the default is the JAX package's directory under the temp dir).
``Web3Storage``/``ThetaStorage`` keep the reference's remote surface; they
need their SDKs, tokens and egress, and raise a clear error otherwise.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import uuid
from typing import Any, Optional

from ..serialization import deserialize_pytree, serialize_pytree


class LocalCASStore:
    """sha256-addressed local store; urls are ``cas://<cid>``."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.path.join(tempfile.gettempdir(), "fedml_tpu_cas")
        os.makedirs(self.root, exist_ok=True)

    def _path(self, cid: str) -> str:
        return os.path.join(self.root, cid)

    def write_model(self, message_key: str, model_params: Any) -> str:
        blob = serialize_pytree(model_params)
        cid = hashlib.sha256(blob).hexdigest()
        path = self._path(cid)
        if not os.path.exists(path):  # content addressing => dedupe
            # unique tmp name: concurrent writers of the same cid must not
            # interleave into one tmp file (the atomic replace keeps one)
            tmp = f"{path}.{uuid.uuid4().hex}.tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        return f"cas://{cid}"

    def read_model(self, url: str) -> Any:
        cid = url[len("cas://"):] if url.startswith("cas://") else url
        with open(self._path(cid), "rb") as f:
            blob = f.read()
        if hashlib.sha256(blob).hexdigest() != cid:
            raise IOError(f"CAS integrity failure for {cid}")
        return deserialize_pytree(blob)


class Web3Storage:
    """Reference: distributed_storage/web3_storage/web3_storage.py."""

    def __init__(self, args: Any = None):
        token = getattr(args, "web3_storage_token", None)
        if not token:
            raise RuntimeError(
                "Web3Storage needs args.web3_storage_token and network egress; "
                "use the default LocalCASStore for offline runs"
            )
        try:
            import w3storage  # noqa: F401
        except ImportError as e:
            raise RuntimeError("w3storage SDK not installed") from e
        raise RuntimeError("web3.storage uploads are not available in this offline deployment")


class ThetaStorage:
    """Reference: distributed_storage/theta_storage/theta_storage.py."""

    def __init__(self, args: Any = None):
        url = getattr(args, "theta_store_url", None)
        if not url:
            raise RuntimeError(
                "ThetaStorage needs args.theta_store_url (ThetaEdgeStore endpoint); "
                "use the default LocalCASStore for offline runs"
            )
        raise RuntimeError("ThetaEdgeStore uploads are not available in this offline deployment")


def create_cas_store(args: Any = None):
    """The store a web3 manager writes to, by ``distributed_storage``
    (reference: per-backend storage selection)."""
    kind = str(getattr(args, "distributed_storage", "local") or "local").lower()
    if kind == "local":
        return LocalCASStore(getattr(args, "cas_root", None))
    if kind == "web3":
        return Web3Storage(args)
    if kind in ("theta", "thetastore"):
        return ThetaStorage(args)
    raise ValueError(f"unknown distributed_storage {kind!r}")
