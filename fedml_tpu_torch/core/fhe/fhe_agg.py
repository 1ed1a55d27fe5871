"""Homomorphic-encryption aggregation seam: counterpart of
``fedml_tpu/core/fhe/fhe_agg.py`` (reference ``core/fhe/fhe_agg.py:10``,
``FedMLFHE``).

The facade and its hooks are the JAX package's: ``is_fhe_enabled``,
``fhe_enc`` after local training (``core/alg_frame/client_trainer.py``) and
``fhe_dec`` after the fold (``server_aggregator.py``), with a registry of
schemes:

- ``rlwe`` (and its reference name ``ckks``): the lattice scheme of
  ``rlwe.py``, its ring products on the card. The server folds ciphertexts
  it cannot read.
- ``additive_mask``: fixed-point PRF masking in int64, faster, with a shared
  masking secret (a trusted dealer). Its ciphertexts are plain int64
  tensors, so the float fold of a front would corrupt them, in the JAX
  package too; the fronts refuse it (ROADMAP.md, Queue 3, R10) and the
  scheme is used directly with explicit nonces and weights.

State dicts replace pytrees: a leaf's path is its state-dict key.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

_SCALE = 1 << 16  # fixed-point scale

StateDict = Dict[str, Any]


class AdditiveMaskScheme:
    """Additively homomorphic masking in int64 fixed point."""

    def __init__(self, secret: bytes, device: Any = None):
        self.secret = secret

    def _mask(self, name: str, shape, nonce: int) -> np.ndarray:
        seed = int.from_bytes(
            hashlib.sha256(self.secret + name.encode() + nonce.to_bytes(8, "little")).digest()[:8],
            "little")
        rng = np.random.default_rng(seed)
        return rng.integers(-(1 << 40), 1 << 40, size=shape, dtype=np.int64)

    def encrypt(self, tree: StateDict, nonce: int) -> StateDict:
        def enc(path, x):
            fixed = torch.round(x.detach().to(torch.float64) * _SCALE).to(torch.int64)
            return fixed + torch.from_numpy(self._mask(path, tuple(x.shape), nonce)).to(x.device)

        return _map_with_path(tree, enc)

    def decrypt_sum(self, tree: StateDict, nonces, weights) -> StateDict:
        """Decrypt a weighted sum of ciphertexts given the contributing
        nonces and weights (the mask sum in float64 on the host, as JAX)."""

        def dec(path, x):
            total_mask = np.zeros(tuple(x.shape), dtype=np.float64)
            for nonce, w in zip(nonces, weights):
                total_mask += w * self._mask(path, tuple(x.shape), nonce).astype(np.float64)
            mask = torch.from_numpy(total_mask).to(x.device)
            return ((x.to(torch.float64) - mask) / _SCALE).to(torch.float32)

        return _map_with_path(tree, dec)


def _map_with_path(tree: StateDict, fn: Callable[[str, Any], Any]) -> StateDict:
    """``fn(key, leaf)`` over a state dict, in its key order."""
    return {k: fn(k, v) for k, v in tree.items()}


def _rlwe_factory(secret: bytes, device: Any = "cuda"):
    from .rlwe import RLWEScheme

    return RLWEScheme(secret, device=device)


_SCHEMES: Dict[str, Callable[..., Any]] = {
    "additive_mask": AdditiveMaskScheme,
    "rlwe": _rlwe_factory,
    "ckks": _rlwe_factory,  # reference config name
}


def register_scheme(name: str, factory: Callable[..., Any]) -> None:
    """``factory(secret, device=...)`` builds the scheme."""
    _SCHEMES[name] = factory


def scheme_name(args: Any) -> Optional[str]:
    """The configured scheme's name (``rlwe`` when ``enable_fhe`` names
    none), or None with FHE off."""
    if not getattr(args, "enable_fhe", False):
        return None
    name = getattr(args, "fhe_scheme", None)
    return "rlwe" if name is None else str(name)


class FedMLFHE:
    _instance: Optional["FedMLFHE"] = None

    @classmethod
    def get_instance(cls) -> "FedMLFHE":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self) -> None:
        self.is_enabled = False
        self.scheme = None
        self._nonce = 0

    def init(self, args: Any, device: Any = "cuda") -> None:
        """Configure from ``args`` (``enable_fhe``, ``fhe_scheme``,
        ``fhe_secret``); the scheme's ring products run on ``device``."""
        self.is_enabled = bool(getattr(args, "enable_fhe", False))
        self.scheme = None
        self._nonce = 0
        if not self.is_enabled:
            return
        if getattr(args, "fhe_scheme", None) is None:
            log.warning(
                "enable_fhe defaults to the REAL lattice scheme ('rlwe'): "
                "O(N^2) ring products make encryption seconds-per-MB of "
                "params. Set fhe_scheme='additive_mask' for the fast "
                "trusted-dealer masking scheme if your threat model allows.")
        name = scheme_name(args)
        secret = str(getattr(args, "fhe_secret", "fedml_tpu")).encode()
        self.scheme = _SCHEMES[name](secret, device=device)

    def is_fhe_enabled(self) -> bool:
        return self.is_enabled

    def fhe_enc(self, enc_type: str, model_params: StateDict) -> StateDict:
        self._nonce += 1
        return self.scheme.encrypt(model_params, self._nonce)

    def fhe_dec(self, dec_type: str, model_params: StateDict, nonces=None, weights=None) -> StateDict:
        nonces = nonces if nonces is not None else [self._nonce]
        weights = weights if weights is not None else [1.0]
        return self.scheme.decrypt_sum(model_params, nonces, weights)


# the sp optimizers whose server rule folds the uploads with the weighted
# average and decrypts before anything else reads them (JAX runs FHE through
# these; FedOpt, FedNova, FedDyn, Mime, async FedAvg and TurboAggregate fail
# there on the ciphertexts, and SCAFFOLD uploads its payload unencrypted)
FHE_OPTIMIZERS = ("FedAvg", "FedProx", "FedAvg_seq", "HierarchicalFL")


def refuse_fhe_front(args: Any, front: str, backend: Optional[str] = None) -> None:
    """Raise ValueError, before any round, where ``enable_fhe`` cannot run
    as configured on ``front`` ("sp", "vmap" or "cross_silo"), each naming
    its ROADMAP.md Queue 3 entry. FHE runs on the sp front and on the
    cross-silo front over INMEMORY, with the FedAvg-family rules of
    :data:`FHE_OPTIMIZERS`, local DP (ldp, nbafl, dp_clip), central DP
    without a server clip and the data attacks."""
    name = scheme_name(args)
    if name is None:
        return
    if front == "vmap":
        raise ValueError(
            "enable_fhe on backend 'vmap': the vmapped front runs no client hook, so nothing "
            "would be encrypted (the JAX package's vmapped front never encrypts; ROADMAP.md, "
            "Queue 3, R7). Use backend 'sp'.")
    if name == "additive_mask":
        raise ValueError(
            "fhe_scheme 'additive_mask' on a front: its int64 ciphertexts are tensor leaves "
            "that the f32 fold truncates, and the server's decryption removes one client's "
            "mask (the JAX front publishes a loss of about 1e8; ROADMAP.md, Queue 3, R10). "
            "Use fhe_scheme 'rlwe', or the scheme directly with explicit nonces and weights.")
    from ..distributed.fedml_comm_manager import _BYTE_BACKENDS

    if backend is not None and str(backend).upper() in _BYTE_BACKENDS:
        raise ValueError(
            f"enable_fhe over backend {str(backend).upper()!r}: the byte codecs cannot carry "
            "ciphertext objects (the JAX package's serializer refuses the object arrays and "
            "its sends retry until the federation hangs; ROADMAP.md, Queue 3, R11). Use "
            "INMEMORY.")
    from ..dp.fedml_differential_privacy import dp_solution
    from ..security.fedml_attacker import DATA_ATTACKS, attack_type

    bad = []
    opt = str(getattr(args, "federated_optimizer", "FedAvg"))
    if opt not in FHE_OPTIMIZERS:
        bad.append(f"federated_optimizer={opt!r}")
    if opt == "HierarchicalFL" and int(getattr(args, "group_comm_round", 1)) > 1:
        bad.append("group_comm_round > 1")
    if getattr(args, "enable_defense", False):
        bad.append(f"defense_type={getattr(args, 'defense_type', None)!r}")
    atk = attack_type(args)
    if getattr(args, "enable_attack", False) and atk not in DATA_ATTACKS:
        bad.append(f"attack_type={atk!r}")
    if getattr(args, "enable_contribution", False):
        bad.append("enable_contribution")
    if dp_solution(args) == "cdp" and getattr(args, "clipping_norm", None) is not None:
        bad.append("cdp with clipping_norm")
    if front == "cross_silo":
        for knob in ("privacy", "secure_aggregation", "comm_compressor"):
            if getattr(args, knob, None) not in (None, "", "none", False):
                bad.append(f"{knob}={getattr(args, knob)!r}")
        if getattr(args, "async_rounds", False):
            bad.append("async_rounds")
    if bad:
        raise ValueError(
            f"enable_fhe with {', '.join(bad)}: these read or transform the uploads before the "
            "server decrypts the fold (the JAX package fails on the ciphertexts, or runs "
            "unencrypted or reads each subset's sum; ROADMAP.md, Queue 3, R12)")
