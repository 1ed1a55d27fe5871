"""SecAgg: Bonawitz-style pairwise-masked secure aggregation with dropout
recovery, the counterpart of ``fedml_tpu/core/mpc/secagg.py``.

Reference: python/fedml/core/mpc/secagg.py (primitives) and
python/fedml/cross_silo/secagg/ (protocol managers). A pure-function round
protocol over flat GF(p) vectors:

  round 0  advertise keys   client i: (sk_i, pk_i); server broadcasts pks
  round 1  share keys       client i Shamir-shares sk_i and self-seed b_i
  round 2  masked input     y_i = x_i + PRG(b_i)
                                  + sum_{j>i} PRG(s_ij) - sum_{j<i} PRG(s_ij)
  round 3  unmask           survivors reveal b-shares of survivors and
                            sk-shares of dropouts; server reconstructs and
                            strips masks

The pairwise seed s_ij = DH(sk_i, pk_j) is symmetric, so the +/- pairwise
masks cancel in the sum over surviving clients. Every draw is host numpy
from the JAX package's generators and seeds, so a port party masks as a JAX
party does. :meth:`SecAggServer.strip_masks` also takes the survivors' sum
as a tensor, and then strips the host-drawn masks on its device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence

import numpy as np
import torch

from .finite_field import (
    DEFAULT_PRIME,
    Field,
    dh_public_key,
    dh_shared_key,
    shamir_reconstruct,
    shamir_share,
)


def prg_mask(seed: int, d: int, p: int) -> np.ndarray:
    """Deterministic pseudo-random mask in GF(p)^d from an integer seed."""
    rng = np.random.default_rng(np.uint64(seed % (2**63)))
    return rng.integers(0, p, size=d, dtype=np.int64)


@dataclass
class SecAggConfig:
    num_clients: int
    threshold: int  # Shamir degree: threshold+1 shares reconstruct
    prime: int = DEFAULT_PRIME
    dh_prime: int = 2**31 - 1
    dh_generator: int = 5

    def __post_init__(self) -> None:
        if not (0 < self.threshold < self.num_clients):
            raise ValueError("need 0 < threshold < num_clients")


@dataclass
class SecAggClient:
    cid: int
    cfg: SecAggConfig
    rng: np.random.Generator
    secret_key: int = 0
    public_key: int = 0
    self_seed: int = 0
    peer_public: Dict[int, int] = field(default_factory=dict)
    # shares received from peers: holder side
    sk_shares: Dict[int, np.ndarray] = field(default_factory=dict)  # owner -> my share of sk_owner
    b_shares: Dict[int, np.ndarray] = field(default_factory=dict)  # owner -> my share of b_owner

    def advertise_keys(self) -> int:
        # Both secrets are later Shamir-shared over GF(cfg.prime); they must
        # lie inside that field or reconstruction returns them mod p and the
        # server strips the wrong PRG masks.
        self.secret_key = int(self.rng.integers(2, min(self.cfg.dh_prime - 1, self.cfg.prime)))
        self.public_key = dh_public_key(self.secret_key, self.cfg.dh_prime, self.cfg.dh_generator)
        self.self_seed = int(self.rng.integers(0, self.cfg.prime))
        return self.public_key

    def share_keys(self) -> Dict[int, Dict[str, np.ndarray]]:
        """Shamir-share sk_i and b_i; returns {recipient: {"sk": share, "b": share}}."""
        cfg = self.cfg
        sk_sh = shamir_share(np.array([self.secret_key]), cfg.num_clients, cfg.threshold, cfg.prime, self.rng)
        b_sh = shamir_share(np.array([self.self_seed]), cfg.num_clients, cfg.threshold, cfg.prime, self.rng)
        return {j: {"sk": sk_sh[j], "b": b_sh[j]} for j in range(cfg.num_clients)}

    def receive_share(self, owner: int, sk_share: np.ndarray, b_share: np.ndarray) -> None:
        self.sk_shares[owner] = sk_share
        self.b_shares[owner] = b_share

    def pairwise_seed(self, other: int) -> int:
        return dh_shared_key(self.secret_key, self.peer_public[other], self.cfg.dh_prime)

    def masked_input(self, x_finite: np.ndarray) -> np.ndarray:
        """round 2: apply self mask + signed pairwise masks."""
        p = self.cfg.prime
        d = x_finite.size
        y = np.mod(np.asarray(x_finite, np.int64) + prg_mask(self.self_seed, d, p), p)
        for j in self.peer_public:
            if j == self.cid:
                continue
            m = prg_mask(self.pairwise_seed(j), d, p)
            y = np.mod(y + m, p) if self.cid < j else np.mod(y - m, p)
        return y

    def reveal(self, survivors: Sequence[int], dropouts: Sequence[int]) -> Dict[str, Dict[int, np.ndarray]]:
        """round 3: my share of b_i for survivors, of sk_j for dropouts.
        A correct client never reveals both for the same owner."""
        return {
            "b": {i: self.b_shares[i] for i in survivors if i in self.b_shares},
            "sk": {j: self.sk_shares[j] for j in dropouts if j in self.sk_shares},
        }


class SecAggServer:
    """Collects masked inputs and reconstructs sum over survivors."""

    def __init__(self, cfg: SecAggConfig):
        self.cfg = cfg
        self.public_keys: Dict[int, int] = {}
        self.masked: Dict[int, np.ndarray] = {}

    def register_key(self, cid: int, pk: int) -> None:
        self.public_keys[cid] = pk

    def submit(self, cid: int, y: np.ndarray) -> None:
        self.masked[cid] = np.asarray(y, np.int64)

    def unmask(self, reveals: Dict[int, Dict[str, Dict[int, np.ndarray]]]) -> np.ndarray:
        """reveals: {revealer_cid: {"b": {owner: share}, "sk": {owner: share}}}.
        Returns sum_{i in survivors} x_i mod p."""
        p = self.cfg.prime
        total = np.zeros(next(iter(self.masked.values())).size, dtype=np.int64)
        for i in sorted(self.masked):
            total = np.mod(total + self.masked[i], p)
        return self.strip_masks(total, reveals)

    def strip_masks(self, total: Field, reveals: Dict[int, Dict[str, Dict[int, np.ndarray]]]) -> Field:
        """``total``, the survivors' masked sum mod p (numpy, or a tensor on
        its device), less every mask that remains in it: each survivor's
        self mask and each dropout's pairwise masks, drawn on the host from
        the seeds the reveals reconstruct."""
        cfg = self.cfg
        p = cfg.prime
        survivors = sorted(self.masked.keys())
        dropouts = sorted(set(self.public_keys) - set(survivors))
        d = int(total.shape[0])

        def mask(seed: int) -> Field:
            m = prg_mask(seed, d, p)
            return torch.from_numpy(m).to(total.device) if isinstance(total, torch.Tensor) else m

        # strip survivors' self masks: reconstruct b_i from >= threshold+1 shares
        for i in survivors:
            holders = [r for r in reveals if i in reveals[r]["b"]]
            if len(holders) <= cfg.threshold:
                raise ValueError(f"not enough b-shares for client {i}")
            shares = np.stack([reveals[r]["b"][i] for r in holders])
            b_i = int(shamir_reconstruct(shares, holders, p)[0])
            total = (total - mask(b_i)) % p

        # cancel dropouts' pairwise masks: reconstruct sk_j, re-derive seeds
        for j in dropouts:
            holders = [r for r in reveals if j in reveals[r]["sk"]]
            if len(holders) <= cfg.threshold:
                raise ValueError(f"not enough sk-shares for dropout {j}")
            shares = np.stack([reveals[r]["sk"][j] for r in holders])
            sk_j = int(shamir_reconstruct(shares, holders, p)[0])
            for i in survivors:
                m = mask(dh_shared_key(sk_j, self.public_keys[i], cfg.dh_prime))
                # survivor i applied sign(i<j ? + : -) for pair (i, j)
                total = (total - m) % p if i < j else (total + m) % p
        return total


def run_secagg_round(
    cfg: SecAggConfig,
    inputs: Dict[int, np.ndarray],
    dropouts: Sequence[int] = (),
    seed: int = 0,
) -> np.ndarray:
    """Drive a full 4-round SecAgg exchange in-process (the test seam; the
    cross-silo managers run the same rounds over the message plane).
    ``dropouts`` drop AFTER round 2 (hardest case: their masks are in)."""
    rng = np.random.default_rng(seed)
    clients = {i: SecAggClient(i, cfg, np.random.default_rng(rng.integers(2**63))) for i in inputs}
    server = SecAggServer(cfg)

    for i, c in clients.items():
        server.register_key(i, c.advertise_keys())
    for c in clients.values():
        c.peer_public = dict(server.public_keys)
    for i, c in clients.items():
        for j, sh in c.share_keys().items():
            if j in clients:
                clients[j].receive_share(i, sh["sk"], sh["b"])
    for i, c in clients.items():
        server.submit(i, c.masked_input(inputs[i]))
    for j in dropouts:
        del server.masked[j]
    survivors = sorted(server.masked.keys())
    reveals = {i: clients[i].reveal(survivors, sorted(dropouts)) for i in survivors}
    return server.unmask(reveals)
