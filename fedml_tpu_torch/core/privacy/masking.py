"""Quantized-ring masking primitives for windowed async SecAgg: a numpy
copy of ``fedml_tpu/core/privacy/masking.py``, whole (the tier keyring
included: it is framework-free, though only the hierarchy, not ported,
uses it).

The synchronous SecAgg front (``cross_silo/secagg``) masks in GF(p) int64 —
exact, but un-foldable by the f32 bucketed engine, so every masked arrival
has to park until a round barrier. This module moves the masking domain to
the ring **Z_{2^b} embedded in float32**: quantized deltas and PRG masks are
integer-valued f32 arrays bounded so that every partial sum the engine can
form stays below 2^24, where f32 addition *is* integer arithmetic. Masked
arrivals therefore fold at arrival through the unmodified bucketed engine
(``core/aggregation/bucketed.py``: one f32 matrix-vector product a bucket,
exact only with TF32 matmuls off) and pairwise masks cancel EXACTLY (to the last ulp — they cancel in exact
integer arithmetic) when the window's sum is reduced mod 2^b at publish.

Domain contract (enforced by :func:`ring_bits_for`):

* quantized values ``q = clip(round(x / step))`` with ``|q| <= 2^qbits``,
  ``step = clip / 2^qbits``;
* masks uniform over ``[0, 2^b)`` — proper one-time-pad uniformity in the
  ring, unlike bounded additive masks over the integers;
* every masked value lives in ``[0, 2^b)`` after the mod, so a fold of
  ``n`` arrivals is bounded by ``n * 2^b <= 2^24`` (f32-exact), and the
  true signed window sum is recoverable iff ``n * 2^qbits < 2^(b-1)``.

Key agreement and dropout recovery reuse ``core/mpc/finite_field``: DH for
pairwise seeds (symmetric, so the server can re-derive a dropout's masks
from its Shamir-reconstructed secret key), Shamir shares over GF(p) for the
mask-share reveal phase.

Tier keys (hierarchical masking): each member of an edge window adds one
extra PRG mask seeded from its tier's key, so the edge's published window
sum — pairwise masks already cancelled — is still masked toward the upper
tiers. Only the root holds the :class:`TierKeyring` and strips the tier
masks of every member that contributed, after which the fleet sum
dequantizes exactly. See docs/privacy.md for the threat model.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

#: f32 integer arithmetic is exact strictly below 2**24
F32_EXACT_BITS = 24

DEFAULT_QBITS = 13
DEFAULT_CLIP = 3.0


def ring_bits_for(max_fanin: int, total_members: int,
                  qbits: int = DEFAULT_QBITS) -> int:
    """The largest ring width ``b`` such that (a) any single fold of
    ``max_fanin`` ring values stays f32-exact and (b) the signed sum of
    ``total_members`` quantized deltas is recoverable from its mod-2^b
    residue. Raises when no such width exists (shrink qbits or the cohort).
    """
    if max_fanin < 1 or total_members < 1:
        raise ValueError("cohort must have at least one member")
    b = F32_EXACT_BITS - max(1, math.ceil(math.log2(max(2, max_fanin))))
    need = qbits + math.ceil(math.log2(max(2, total_members))) + 1
    if b < need:
        raise ValueError(
            f"no exact masking ring: fan-in {max_fanin} allows {b} ring bits "
            f"but {total_members} members at {qbits} qbits need {need}; "
            "reduce secagg_qbits or the window cohort")
    return b


def validate_ring_bits(spec: "QuantSpec", max_fanin: int,
                       total_members: int) -> None:
    """Check the spec ACTUALLY in use against the domain contract — not the
    width :func:`ring_bits_for` would have picked. A coordinator built with
    a hand-rolled (or default) :class:`QuantSpec` can carry a ring that is
    too small for recoverability (``n·2^qbits >= 2^(b-1)``) or too large
    for f32-exact folds (``fanin·2^b > 2^24``); either silently corrupts
    the unmasked aggregate, so both sides raise here instead."""
    if max_fanin < 1 or total_members < 1:
        raise ValueError("cohort must have at least one member")
    need = spec.qbits + math.ceil(math.log2(max(2, total_members))) + 1
    cap = F32_EXACT_BITS - max(1, math.ceil(math.log2(max(2, max_fanin))))
    if spec.ring_bits < need:
        raise ValueError(
            f"ring_bits={spec.ring_bits} too small: {total_members} members "
            f"at {spec.qbits} qbits need >= {need} for the signed window sum "
            "to be recoverable from its mod-2^b residue; reduce secagg_qbits "
            "or the window cohort (or widen the ring)")
    if spec.ring_bits > cap:
        raise ValueError(
            f"ring_bits={spec.ring_bits} too large: a fold of {max_fanin} "
            f"ring values is only f32-exact up to {cap} bits; shrink the "
            "ring or the fan-in")


@dataclass(frozen=True)
class QuantSpec:
    """Shared fixed-point grid: every cohort member quantizes onto the SAME
    grid or masks cannot cancel against the sum."""

    clip: float = DEFAULT_CLIP
    qbits: int = DEFAULT_QBITS
    ring_bits: int = 20

    @property
    def step(self) -> float:
        return float(self.clip) / float(1 << self.qbits)

    @property
    def ring(self) -> int:
        return 1 << self.ring_bits

    def as_dict(self) -> Dict[str, Any]:
        return {"clip": self.clip, "qbits": self.qbits,
                "ring_bits": self.ring_bits}


def quantize_vector(vec: np.ndarray, spec: QuantSpec) -> np.ndarray:
    """Real f32 vector -> signed integers on the shared grid (held in f64
    for exactness; callers mod into the ring before shipping)."""
    qmax = float(1 << spec.qbits)
    q = np.round(np.asarray(vec, np.float64) / spec.step)
    return np.clip(q, -qmax, qmax)


def dequantize_sum(signed_sum: np.ndarray, n_members: int,
                   spec: QuantSpec) -> np.ndarray:
    """Signed integer window sum -> real mean over ``n_members``."""
    return (np.asarray(signed_sum, np.float64) * spec.step
            / float(max(1, n_members))).astype(np.float32)


def center_ring(residue: np.ndarray, spec: QuantSpec) -> np.ndarray:
    """Mod-2^b residue -> signed representative in [-2^(b-1), 2^(b-1))."""
    r = np.mod(np.asarray(residue, np.float64), spec.ring)
    return np.where(r >= spec.ring / 2, r - spec.ring, r)


def ring_mod(x: np.ndarray, spec: QuantSpec) -> np.ndarray:
    return np.mod(np.asarray(x, np.float64), spec.ring)


# --- PRG masks ---------------------------------------------------------------


def _digest_seed(*parts: Any) -> int:
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        h.update(str(p).encode())
        h.update(b"|")
    return int.from_bytes(h.digest(), "big")


def pair_seed(window_nonce: int, shared_key: int) -> int:
    """Per-(window, pair) mask seed: both endpoints derive the same value
    from the symmetric DH shared key, and a fresh nonce per window keeps
    masks single-use."""
    return _digest_seed("secagg.pair", window_nonce, shared_key)


def tier_seed(tier_key: int, window_nonce: int, rank: int) -> int:
    """Per-(tier, window, member) tier-mask seed."""
    return _digest_seed("secagg.tier", tier_key, window_nonce, rank)


def prg_ring(seed: int, d: int, spec: QuantSpec) -> np.ndarray:
    """Uniform mask over [0, 2^b)^d from a 64-bit seed (f64 integers —
    exact, and exactly representable in f32 after the ring mod)."""
    rng = np.random.default_rng(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return rng.integers(0, spec.ring, size=int(d), dtype=np.int64).astype(np.float64)


def pairwise_mask_sum(rank: int, peer_seeds: Dict[int, int], d: int,
                      spec: QuantSpec) -> np.ndarray:
    """Sum over peers of the signed pairwise mask: +PRG for peers above this
    rank, -PRG for peers below (antisymmetric, so a complete cohort's masks
    sum to 0 mod 2^b)."""
    total = np.zeros(int(d), np.float64)
    for peer, seed in peer_seeds.items():
        m = prg_ring(seed, d, spec)
        total += m if int(rank) < int(peer) else -m
    return total


def mask_quantized(q: np.ndarray, rank: int, peer_seeds: Dict[int, int],
                   spec: QuantSpec,
                   tier_key: Optional[int] = None,
                   window_nonce: int = 0) -> np.ndarray:
    """The wire value: (q + pairwise masks [+ tier mask]) mod 2^b as f32."""
    y = np.asarray(q, np.float64) + pairwise_mask_sum(rank, peer_seeds,
                                                      q.size, spec)
    if tier_key is not None:
        y += prg_ring(tier_seed(tier_key, window_nonce, rank), q.size, spec)
    return ring_mod(y, spec).astype(np.float32)


def stray_mask_correction(dropped_seeds: Dict[int, Dict[int, int]],
                          survivors: Sequence[int], d: int,
                          spec: QuantSpec) -> np.ndarray:
    """What the recovery phase subtracts: for each dropped rank ``dr`` the
    signed masks every *survivor* j added toward ``dr`` (sign(j, dr) *
    PRG(seed_j_dr)) — the terms left un-cancelled because ``dr`` never
    submitted its own side. ``dropped_seeds[dr][j]`` is the (symmetric)
    pair seed between ``dr`` and survivor ``j``."""
    stray = np.zeros(int(d), np.float64)
    for dr, seeds in dropped_seeds.items():
        for j in survivors:
            seed = seeds.get(int(j))
            if seed is None:
                continue
            m = prg_ring(seed, d, spec)
            stray += m if int(j) < int(dr) else -m
    return stray


# --- tier keys ---------------------------------------------------------------


class TierKeyring:
    """Root-held keys, one per tier node name. Edge members mask with their
    tier's key; only :meth:`strip` (the root) can remove them."""

    def __init__(self, keys: Optional[Dict[str, int]] = None,
                 root_secret: Optional[int] = None):
        self._keys: Dict[str, int] = dict(keys or {})
        self._root_secret = root_secret

    @classmethod
    def generate(cls, tier_names: Iterable[str],
                 root_secret: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None) -> "TierKeyring":
        if root_secret is not None:
            keys = {n: _digest_seed("tierkey", root_secret, n)
                    for n in tier_names}
            return cls(keys, root_secret=root_secret)
        rng = rng or np.random.default_rng()
        return cls({n: int(rng.integers(1, 2**62)) for n in tier_names})

    def key_for(self, tier_name: str) -> int:
        return self._keys[str(tier_name)]

    def has(self, tier_name: str) -> bool:
        return str(tier_name) in self._keys

    def strip(self, residue: np.ndarray,
              contributions: Sequence[Tuple[str, int, int]],
              spec: QuantSpec) -> np.ndarray:
        """Remove the tier masks of every ``(tier_name, window_nonce, rank)``
        contribution from a ring residue (root-side, before centering)."""
        out = np.asarray(residue, np.float64).copy()
        for tier_name, nonce, rank in contributions:
            seed = tier_seed(self.key_for(tier_name), int(nonce), int(rank))
            out -= prg_ring(seed, out.size, spec)
        return ring_mod(out, spec)
