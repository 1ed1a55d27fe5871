"""LightSecAgg: one-shot-reconstruction secure aggregation, the counterpart
of ``fedml_tpu/core/mpc/lightsecagg.py``.

Protocol (reference: python/fedml/core/mpc/lightsecagg.py:83-146 and the
managers in python/fedml/cross_silo/lightsecagg/): each client encodes its
random mask with Lagrange-coded computing so that the *sum* of masks over any
U active clients can be reconstructed from U encoded-mask aggregates, with
T-privacy. Server never sees an individual mask.

Geometry (mask_encoding, reference lightsecagg.py:97-123):
  - alpha = N+1..N+U       (U interpolation points holding the payload rows)
  - beta = 1..N            (one evaluation point per client, share index)
  - payload = [mask chunks (U-T rows of size d/(U-T)) ; T rows of noise]
  - client i's share for client j = the payload polynomial (defined by its
    values at the alpha points) evaluated at beta_j

Flat int64 vectors in the JAX flat order (``finite_field.flatten_finite``).
The mask and noise draws are host numpy, the JAX package's; the Lagrange
products (``lcc_encode``/``lcc_decode``, each product reduced mod p) run on
the device they are given: ``encode_mask(device=...)`` encodes there and
brings the shares back to the host, and ``decode_aggregate_mask`` decodes
on the device of the aggregates it is handed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .finite_field import (
    DEFAULT_PRIME,
    Field,
    lcc_decode,
    lcc_encode,
)


def _pad_to_chunks(d: int, n_chunks: int) -> int:
    """Smallest padded dim divisible by n_chunks."""
    return ((d + n_chunks - 1) // n_chunks) * n_chunks


@dataclass
class LightSecAggConfig:
    num_clients: int  # N
    target_active: int  # U: #clients needed to reconstruct
    privacy_guarantee: int  # T: collusion tolerance, T < U <= N
    prime: int = DEFAULT_PRIME

    def __post_init__(self) -> None:
        if not (0 < self.privacy_guarantee < self.target_active <= self.num_clients):
            raise ValueError("need 0 < T < U <= N")

    @property
    def beta(self) -> np.ndarray:
        return np.arange(1, self.num_clients + 1, dtype=np.int64)

    @property
    def alpha(self) -> np.ndarray:
        return np.arange(self.num_clients + 1, self.num_clients + self.target_active + 1, dtype=np.int64)


@dataclass
class ClientMaskState:
    local_mask: np.ndarray  # (d_pad,) this client's additive mask
    encoded_shares: np.ndarray  # (N, chunk) row j goes to client j
    received: Dict[int, np.ndarray] = field(default_factory=dict)  # sender -> share


def encode_mask(cfg: LightSecAggConfig, d: int, rng: np.random.Generator,
                device: Optional[Any] = None) -> ClientMaskState:
    """Offline phase: draw a uniform mask over GF(p) and LCC-encode it into N
    shares (reference mask_encoding lightsecagg.py:97-123; here the reshape is
    chunked explicitly and noise rows give T-privacy). The draws are numpy;
    with ``device`` the encoding's products run there, and the shares come
    back to the host in one copy."""
    p = cfg.prime
    n_data = cfg.target_active - cfg.privacy_guarantee  # U - T payload rows
    d_pad = _pad_to_chunks(d, n_data)
    chunk = d_pad // n_data

    local_mask = rng.integers(0, p, size=d_pad, dtype=np.int64)
    noise = rng.integers(0, p, size=(cfg.privacy_guarantee, chunk), dtype=np.int64)
    payload = np.concatenate([local_mask.reshape(n_data, chunk), noise], axis=0)  # (U, chunk)
    if device is None:
        encoded = lcc_encode(payload, cfg.beta, cfg.alpha, p)  # (N, chunk)
    else:
        encoded = lcc_encode(torch.from_numpy(payload).to(device), cfg.beta, cfg.alpha, p).cpu().numpy()
    return ClientMaskState(local_mask=local_mask, encoded_shares=encoded)


def mask_vector(cfg: LightSecAggConfig, x_finite: np.ndarray, state: ClientMaskState) -> np.ndarray:
    """Online phase, client side: upload x + z mod p (reference model_masking
    lightsecagg.py:83-95, flattened)."""
    d = x_finite.size
    y = np.mod(np.asarray(x_finite, np.int64) + state.local_mask[:d], cfg.prime)
    return y


def aggregate_encoded_mask(cfg: LightSecAggConfig, state: ClientMaskState, active: Sequence[int]) -> np.ndarray:
    """Online phase, client side: sum the encoded shares received from the
    active set (reference compute_aggregate_encoded_mask lightsecagg.py:126-132)."""
    agg = np.zeros_like(state.encoded_shares[0])
    for sender in active:
        agg = np.mod(agg + state.received[sender], cfg.prime)
    return agg


def decode_aggregate_mask(cfg: LightSecAggConfig, agg_shares: Dict[int, Field], d: int) -> Field:
    """Server side: from U clients' aggregate-encoded-masks (keyed by 0-based
    client id; numpy arrays, or tensors of one device), interpolate back to
    the alpha points and read off the summed mask (first U-T rows)."""
    p = cfg.prime
    ids = sorted(agg_shares.keys())[: cfg.target_active]
    if len(ids) < cfg.target_active:
        raise ValueError(f"need {cfg.target_active} aggregate shares, got {len(ids)}")
    rows = [agg_shares[i] for i in ids]
    f_eval = torch.stack(rows) if isinstance(rows[0], torch.Tensor) else np.stack(rows)  # (U, chunk)
    eval_points = cfg.beta[np.asarray(ids)]
    decoded = lcc_decode(f_eval, eval_points, cfg.alpha, p)  # (U, chunk)
    n_data = cfg.target_active - cfg.privacy_guarantee
    return decoded[:n_data].reshape(-1)[:d]


def unmask_aggregate(cfg: LightSecAggConfig, masked_sum: Field, agg_shares: Dict[int, Field]) -> Field:
    """Server side: sum_i (x_i + z_i) - sum_i z_i mod p."""
    d = int(masked_sum.shape[0])
    if not isinstance(masked_sum, torch.Tensor):
        masked_sum = np.asarray(masked_sum, np.int64)
    return (masked_sum - decode_aggregate_mask(cfg, agg_shares, d)) % cfg.prime


def exchange_shares(states: Dict[int, ClientMaskState]) -> None:
    """Simulate the share-exchange round: client i's row j → client j."""
    for i, si in states.items():
        for j, sj in states.items():
            sj.received[i] = si.encoded_shares[j]
