"""Finite-field primitives for secure aggregation: a copy of the
framework-free part of ``fedml_tpu/core/mpc/finite_field.py``.

Vectorized numpy (reference: python/fedml/core/mpc/secagg.py:8-120,
python/fedml/core/mpc/lightsecagg.py:8-81): batched Fermat inverses,
Lagrange coefficients, Shamir shares over GF(p), the Diffie-Hellman key
agreement behind the pairwise mask seeds, and fixed-point quantization.
All arithmetic is int64 mod p with p < 2^31, so products fit in int64.
:func:`shamir_reconstruct` reduces each product mod p before it sums them,
where the JAX package sums the products in one int64 dot product that can
overflow (ROADMAP.md, Queue 3): the two agree wherever the JAX sum does not
wrap.

The windowed SecAgg path (``core/privacy/secagg_window.py``) uses the
Shamir and DH parts. Not copied, because only the round-barrier fronts
(``secure_aggregation``, ROADMAP.md Queue 1) use them: the Lagrange-coded
encoding (``lcc_encode``/``lcc_decode``), ``additive_shares`` and the
pytree helpers (``tree_to_finite``, ``tree_from_finite``,
``tree_dimensions``, ``flatten_finite``, ``unflatten_finite``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# Default prime: the reference uses 2^15-19 (lightsecagg managers); we default
# to a Mersenne-like 31-bit prime for more quantization headroom while still
# keeping products inside int64.
DEFAULT_PRIME = 2**31 - 1


def mod_inverse(a: np.ndarray, p: int) -> np.ndarray:
    """Batched modular inverse via Fermat's little theorem: a^(p-2) mod p.

    Square-and-multiply over the bits of p-2, vectorized over ``a``.
    (Reference computes extended-Euclid per scalar: secagg.py:8-23.)
    """
    a = np.mod(np.asarray(a, dtype=np.int64), p)
    if np.any(a == 0):
        raise ZeroDivisionError("modular inverse of 0")
    result = np.ones_like(a)
    base = a.copy()
    e = p - 2
    while e > 0:
        if e & 1:
            result = (result * base) % p
        base = (base * base) % p
        e >>= 1
    return result


def field_div(num: np.ndarray, den: np.ndarray, p: int) -> np.ndarray:
    """num / den in GF(p), elementwise."""
    return np.mod(np.asarray(num, np.int64) % p * mod_inverse(den, p), p)


def lagrange_coeffs(eval_points: np.ndarray, interp_points: np.ndarray, p: int) -> np.ndarray:
    """U[i, j] = l_j(alpha_i): Lagrange basis polynomials through
    ``interp_points`` (beta) evaluated at ``eval_points`` (alpha).

    Fully broadcasted equivalent of the reference's triple loop
    (lightsecagg.py:59-81 gen_Lagrange_coeffs). Requires alpha ∩ beta = ∅
    and beta pairwise distinct.
    """
    alpha = np.mod(np.asarray(eval_points, np.int64), p)  # (A,)
    beta = np.mod(np.asarray(interp_points, np.int64), p)  # (B,)
    A, B = len(alpha), len(beta)

    # diffs[j, k] = beta_j - beta_k; denominator w_j = prod_{k != j} (beta_j - beta_k)
    diffs = np.mod(beta[:, None] - beta[None, :], p)  # (B, B)
    np.fill_diagonal(diffs, 1)
    w = np.ones(B, dtype=np.int64)
    for k in range(B):  # O(B) rounds of vectorized products, stays in-field
        w = (w * diffs[:, k]) % p

    # numerator l(alpha_i) = prod_k (alpha_i - beta_k)
    am = np.mod(alpha[:, None] - beta[None, :], p)  # (A, B)
    l_full = np.ones(A, dtype=np.int64)
    for k in range(B):
        l_full = (l_full * am[:, k]) % p

    # U[i, j] = l(alpha_i) / ((alpha_i - beta_j) * w_j)
    den = np.mod(am * w[None, :], p)
    if np.any(den == 0):
        raise ValueError("eval point coincides with an interpolation point")
    return field_div(l_full[:, None], den, p)


# ---------------------------------------------------------------------------
# Shamir / BGW secret sharing
# ---------------------------------------------------------------------------


def shamir_share(
    secret: np.ndarray, n_shares: int, threshold: int, p: int, rng: np.random.Generator
) -> np.ndarray:
    """(threshold)-private Shamir shares of a vector secret.

    Polynomial f(x) = secret + sum_t r_t x^t (degree ``threshold``), shares are
    f(1..n). Any threshold+1 shares reconstruct. Vectorized Horner evaluation.
    (Reference: BGW_encoding secagg.py:164-178.)
    """
    secret = np.mod(np.asarray(secret, np.int64).ravel(), p)
    d = secret.size
    coeffs = np.concatenate(
        [secret[None, :], rng.integers(0, p, size=(threshold, d), dtype=np.int64)], axis=0
    )  # (threshold+1, d)
    xs = np.arange(1, n_shares + 1, dtype=np.int64)
    shares = np.zeros((n_shares, d), dtype=np.int64)
    for c in coeffs[::-1]:  # Horner: s = s*x + c
        shares = np.mod(shares * xs[:, None] + c[None, :], p)
    return shares


def shamir_reconstruct(shares: np.ndarray, idx: Sequence[int], p: int) -> np.ndarray:
    """Reconstruct f(0) from shares at points idx+1 (0-based worker indices).

    (Reference: BGW_decoding secagg.py:192-210.)
    """
    xs = np.asarray(idx, np.int64) + 1
    lam = lagrange_coeffs(np.zeros(1, np.int64), xs, p)[0]  # (len(idx),)
    shares = np.mod(np.asarray(shares, np.int64), p)
    # one product at a time, each reduced mod p: a product is below p^2 < 2^62,
    # so an int64 dot product of three or more of them can wrap (the JAX
    # package's ``lam @ shares`` does, and then reconstructs a wrong key)
    out = np.zeros(shares.shape[1:], np.int64)
    for coeff, share in zip(lam, shares):
        out = (out + coeff * share % p) % p
    return out


# ---------------------------------------------------------------------------
# Diffie-Hellman-style key agreement (pairwise mask seeds for SecAgg)
# ---------------------------------------------------------------------------


def dh_public_key(secret_key: int, p: int, g: int = 5) -> int:
    """g^sk mod p (reference my_pk_gen secagg.py:329-334)."""
    return pow(g, int(secret_key), p)


def dh_shared_key(my_secret: int, their_public: int, p: int) -> int:
    """their_pk^sk mod p (reference my_key_agreement secagg.py:337-341)."""
    return pow(int(their_public), int(my_secret), p)


# ---------------------------------------------------------------------------
# Fixed-point quantization between reals and GF(p)
# ---------------------------------------------------------------------------


def quantize(x: np.ndarray, q_bits: int, p: int) -> np.ndarray:
    """Real → field: round(x * 2^q), negatives wrapped to p + v.

    (Reference my_q secagg.py:344-348.)
    """
    xi = np.round(np.asarray(x, np.float64) * (1 << q_bits)).astype(np.int64)
    return np.where(xi < 0, xi + p, xi).astype(np.int64)


def dequantize(xq: np.ndarray, q_bits: int, p: int) -> np.ndarray:
    """Field → real: values above (p-1)/2 are negative.

    (Reference my_q_inv secagg.py:359-363.)
    """
    xq = np.asarray(xq, np.int64)
    xi = np.where(xq > (p - 1) // 2, xq - p, xq)
    return xi.astype(np.float64) / (1 << q_bits)
