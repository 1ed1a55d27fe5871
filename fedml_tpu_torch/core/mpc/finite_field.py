"""Finite-field primitives for secure aggregation: the counterpart of
``fedml_tpu/core/mpc/finite_field.py``.

Vectorized numpy (reference: python/fedml/core/mpc/secagg.py:8-120,
python/fedml/core/mpc/lightsecagg.py:8-81): batched Fermat inverses,
Lagrange coefficients, Lagrange-coded encoding, Shamir and additive shares
over GF(p), the Diffie-Hellman key agreement behind the pairwise mask
seeds, and fixed-point quantization. All arithmetic is int64 mod p with
p < 2^31, so a product fits in int64 but a sum of three or more products
may not: every Lagrange sum here (:func:`lcc_encode`, :func:`lcc_decode`,
:func:`shamir_reconstruct`) reduces each product mod p before it adds it,
where the JAX package sums the products in one int64 matmul that wraps
(``finite_field.py:92``, ``:101``, ``:137``; ROADMAP.md, Queue 3, R1 and
R2). The two agree wherever the JAX sum does not wrap.

The Lagrange sums and the quantizers take a numpy array or a torch tensor
and answer in kind, a tensor on its own device: integer arithmetic is exact
on either, so the round-barrier fronts run their large products on the
party's device and get numpy's answer. The state-dict helpers
(:func:`tree_to_finite`, :func:`tree_from_finite`, :func:`tree_dimensions`,
:func:`flatten_finite`, :func:`unflatten_finite`) stand for the JAX
package's pytree helpers and flatten in its flat order
(``models/convert.py`` ``wire_vector``), so coordinate k of a port vector
is coordinate k of a JAX one.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from ...models.convert import state_from_wire_vector, wire_order, wire_vector

Field = Union[np.ndarray, torch.Tensor]

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


def field_matmul(coeffs: np.ndarray, x: Field, p: int) -> Field:
    """``coeffs @ x`` in GF(p), one product at a time, each reduced mod p:
    a product is below p^2 < 2^62, so an int64 sum of three or more of them
    can wrap (the JAX package's ``U @ X`` does). ``x`` (rows, d) is a numpy
    array or a tensor; the answer is of its kind, on its device."""
    if isinstance(x, torch.Tensor):
        coeffs = torch.as_tensor(np.asarray(coeffs, np.int64), device=x.device)
    else:
        x = np.asarray(x, np.int64)
    x = x % p
    out = coeffs[:, :1] * x[0] % p
    for j in range(1, coeffs.shape[1]):
        out = (out + coeffs[:, j:j + 1] * x[j] % p) % p
    return out


def lcc_encode(X: Field, eval_points: np.ndarray, interp_points: np.ndarray, p: int) -> Field:
    """Lagrange-coded encoding: treat rows of X (shape (B, d)) as values of a
    polynomial at ``interp_points`` and evaluate it at ``eval_points``.

    Parity: LCC_encoding_with_points (lightsecagg.py:41-47).
    """
    return field_matmul(lagrange_coeffs(eval_points, interp_points, p), X, p)


def lcc_decode(f_eval: Field, eval_points: np.ndarray, target_points: np.ndarray, p: int) -> Field:
    """Inverse of lcc_encode: interpolate from evaluations back to targets.

    Parity: LCC_decoding_with_points (lightsecagg.py:50-56).
    """
    return field_matmul(lagrange_coeffs(target_points, eval_points, p), f_eval, p)


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
    lam = lagrange_coeffs(np.zeros(1, np.int64), xs, p)  # (1, len(idx))
    return field_matmul(lam, np.asarray(shares, np.int64), p)[0]


def additive_shares(d: int, n_out: int, p: int, rng: np.random.Generator) -> np.ndarray:
    """n_out additive shares of 0^d: rows sum to 0 mod p.

    (Reference Gen_Additive_SS secagg.py:316-326 generates shares of a
    random secret; sharing zero lets callers add the secret in themselves.)
    """
    shares = rng.integers(0, p, size=(n_out, d), dtype=np.int64)
    shares[-1] = np.mod(-shares[:-1].sum(axis=0), p)
    return shares


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
# Fixed-point quantization between reals and GF(p), over state dicts
# ---------------------------------------------------------------------------


def quantize(x: Field, q_bits: int, p: int) -> Field:
    """Real → field: round(x * 2^q) (half to even), negatives wrapped to
    p + v. A tensor is quantized on its device, in float64 as numpy does.

    (Reference my_q secagg.py:344-348.)
    """
    if isinstance(x, torch.Tensor):
        xi = torch.round(x.to(torch.float64) * (1 << q_bits)).to(torch.int64)
        return torch.where(xi < 0, xi + p, xi)
    xi = np.round(np.asarray(x, np.float64) * (1 << q_bits)).astype(np.int64)
    return np.where(xi < 0, xi + p, xi).astype(np.int64)


def dequantize(xq: Field, q_bits: int, p: int) -> Field:
    """Field → real (float64): values above (p-1)/2 are negative.

    (Reference my_q_inv secagg.py:359-363.)
    """
    if isinstance(xq, torch.Tensor):
        xi = torch.where(xq > (p - 1) // 2, xq - p, xq)
        return xi.to(torch.float64) / (1 << q_bits)
    xq = np.asarray(xq, np.int64)
    xi = np.where(xq > (p - 1) // 2, xq - p, xq)
    return xi.astype(np.float64) / (1 << q_bits)


def dequantize_mean(x_sum: torch.Tensor, n: int, q_bits: int, p: int) -> torch.Tensor:
    """The mean of ``n`` quantized vectors from their sum mod p, on its
    device, in the JAX fronts' order: dequantize in float64, cast to
    float32, divide by ``n`` in float32 (``sa_fedml_aggregator.py:89-95``).
    The divisor is a tensor: CUDA multiplies by the reciprocal of a Python
    scalar divisor, which is not always the quotient."""
    mean = dequantize(x_sum, q_bits, p).to(torch.float32)
    return mean / torch.full((), float(n), dtype=torch.float32, device=mean.device)


StateDict = Mapping[str, torch.Tensor]


def tree_to_finite(tree: StateDict, q_bits: int, p: int) -> Dict[str, torch.Tensor]:
    """Quantize every leaf of a state dict into GF(p), each on its device
    (reference transform_tensor_to_finite secagg.py:351-356)."""
    return {k: quantize(v, q_bits, p) for k, v in tree.items()}


def tree_from_finite(tree: StateDict, q_bits: int, p: int) -> Dict[str, torch.Tensor]:
    """Dequantize a GF(p) state dict back to float32 leaves (reference
    transform_finite_to_tensor secagg.py:366-382)."""
    return {k: dequantize(v, q_bits, p).to(torch.float32) for k, v in tree.items()}


def tree_dimensions(tree: StateDict) -> Tuple[List[int], int]:
    """Per-leaf sizes in the JAX flat order, and the total (reference
    model_dimension secagg.py:385-393)."""
    dims = [tree[k].numel() for k in wire_order(tree)]
    return dims, sum(dims)


def flatten_finite(tree: StateDict) -> torch.Tensor:
    """Every leaf in one int64 vector, in the JAX flat order and layout
    (``wire_vector``), on the leaves' device."""
    return wire_vector(tree, torch.int64)


def unflatten_finite(flat: torch.Tensor, template: StateDict) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`flatten_finite`: int64 leaves of ``template``'s
    names and shapes, on ``flat``'s device."""
    shapes = {k: torch.empty(v.shape, dtype=torch.int64, device="meta") for k, v in template.items()}
    return state_from_wire_vector(flat, shapes)
