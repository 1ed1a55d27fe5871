"""RLWE additively-homomorphic encryption: counterpart of
``fedml_tpu/core/fhe/rlwe.py`` (a CKKS-style scheme with coefficient
packing, standing in for the reference's TenSEAL context).

The algebra is the JAX package's: the ring R_q = Z_q[X]/(X^N + 1) with q a
product of 20-bit primes kept in RNS form, a ternary secret s, the public
key (b, a) with b = -(a*s) - e, Enc(m) = (b*u + e1 + m, a*u + e2) and
Dec = c0 + c1*s, then the CRT to centred integers over q and division by
the ciphertext's scale. Ciphertexts add and multiply by a plaintext
fixed-point weight, which is what the FedAvg fold needs.

What runs where:

- Every random draw stays host numpy in the JAX package's order: the key
  generator seeded from ``sha256(secret)`` draws s, a, e; the encryption
  generator ``RLWEContext._rng`` draws u, e1, e2 per chunk. With the same
  generators the port's keys and ciphertexts equal JAX's integer for
  integer.
- Every negacyclic ring product (a*s in keygen, b*u and a*u in encryption,
  c1*s in decryption) runs on the context's device. On a CUDA device one
  operand of each product is fixed for the context (a and b per prime, and
  the centred s, the same for every prime), so its N x N negacyclic matrix
  is built once and the other operand, stacked over every chunk of every
  leaf, is multiplied by it in float64. One operand is ternary in
  {-1, 0, 1} and the other a residue below p, so each partial sum is an
  integer of magnitude below N * p (asserted below N * p < 2^53): the
  float64 product is exact in any summation order, and the residues mod p
  equal the plain version's. The matrices cost (2 * n_primes + 1) * N^2 * 8
  bytes: 1.2 GB at the defaults (N = 4096, 4 primes).
- On the CPU the products are the JAX package's plain ``np.convolve``
  (:func:`negacyclic_mul`, copied); nothing on a CUDA path calls it.
- Ciphertexts hold ``c0``/``c1`` as int64 tensors ``[n_primes, n_chunks, N]``
  on the context's device; ``+`` and ``* w`` run there (products below
  2^40).
- Decryption's CRT (q is about 2^80, beyond int64) runs on the card as
  Garner's mixed-radix digits in int64 (:func:`garner_center`): the centred
  integer exactly, as two 40-bit limbs, whose float64 sum is the correctly
  rounded float64 of that integer, which is what the host's CRT over Python
  integers (:func:`crt_center`, JAX's ``_crt_center``, the plain version
  the CPU uses) gives. So both decrypt to the same float32 bits.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device

_SIGMA = 3.2
_WEIGHT_SCALE = 1 << 16  # fixed-point scale for plaintext scalar weights
_F64_EXACT = 1 << 53
_LIMB = 40  # garner_center's limb: a centred integer is hi * 2^40 + lo


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    i = 2
    while i * i <= n:
        if n % i == 0:
            return False
        i += 1
    return True


def _find_primes(count: int, bits: int = 20) -> List[int]:
    out: List[int] = []
    n = (1 << bits) - 1
    while len(out) < count:
        if _is_prime(n):
            out.append(n)
        n -= 2
    return out


def negacyclic_mul(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """Exact (a*b mod X^N+1 mod p) for int64 residue vectors: the plain
    version, the JAX package's ``_negacyclic_mul``."""
    full = np.convolve(a, b)  # len 2N-1, max coeff < N * p^2 < 2^63
    n = a.shape[-1]
    out = full[:n].copy()
    out[: n - 1] -= full[n:]
    return np.mod(out, p)


def negacyclic_matrix(v: torch.Tensor) -> torch.Tensor:
    """The N x N float64 matrix M with ``M @ x`` the negacyclic product
    ``v * x`` (mod X^N + 1): ``M[k, j] = v[k - j]`` for k >= j and
    ``-v[k - j + N]`` below the diagonal's wrap."""
    n = v.shape[-1]
    k = torch.arange(n, device=v.device)
    diff = k[:, None] - k[None, :]
    m = v.to(torch.float64)[diff % n]
    return torch.where(diff >= 0, m, -m)


@dataclasses.dataclass
class RLWEParams:
    n: int = 4096
    n_primes: int = 4
    prime_bits: int = 20
    delta: int = 1 << 30  # message fixed-point scale
    sigma: float = _SIGMA

    def __post_init__(self):
        self.primes = _find_primes(self.n_primes, self.prime_bits)
        self.q = 1
        for p in self.primes:
            self.q *= p
        # the float64 ring products are exact only while every partial sum
        # (ternary times residue, N terms) stays below 2^53
        assert self.n * max(self.primes) < _F64_EXACT, (self.n, self.primes)


_PRIMES_CACHE: Dict[Tuple[Tuple[int, ...], str], torch.Tensor] = {}


def _primes_tensor(params: RLWEParams, device: torch.device) -> torch.Tensor:
    """The primes as an int64 ``[n_primes, 1, 1]`` tensor on ``device``."""
    key = (tuple(params.primes), str(device))
    t = _PRIMES_CACHE.get(key)
    if t is None:
        t = _PRIMES_CACHE[key] = torch.tensor(params.primes, dtype=torch.int64,
                                              device=device).view(-1, 1, 1)
    return t


class Ciphertext:
    """One encrypted tensor: RNS residues ``[n_primes, n_chunks, N]`` for
    c0/c1, int64 on the context's device. ``+`` and ``* w`` are the two
    homomorphic operations the fold (``core/aggregation/bucketed.py``'s
    object-leaf path) needs."""

    __slots__ = ("c0", "c1", "shape", "size", "scale", "params")

    def __init__(self, c0, c1, shape, size, scale, params: RLWEParams):
        self.c0, self.c1 = c0, c1
        self.shape, self.size = shape, size
        self.scale = scale
        self.params = params

    @property
    def nbytes(self) -> int:
        return self.c0.numel() * self.c0.element_size() + self.c1.numel() * self.c1.element_size()

    def __add__(self, other: "Ciphertext") -> "Ciphertext":
        if not isinstance(other, Ciphertext):
            return NotImplemented
        assert self.scale == other.scale, "adding ciphertexts at different scales"
        primes = _primes_tensor(self.params, self.c0.device)
        return Ciphertext(
            (self.c0 + other.c0) % primes, (self.c1 + other.c1) % primes,
            self.shape, self.size, self.scale, self.params,
        )

    __radd__ = __add__

    def __mul__(self, w) -> "Ciphertext":
        """Plaintext fixed-point scalar multiply (the FedAvg weight), as JAX
        does: ``k = round(float(w) * 2^16)`` reduced per prime."""
        k = int(round(float(w) * _WEIGHT_SCALE))
        primes = _primes_tensor(self.params, self.c0.device)
        ks = torch.full_like(primes, k) % primes  # a fill, no host copy
        return Ciphertext(
            (self.c0 * ks) % primes, (self.c1 * ks) % primes,
            self.shape, self.size, self.scale * _WEIGHT_SCALE, self.params,
        )

    __rmul__ = __mul__


class RLWEContext:
    """Keygen, encryption and decryption on ``device``. Encryption and
    decryption take a list of tensors at once (:meth:`encrypt_many`,
    :meth:`decrypt_many`), so a whole state dict is one ring product."""

    def __init__(self, params: Optional[RLWEParams] = None, seed: int = 0,
                 device: Any = "cuda", route: Optional[str] = None):
        self.params = params or RLWEParams()
        P = self.params
        self.device = resolve_device(device)
        # "matrix": the float64 negacyclic matrices on the device; "plain":
        # np.convolve per product on the host (the CPU's route)
        self.route = route or ("matrix" if self.device.type == "cuda" else "plain")
        if self.route not in ("matrix", "plain"):
            raise ValueError(f"route must be 'matrix' or 'plain', got {self.route!r}")
        rng = np.random.default_rng(seed)
        # ENCRYPTION randomness is fresh OS entropy, never the key seed (the
        # JAX package's reasoning: identically seeded parties would emit
        # identical (u, e1, e2) and leak plaintext differences); tests set a
        # seeded generator here on both packages
        self._rng = np.random.default_rng()
        self._draw_lock = threading.Lock()
        s = rng.integers(-1, 2, P.n).astype(np.int64)
        s_res = np.stack([s % p for p in P.primes])  # [n_primes, N]
        a = np.stack([rng.integers(0, p, P.n, dtype=np.int64) for p in P.primes])
        e = np.rint(rng.normal(0, P.sigma, P.n)).astype(np.int64)
        del rng  # key-derivation stream must not leak into encryption
        self._s_host = s_res
        self._primes = _primes_tensor(P, self.device)
        if self.route == "matrix":
            dev = self.device
            self._s_mat = negacyclic_matrix(torch.from_numpy(s).to(dev))
            a_t = torch.from_numpy(a).to(dev)
            as_ = self._ring(self._s_mat, a_t.T).T  # [n_primes, N]: a_i * s
            b_t = (-as_ - torch.from_numpy(e).to(dev)) % self._primes[:, :, 0]
            # b and a per prime, stacked [2 * n_primes, N, N]
            self._pk_mats = torch.stack([negacyclic_matrix(v) for v in (*b_t, *a_t)])
        else:
            b_t = torch.from_numpy(np.stack(
                [(-negacyclic_mul(a[i], s_res[i], p) - e) % p for i, p in enumerate(P.primes)]))
            a_t = torch.from_numpy(a)
        self.s = torch.from_numpy(s_res).to(self.device)
        self.pk = (b_t.to(self.device), a_t.to(self.device))

    # --- ring products -----------------------------------------------------
    @staticmethod
    def _ring(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``mat @ x`` of integer-valued float64 operands, exact (see the
        module docstring), back to int64 (not yet reduced)."""
        return torch.matmul(mat, x.to(torch.float64)).to(torch.int64)

    # --- encoding ----------------------------------------------------------
    def _encode(self, xs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, List[int]]:
        """Every tensor of ``xs`` in fixed point ``rint(x * delta)``, zero
        padded to whole chunks of N and stacked ``[total_chunks, N]`` on the
        device, with each tensor's chunk count."""
        n = self.params.n
        rows, counts = [], []
        for x in xs:
            flat = x.detach().reshape(-1).to(self.device, torch.float64)
            fixed = torch.round(flat * self.params.delta).to(torch.int64)
            n_chunks = max(1, -(-flat.numel() // n))
            rows.append(torch.nn.functional.pad(fixed, (0, n_chunks * n - flat.numel())).view(n_chunks, n))
            counts.append(n_chunks)
        return torch.cat(rows), counts

    def _draws(self, total_chunks: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """u, e1, e2 for each chunk, drawn chunk by chunk in JAX's order."""
        P = self.params
        u = np.empty((total_chunks, P.n), np.int64)
        e1 = np.empty_like(u)
        e2 = np.empty_like(u)
        rng = self._rng
        with self._draw_lock:  # cross-silo clients share the generator
            for j in range(total_chunks):
                u[j] = rng.integers(-1, 2, P.n)
                e1[j] = np.rint(rng.normal(0, P.sigma, P.n))
                e2[j] = np.rint(rng.normal(0, P.sigma, P.n))
        return u, e1, e2

    def encrypt_many(self, xs: Sequence[torch.Tensor]) -> List[Ciphertext]:
        """One ciphertext per tensor; the draws are taken tensor by tensor,
        chunk by chunk, as a loop of JAX ``encrypt`` calls takes them."""
        P = self.params
        chunks, counts = self._encode(xs)
        total = chunks.shape[0]
        u, e1, e2 = self._draws(total)
        if self.route == "matrix":
            dev = self.device
            u_t = torch.from_numpy(u).to(dev)
            e1_t = torch.from_numpy(e1).to(dev)
            e2_t = torch.from_numpy(e2).to(dev)
            prod = self._ring(self._pk_mats, u_t.T)  # [2 * n_primes, N, total]
            bu = prod[:P.n_primes].transpose(1, 2)
            au = prod[P.n_primes:].transpose(1, 2)
            c0 = (bu + e1_t + chunks) % self._primes
            c1 = (au + e2_t) % self._primes
        else:
            b, a = (t.numpy() for t in self.pk)
            m = chunks.numpy()
            c0n = np.empty((P.n_primes, total, P.n), np.int64)
            c1n = np.empty_like(c0n)
            for j in range(total):
                for i, p in enumerate(P.primes):
                    c0n[i, j] = (negacyclic_mul(b[i], u[j] % p, p) + e1[j] + m[j]) % p
                    c1n[i, j] = (negacyclic_mul(a[i], u[j] % p, p) + e2[j]) % p
            c0, c1 = torch.from_numpy(c0n), torch.from_numpy(c1n)
        out, off = [], 0
        for x, k in zip(xs, counts):
            out.append(Ciphertext(c0[:, off:off + k].contiguous(), c1[:, off:off + k].contiguous(),
                                  tuple(x.shape), x.numel(), P.delta, P))
            off += k
        return out

    def encrypt(self, x: torch.Tensor) -> Ciphertext:
        return self.encrypt_many([x])[0]

    # --- decryption ----------------------------------------------------------
    def decrypt_residues(self, cts: Sequence[Ciphertext]) -> torch.Tensor:
        """``(c0 + c1 * s) mod p`` of every ciphertext, stacked along the
        chunk axis ``[n_primes, total_chunks, N]`` on the device."""
        P = self.params
        c0 = torch.cat([ct.c0.to(self.device) for ct in cts], dim=1)
        c1 = torch.cat([ct.c1.to(self.device) for ct in cts], dim=1)
        if self.route == "matrix":
            total = c1.shape[1]
            # the centred s is the same for every prime: one matrix for all
            x = c1.reshape(P.n_primes * total, P.n).T
            c1s = self._ring(self._s_mat, x).T.reshape(P.n_primes, total, P.n)
            return (c0 + c1s) % self._primes
        c0n, c1n = c0.numpy(), c1.numpy()
        res = np.empty_like(c0n)
        for i, p in enumerate(P.primes):
            for j in range(c0n.shape[1]):
                res[i, j] = (c0n[i, j] + negacyclic_mul(c1n[i, j], self._s_host[i], p)) % p
        return torch.from_numpy(res)

    def decode(self, res: torch.Tensor, cts: Sequence[Ciphertext],
               host_crt: Optional[bool] = None) -> List[torch.Tensor]:
        """:meth:`decrypt_residues`' output through the CRT to centred
        integers (on the card by :func:`garner_center`, on the CPU, or with
        ``host_crt``, by the host's :func:`crt_center`), divided by each
        ciphertext's scale, as float32 tensors of the plaintexts' shapes on
        the device."""
        P = self.params
        if host_crt is None:
            host_crt = self.route == "plain"
        if not host_crt:
            centered = garner_center(res, P.primes, P.q)
        else:
            centered = torch.from_numpy(
                crt_center(res.cpu().numpy(), P.primes, P.q).astype(np.float64))
        out, off = [], 0
        for ct in cts:
            k = ct.c0.shape[1]
            # a true division (CUDA would multiply by a scalar's reciprocal)
            scale = torch.tensor(float(ct.scale), dtype=torch.float64, device=centered.device)
            vals = centered[off:off + k] / scale
            out.append(vals.reshape(-1)[: ct.size].reshape(ct.shape).to(self.device, torch.float32))
            off += k
        return out

    def decrypt_many(self, cts: Sequence[Ciphertext]) -> List[torch.Tensor]:
        return self.decode(self.decrypt_residues(cts), cts)

    def decrypt(self, ct: Ciphertext) -> torch.Tensor:
        return self.decrypt_many([ct])[0]


def crt_center(res: np.ndarray, primes: Sequence[int], q: int) -> np.ndarray:
    """Garner-free CRT over Python integers (JAX ``_crt_center``): combine
    residues ``[n_primes, ...]`` into centred representatives."""
    x = np.zeros(res.shape[1:], dtype=object)
    for i, p in enumerate(primes):
        qi = q // p
        inv = pow(qi % p, -1, p)
        x = x + (res[i].astype(object) * ((qi * inv) % q))
    x = x % q
    half = q // 2
    return np.where(x > half, x - q, x)


def garner_center(res: torch.Tensor, primes: Sequence[int], q: int) -> torch.Tensor:
    """The CRT of residues ``[n_primes, ...]`` (int64, each below its prime)
    to the centred integer in (-q/2, q/2], as the correctly rounded float64,
    on the residues' device, exactly: Garner's mixed-radix digits (each
    step a product below 2^40), then Horner's rule in two limbs of 40 bits,
    the centring by a borrow, and ``float64(hi) * 2^40 + float64(lo)``, a
    sum of two exact doubles and so one correctly rounded result."""
    assert max(primes) < 1 << 22, "limb products must stay below 2^63"
    mask = (1 << _LIMB) - 1
    digits: List[torch.Tensor] = []
    for i, p in enumerate(primes):
        t = res[i]
        for j, v in enumerate(digits):
            t = ((t - v) % p) * (pow(primes[j] % p, -1, p)) % p
        digits.append(t)
    hi, lo = torch.zeros_like(digits[-1]), digits[-1]
    for i in range(len(primes) - 2, -1, -1):  # x = v_i + p_i * x
        lo = digits[i] + primes[i] * lo
        hi, lo = primes[i] * hi + (lo >> _LIMB), lo & mask
    half = q // 2
    above = (hi > half >> _LIMB) | ((hi == half >> _LIMB) & (lo > (half & mask)))
    lo_c = lo - (q & mask)
    borrow = (lo_c < 0).to(torch.int64)
    hi_c = hi - (q >> _LIMB) - borrow
    lo_c = lo_c + (borrow << _LIMB)
    hi, lo = torch.where(above, hi_c, hi), torch.where(above, lo_c, lo)
    return hi.to(torch.float64) * float(1 << _LIMB) + lo.to(torch.float64)


class RLWEScheme:
    """The ``rlwe`` scheme of ``fhe_agg.py``: state-dict encryption and
    decryption. The key seed is ``sha256(secret)``, as in the JAX package
    (every party loads the same shared context)."""

    def __init__(self, secret: bytes, params: Optional[RLWEParams] = None,
                 device: Any = "cuda"):
        seed = int.from_bytes(hashlib.sha256(secret).digest()[:8], "little")
        self.ctx = RLWEContext(params, seed=seed, device=device)

    def encrypt(self, tree: Dict[str, Any], nonce: int) -> Dict[str, Ciphertext]:
        cts = self.ctx.encrypt_many(list(tree.values()))
        return dict(zip(tree, cts))

    def decrypt_sum(self, tree: Dict[str, Any], nonces=None, weights=None) -> Dict[str, torch.Tensor]:
        return dict(zip(tree, self.ctx.decrypt_many(list(tree.values()))))
