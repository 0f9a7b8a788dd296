"""Host-side number theory for RNS-CKKS parameter generation.

Finds NTT-friendly primes p ≡ 1 (mod 2N) and primitive 2N-th roots of unity,
and precomputes the per-prime Montgomery constants consumed by
:mod:`hefl_tpu_torch.ckks.modular`. All arithmetic here is exact Python bignum on
the host — it runs once at context-creation time (the analog of the
reference's `HE.contextGen(p=65537, sec=128, m=1024)`,
FLPyfhelin.py:334-336), never in the per-round hot path.

Prime size note: limbs live in 32-bit words (uint32 in the JAX package, int32 here). Primes are kept below
2**27 so that a `psum` of up to 16 clients' residues stays below 2**31 and a
single modular reduction after the collective restores canonical form
(SURVEY.md §2.13 — the encrypted-FedAvg-over-ICI design).
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np

# Bases (2, 7, 61) make Miller-Rabin exact for all n < 4,759,123,141 (> 2**32).
_MR_BASES = (2, 7, 61)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 2**32."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in _MR_BASES:
        if a % n == 0:
            continue
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def host_to_mont(x: int, p: int) -> int:
    """Montgomery lift of a host integer: x * 2**32 mod p (canonicalizes x first)."""
    return ((x % p) << 32) % p


def find_ntt_primes(count: int, bits: int, two_n: int) -> list[int]:
    """Find `count` distinct primes p ≡ 1 (mod two_n) just below 2**bits.

    Searching downward from 2**bits keeps all primes the same width, which
    keeps the RNS limb magnitudes uniform.
    """
    if bits > 31:
        raise ValueError("primes must fit int32 (bits <= 31)")
    primes: list[int] = []
    candidate = (2**bits // two_n) * two_n + 1
    while len(primes) < count and candidate > two_n:
        if candidate < 2**bits and is_prime(candidate):
            primes.append(candidate)
        candidate -= two_n
    if len(primes) < count:
        raise ValueError(f"could not find {count} NTT primes below 2**{bits}")
    return primes


def find_primitive_root(p: int, order: int, seed: int = 0) -> int:
    """Find a primitive `order`-th root of unity mod p (order | p-1, order = 2N power of two)."""
    if (p - 1) % order != 0:
        raise ValueError("order must divide p-1")
    rng = random.Random(seed ^ p)
    exponent = (p - 1) // order
    while True:
        x = rng.randrange(2, p - 1)
        root = pow(x, exponent, p)
        # For power-of-two order, primitivity <=> root^(order/2) == -1.
        if pow(root, order // 2, p) == p - 1:
            return root


def bit_reverse(x: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


@dataclasses.dataclass(frozen=True)
class PrimeInfo:
    """Everything :mod:`modular` and :mod:`ntt` need for one RNS prime.

    Twiddle tables are stored in Montgomery form (value * 2**32 mod p) so a
    single REDC per butterfly multiply yields a plain-domain product.
    """

    p: int
    pinv_neg: int          # -p^{-1} mod 2**32 (Montgomery REDC constant)
    r2: int                # 2**64 mod p (to_montgomery multiplier)
    psi: int               # primitive 2N-th root of unity
    psi_rev: np.ndarray    # uint32[N], psi^bitrev(i), Montgomery form
    psi_inv_rev: np.ndarray  # uint32[N], psi^-bitrev(i)... inverse table, Montgomery form
    n_inv_mont: int        # N^{-1} mod p, Montgomery form

    @classmethod
    def build(cls, p: int, n: int, seed: int = 0) -> "PrimeInfo":
        logn = n.bit_length() - 1
        assert 1 << logn == n
        psi = find_primitive_root(p, 2 * n, seed=seed)
        psi_inv = pow(psi, p - 2, p)
        r = 1 << 32
        psi_rev = np.array(
            [host_to_mont(pow(psi, bit_reverse(i, logn), p), p) for i in range(n)],
            dtype=np.uint32,
        )
        psi_inv_rev = np.array(
            [host_to_mont(pow(psi_inv, bit_reverse(i, logn), p), p) for i in range(n)],
            dtype=np.uint32,
        )
        return cls(
            p=p,
            pinv_neg=(-pow(p, -1, r)) % r,
            r2=(r * r) % p,
            psi=psi,
            psi_rev=psi_rev,
            psi_inv_rev=psi_inv_rev,
            n_inv_mont=host_to_mont(pow(n, p - 2, p), p),
        )
