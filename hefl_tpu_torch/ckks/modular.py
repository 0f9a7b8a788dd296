"""Modular arithmetic on residue tensors, computed in int64.

The plain PyTorch counterpart of `hefl_tpu.ckks.modular`. Residues are
canonical (0 <= x < p < 2**27); every helper takes int64 tensors (or Python
ints for `p` and the constants) and returns canonical int64 residues. The
products of two residues stay below 2**54, so nothing here overflows int64,
and because every output is canonical, any exact method gives the same words
as the JAX package's 16-bit-limb uint32 arithmetic.

Conventions kept from the JAX package:
  * "Montgomery form" of x is x * 2**32 mod p;
  * `mont_mul(a, b_mont) = a*b mod p` — key polynomials and twiddle tables
    are pre-lifted so data stays in the plain domain;
  * `shoup_mul(a, w, w_shoup)` is the Harvey/Shoup product with the
    host-precomputed quotient floor(w * 2**32 / p).

The CUDA kernels (`csrc/ntt.cu`) run the same REDC and Shoup steps on
uint32 words; these helpers are their plain versions.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def add_mod(a, b, p):
    """(a + b) mod p for canonical inputs."""
    t = a + b
    return torch.where(t >= p, t - p, t)


def sub_mod(a, b, p):
    """(a - b) mod p for canonical inputs."""
    t = a + p - b
    return torch.where(t >= p, t - p, t)


def neg_mod(a, p):
    """(-a) mod p for canonical input."""
    return torch.where(a == 0, a, p - a)


def mont_reduce(hi, lo, p, pinv_neg):
    """Montgomery REDC: (hi*2**32 + lo) * 2**-32 mod p for a value < p*2**32.

    m = lo * pinv_neg mod 2**32 is assembled from two 16-bit halves of
    `pinv_neg` so no intermediate leaves int64; lo + (m*p mod 2**32) is 0
    or 2**32, so it carries exactly when lo != 0.
    """
    m = (lo * (pinv_neg & _MASK16) + (((lo * (pinv_neg >> 16)) & _MASK16) << 16)) & MASK32
    t = hi + ((m * p) >> 32) + (lo != 0).to(torch.int64)
    return torch.where(t >= p, t - p, t)


def mont_mul(a, b, p, pinv_neg):
    """a * b * 2**-32 mod p. With b in Montgomery form this is plain a*b mod p."""
    prod = a * b
    return mont_reduce(prod >> 32, prod & MASK32, p, pinv_neg)


def shoup_mul(a, w, w_shoup, p):
    """a * w mod p with the Shoup quotient w_shoup = floor(w * 2**32 / p)."""
    q = (a * w_shoup) >> 32
    r = a * w - q * p                    # true value in [0, 2p)
    return torch.where(r >= p, r - p, r)


def barrett_mu(p):
    """floor(2**32 / p) (== floor((2**32 - 1) / p) for odd p)."""
    return MASK32 // p


def barrett_mod(x, p, mu=None):
    """x mod p for 0 <= x < 2**32, division-free (shift-multiply Barrett)."""
    if mu is None:
        mu = barrett_mu(p)
    q = (x * mu) >> 32
    r = x - q * p
    return torch.where(r >= p, r - p, r)


def barrett_mod_signed(x, p, mu=None):
    """numpy-remainder semantics (sign follows divisor) for |x| < 2**32."""
    r = barrett_mod(torch.abs(x), p, mu)
    return torch.where((x < 0) & (r != 0), p - r, r)


def to_signed_center(x, p):
    """Canonical residue -> centered representative in (-p/2, p/2]."""
    return torch.where(x > (p >> 1), x - p, x)
