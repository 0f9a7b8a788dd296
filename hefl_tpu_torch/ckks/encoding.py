"""CKKS encoding: float weight blocks or slot vectors <-> RNS residue polynomials.

Counterpart of `hefl_tpu.ckks.encoding`. Coefficient packing (`encode`,
`decode`, `encode_overflow_count`) is the FedAvg wire format: a whole
N-coefficient block of weights per polynomial, encode is round(w * scale)
reduced mod each RNS prime, decode the mixed-radix CRT reconstruction
divided by the tracked scale. Slot packing (`encode_slots`, `decode_slots`)
is the serving format: host-side float64 numpy, copied from
the JAX package, so the residues are the same words.

Both keep the JAX package's float32 steps in the same order, so encode gives
the same residues bit for bit, and decode agrees to about one float32 ulp
(XLA may contract a multiply-add that PyTorch runs as two ops). `torch.round`
rounds half to even, as `jnp.round` does. Integer steps compute in int64.
The packed-integer codec (`encode_packed`, `decode_int_center`) is exact:
it carries up-to-62-bit integers and never touches floats.
"""

from __future__ import annotations

import numpy as np
import torch

from hefl_tpu_torch.ckks import modular
from hefl_tpu_torch.ckks.ntt import NTTContext, plain_tables
from hefl_tpu_torch.ckks.primes import host_to_mont

# v = round(w*scale) is carried as v = hi * 2**_SPLIT_BITS + lo with hi and lo
# independent int32s, so the encode envelope is set by the int32 range of
# `hi` (backed off 256 from 2**31 for float32 rounding slop): |w| < ~2**16 at
# the default scale 2**30. Beyond it the encoder saturates.
_SPLIT_BITS = 15
_SPLIT = float(1 << _SPLIT_BITS)
_HI_BOUND = float(2**31 - 256)
ENCODE_BOUND = _HI_BOUND * _SPLIT


def _f32(x: float, device) -> torch.Tensor:
    """A float32 scalar tensor holding float32(x), like `jnp.float32(x)`."""
    return torch.tensor(np.float32(x), device=device)


def _per_prime(values, device) -> torch.Tensor:
    return torch.tensor([[v] for v in values], dtype=torch.int64, device=device)


def encode(ctx: NTTContext, values: torch.Tensor, scale: float) -> torch.Tensor:
    """float[..., N] -> canonical residues int32[..., L, N] (coefficient domain).

    hi = clip(round(w * scale/2**15)), lo = round((w*scale/2**15 - hi) * 2**15):
    exact in float32 for |w*scale| < 2**39 (see the JAX package's `encode`).
    """
    v = values.to(torch.float32)
    dev = v.device
    s_hi = _f32(scale / _SPLIT, dev)
    hi_f = torch.clamp(torch.round(v * s_hi), -_HI_BOUND, _HI_BOUND)
    r = v * s_hi - hi_f
    lo_f = torch.clamp(torch.round(r * _f32(_SPLIT, dev)), -_SPLIT, _SPLIT)
    # A NaN coefficient (a diverged or poisoned client's weight) encodes to
    # 0, as XLA's float->int conversion gives in the JAX package; the int64
    # cast of NaN is not defined, so select before casting.
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lo = torch.where(torch.isnan(lo_f), zero, lo_f).to(torch.int64)
    hi = torch.where(torch.isnan(hi_f), zero, hi_f).to(torch.int64)
    tabs = plain_tables(ctx, dev)
    p = tabs.p
    hi_res = modular.barrett_mod_signed(hi[..., None, :], p)
    lo_l = lo[..., None, :]
    lo_res = torch.where(lo_l < 0, lo_l + p, lo_l)
    primes = [int(pi) for pi in np.asarray(ctx.p)[:, 0]]
    shift_mont = _per_prime([host_to_mont(1 << _SPLIT_BITS, pi) for pi in primes], dev)
    hi_shift = modular.mont_mul(hi_res, shift_mont, p, tabs.pinv_neg)
    return modular.add_mod(hi_shift, lo_res, p).to(torch.int32)


def encode_packed(ctx: NTTContext, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Exact integer encode of v = hi * 2**31 + lo (int32 words < 2**31)
    -> canonical residues int32[..., L, N]: (hi mod p) * (2**31 mod p) +
    (lo mod p), Barrett reductions and a Montgomery product, no floats."""
    tabs = plain_tables(ctx, hi.device)
    p = tabs.p
    hi_res = modular.barrett_mod(hi.to(torch.int64)[..., None, :], p)
    lo_res = modular.barrett_mod(lo.to(torch.int64)[..., None, :], p)
    primes = [int(pi) for pi in np.asarray(ctx.p)[:, 0]]
    shift_mont = _per_prime([host_to_mont((1 << 31) % pi, pi) for pi in primes], hi.device)
    hi_shift = modular.mont_mul(hi_res, shift_mont, p, tabs.pinv_neg)
    return modular.add_mod(hi_shift, lo_res, p).to(torch.int32)


def encode_overflow_count(values: torch.Tensor, scale: float) -> torch.Tensor:
    """How many of `values` would saturate in `encode` at this scale."""
    scaled = torch.abs(values.to(torch.float32)) * _f32(scale, values.device)
    return torch.sum(scaled > ENCODE_BOUND)


def _mixed_radix_digits(ctx: NTTContext, residues: torch.Tensor) -> list[torch.Tensor]:
    """Centered mixed-radix digits (int64) of the CRT value:
    v = sum_i d_i * (p_0 ... p_{i-1}), every |d_i| <= p_i / 2.

    Exact integer steps; the same sequence as the JAX package's
    `_mixed_radix_digits` (hefl_tpu/ckks/encoding.py:149)."""
    primes = [int(x) for x in np.asarray(ctx.p)[:, 0]]
    pinvs = [int(x) for x in np.asarray(ctx.pinv_neg)[:, 0]]
    digits: list[torch.Tensor] = []
    for i, pi in enumerate(primes):
        acc = residues[..., i, :].to(torch.int64)
        run = 1
        for j, d in enumerate(digits):
            d_res = modular.barrett_mod_signed(d, pi)
            term = modular.mont_mul(d_res, host_to_mont(run, pi), pi, pinvs[i])
            acc = modular.sub_mod(acc, term, pi)
            run *= primes[j]
        if i > 0:
            inv_mont = host_to_mont(pow(run % pi, pi - 2, pi), pi)
            acc = modular.mont_mul(acc, inv_mont, pi, pinvs[i])
        digits.append(modular.to_signed_center(acc, pi))
    return digits


def decode(ctx: NTTContext, residues: torch.Tensor, scale: float) -> torch.Tensor:
    """Canonical residues int32[..., L, N] -> float32[..., N].

    Float32 recombination in the JAX package's order (encoding.py:188-204):
    exact for |v| < 2**24 * p0, ~2**-19 relative error at the full q."""
    digits = _mixed_radix_digits(ctx, residues)
    dev = residues.device
    primes = np.asarray(ctx.p)[:, 0]
    inv_scale = 1.0 / float(scale)
    out = digits[0].to(torch.float32) * _f32(inv_scale, dev)
    radix = 1.0
    for i in range(1, len(digits)):
        radix *= float(int(primes[i - 1]))
        out = out + digits[i].to(torch.float32) * _f32(radix * inv_scale, dev)
    return out


def decode_int_center(ctx: NTTContext, residues: torch.Tensor) -> np.ndarray:
    """Residues int32[..., L, N] -> the centered CRT value as EXACT int64
    numpy (the packed decode's bit fields).

    The digits come from `_mixed_radix_digits`; the recombination runs on
    the host in uint64 two's complement, as the JAX package's does (numpy:
    torch has no CPU uint64 multiply). It wraps mod 2**64, which is exact
    for the |v| < 2**62 a packed payload respects."""
    digits = _mixed_radix_digits(ctx, residues)
    primes = np.asarray(ctx.p)[:, 0]
    acc = None
    prefix = 1
    for i, d in enumerate(digits):
        c = np.uint64(prefix & 0xFFFFFFFFFFFFFFFF)
        term = d.cpu().numpy().astype(np.int64).astype(np.uint64) * c
        acc = term if acc is None else acc + term
        prefix *= int(primes[i])
    return acc.astype(np.int64)


def decode_exact(ctx: NTTContext, residues: np.ndarray, scale: float) -> np.ndarray:
    """Exact host-side decode (Garner CRT, centered mod q): residues uint32
    numpy [..., L, N] -> float64. Runs the native C++ decode
    (`hefl_tpu_torch.native`), which raises if it cannot be built; it is
    bitwise `decode_exact_plain`."""
    from hefl_tpu_torch import native

    return native.crt_decode_exact(np.asarray(residues), np.asarray(ctx.p)[:, 0], scale)


def decode_exact_plain(ctx: NTTContext, residues: np.ndarray, scale: float) -> np.ndarray:
    """Plain version of `decode_exact`: the Python-bignum Garner CRT over an
    object array, as the JAX package's `decode_exact(prefer_native=False)`."""
    res = np.asarray(residues)
    p = [int(x) for x in np.asarray(ctx.p)[:, 0]]
    q = 1
    for pi in p:
        q *= pi
    v = res[..., 0, :].astype(object)
    prefix = 1
    for i in range(1, len(p)):
        prefix *= p[i - 1]
        inv = pow(prefix % p[i], p[i] - 2, p[i])
        diff = (res[..., i, :].astype(object) - v) % p[i]
        v = v + ((diff * inv) % p[i]) * prefix
    v = np.where(v > q // 2, v - q, v)
    return (v / float(scale)).astype(np.float64)


# --- Slot (canonical-embedding) packing, host float64 ----------------------
# Slot j's root is zeta^{5^j mod 2N} (the Galois-orbit ordering: X -> X^5
# cyclically shifts slots, X -> X^{-1} conjugates them).


def num_slots(ctx: NTTContext) -> int:
    return ctx.n // 2


def _orbit_positions(n: int) -> np.ndarray:
    """pos[j] = (5^j mod 2n - 1) / 2: slot j's root among the odd powers."""
    g = 1
    pos = np.empty(n // 2, dtype=np.int64)
    for j in range(n // 2):
        pos[j] = (g - 1) // 2
        g = (g * 5) % (2 * n)
    return pos


def encode_slots(ctx: NTTContext, z: np.ndarray, scale: float) -> np.ndarray:
    """complex (or real) [..., N/2] slot values -> residues uint32[..., L, N]."""
    n = ctx.n
    z = np.asarray(z, dtype=np.complex128)
    if z.shape[-1] != n // 2:
        raise ValueError(f"expected {n // 2} slots, got {z.shape[-1]}")
    pos = _orbit_positions(n)
    ev = np.zeros(z.shape[:-1] + (n,), dtype=np.complex128)
    ev[..., pos] = z
    ev[..., n - 1 - pos] = np.conj(z)
    tw = np.exp(-1j * np.pi * np.arange(n) / n)
    a = np.real(np.fft.fft(ev, axis=-1) / n * tw)
    coeffs = np.round(a * scale).astype(np.int64)
    p = np.asarray(ctx.p)[:, 0].astype(np.int64)
    res = np.mod(coeffs[..., None, :], p[:, None])
    return res.astype(np.uint32)


def encode_slots_const(ctx: NTTContext, c: float, scale: float) -> np.ndarray:
    """Constant-in-every-slot plaintext: the constant polynomial
    round(c*scale), written directly (no FFT)."""
    p = np.asarray(ctx.p)[:, 0].astype(np.int64)
    coeff = int(round(c * scale))
    q = 1
    for pi in p:
        q *= int(pi)
    if 2 * abs(coeff) >= q:
        raise ValueError(
            f"encode_slots_const saturates: |round(c*scale)|={abs(coeff):.3e} "
            f"must stay below q/2~{q / 2:.3e}; lower the scale or add primes"
        )
    res = np.zeros((len(p), ctx.n), np.int64)
    res[:, 0] = np.mod(coeff, p)
    return res.astype(np.uint32)


def decode_slots(ctx: NTTContext, residues: np.ndarray, scale: float) -> np.ndarray:
    """Residues uint32[..., L, N] -> complex128 slot values [..., N/2]."""
    n = ctx.n
    coeffs = decode_exact(ctx, residues, 1.0)
    tw = np.exp(1j * np.pi * np.arange(n) / n)
    ev = np.fft.ifft(coeffs * tw, axis=-1) * n
    return ev[..., _orbit_positions(n)] / float(scale)
