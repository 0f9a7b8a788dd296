"""CKKS coefficient encoding: float weight blocks <-> RNS residue polynomials.

Counterpart of `hefl_tpu.ckks.encoding` (`encode`, `decode`,
`encode_overflow_count`). A whole N-coefficient block of weights is packed
per polynomial: encode is round(w * scale) reduced mod each RNS prime,
decode the mixed-radix CRT reconstruction divided by the tracked scale.

Both keep the JAX package's float32 steps in the same order, so encode gives
the same residues bit for bit, and decode agrees to about one float32 ulp
(XLA may contract a multiply-add that PyTorch runs as two ops). `torch.round`
rounds half to even, as `jnp.round` does. Integer steps compute in int64.
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
    lo = torch.clamp(torch.round(r * _f32(_SPLIT, dev)), -_SPLIT, _SPLIT).to(torch.int64)
    hi = hi_f.to(torch.int64)
    tabs = plain_tables(ctx, dev)
    p = tabs.p
    hi_res = modular.barrett_mod_signed(hi[..., None, :], p)
    lo_l = lo[..., None, :]
    lo_res = torch.where(lo_l < 0, lo_l + p, lo_l)
    primes = [int(pi) for pi in np.asarray(ctx.p)[:, 0]]
    shift_mont = _per_prime([host_to_mont(1 << _SPLIT_BITS, pi) for pi in primes], dev)
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
