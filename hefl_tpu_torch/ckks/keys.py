"""CKKS context, key material and samplers.

Counterpart of `hefl_tpu.ckks.keys` for the encrypted FedAvg path. Keys are
plain int32 tensors in evaluation (NTT) domain, Montgomery form, with the
same trust split: `PublicKey` encrypts and adds, only `SecretKey` decrypts.

Randomness comes from an explicit `torch.Generator` in place of a
`jax.random` key. The two draw different numbers from the same seed, so the
sampling is split from the deterministic math: `keygen` draws (s, a, e) and
hands them to `keygen_core`, which a test can feed the JAX package's own
samples to get bit-identical keys.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from hefl_tpu_torch import resolve_device
from hefl_tpu_torch.ckks import modular
from hefl_tpu_torch.ckks.ntt import NTTContext, ntt_forward, plain_tables, to_mont
from hefl_tpu_torch.ckks.primes import find_ntt_primes

DEFAULT_N = 4096
DEFAULT_NUM_PRIMES = 3
DEFAULT_PRIME_BITS = 27   # < 2**27 so sums of many clients' residues stay small
DEFAULT_SCALE = 2.0**30
DEFAULT_SIGMA = 3.2       # discrete-gaussian noise width (HE-standard default)


@dataclasses.dataclass(frozen=True)
class CkksContext:
    """Public parameters: the NTT context plus scale and noise width.

    N=4096 with log2(q) = 3*27 = 81 <= 109 meets the HomomorphicEncryption.org
    128-bit classical bound for ternary secrets.
    """

    ntt: NTTContext
    scale: float = DEFAULT_SCALE
    sigma: float = DEFAULT_SIGMA

    @classmethod
    def create(
        cls,
        n: int = DEFAULT_N,
        num_primes: int = DEFAULT_NUM_PRIMES,
        prime_bits: int = DEFAULT_PRIME_BITS,
        scale: float = DEFAULT_SCALE,
        sigma: float = DEFAULT_SIGMA,
    ) -> "CkksContext":
        prime_list = find_ntt_primes(num_primes, prime_bits, 2 * n)
        q = 1
        for p in prime_list:
            q *= p
        # Plaintexts live centered mod q: round(w*scale) summed over up to 32
        # clients with |w| up to ~4 needs q/scale headroom of 2**8, else the
        # encoded weights wrap and decrypt to garbage with no error signal.
        if q < scale * 256:
            raise ValueError(
                f"ciphertext modulus too small: q~2**{q.bit_length()} must exceed "
                f"256*scale (scale=2**{int(scale).bit_length() - 1}); "
                "add RNS primes or lower the scale"
            )
        # 128-bit-security ceiling on log2(q) per ring dimension; rings below
        # N=1024 are test-only toys with no security claim.
        bound = {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438}.get(n)
        if bound is not None and q.bit_length() > bound:
            warnings.warn(
                f"log2(q)~{q.bit_length()} exceeds the 128-bit-security "
                f"ceiling of {bound} bits for N={n}; use a larger N (e.g. "
                f"N=8192 for a 5-prime depth-2 chain) or fewer/narrower "
                "primes if 128-bit security is required",
                stacklevel=2,
            )
        return cls(ntt=NTTContext.build(prime_list, n), scale=scale, sigma=sigma)

    @property
    def n(self) -> int:
        return self.ntt.n

    @property
    def num_primes(self) -> int:
        return self.ntt.num_primes

    @property
    def modulus(self) -> int:
        q = 1
        for p in np.asarray(self.ntt.p)[:, 0]:
            q *= int(p)
        return q


@dataclasses.dataclass
class SecretKey:
    s_mont: torch.Tensor       # int32[L, N], eval domain, Montgomery form


@dataclasses.dataclass
class PublicKey:
    b_mont: torch.Tensor       # int32[L, N]: -(a*s) + e, eval/Montgomery
    a_mont: torch.Tensor       # int32[L, N]: uniform a, eval/Montgomery


def _small_signed_residues(v: torch.Tensor, ctx: CkksContext) -> torch.Tensor:
    """Residues int32[..., L, N] of small signed coefficients |v| < p."""
    p = plain_tables(ctx.ntt, v.device).p                         # [L, 1]
    lifted = v.to(torch.int64)[..., None, :]
    return torch.where(lifted < 0, lifted + p, lifted).to(torch.int32)


def sample_ternary_residues(
    ctx: CkksContext, gen: torch.Generator, batch=(), device=None
) -> torch.Tensor:
    """Uniform ternary polynomial {-1,0,1}^N as canonical residues [..., L, N]."""
    coeffs = torch.randint(-1, 2, (*batch, ctx.n), generator=gen, device=gen.device)
    return _small_signed_residues(coeffs.to(device or gen.device), ctx)


def sample_gaussian_residues(
    ctx: CkksContext, gen: torch.Generator, batch=(), device=None
) -> torch.Tensor:
    """Rounded gaussian noise (sigma = ctx.sigma, clipped at 6 sigma)."""
    z = torch.randn((*batch, ctx.n), generator=gen, device=gen.device, dtype=torch.float32)
    e = torch.round(z * ctx.sigma)
    e = torch.clamp(e, -6.0 * ctx.sigma, 6.0 * ctx.sigma).to(torch.int32)
    return _small_signed_residues(e.to(device or gen.device), ctx)


def sample_uniform_eval(
    ctx: CkksContext, gen: torch.Generator, batch=(), device=None
) -> torch.Tensor:
    """Uniform element of R_q drawn directly in eval domain: per prime,
    residues uniform on [0, p) (CRT and the NTT are bijections)."""
    rows = [
        torch.randint(0, int(p), (*batch, ctx.n), generator=gen, device=gen.device)
        for p in np.asarray(ctx.ntt.p)[:, 0]
    ]
    return torch.stack(rows, dim=-2).to(torch.int32).to(device or gen.device)


def keygen_core(
    ctx: CkksContext, s_coeff: torch.Tensor, a_eval: torch.Tensor, e_coeff: torch.Tensor
) -> tuple[SecretKey, PublicKey]:
    """Deterministic RLWE keygen from sampled s (ternary, coefficient
    residues), a (uniform, eval domain) and e (gaussian, coefficient
    residues): s_mont = to_mont(NTT(s)), b = -(a*s) + NTT(e),
    pk = (to_mont(b), to_mont(a)). Each NTT is a K1 launch on CUDA."""
    ntt = ctx.ntt
    s_mont = to_mont(ntt, ntt_forward(ntt, s_coeff))
    e_eval = ntt_forward(ntt, e_coeff).to(torch.int64)
    tabs = plain_tables(ntt, s_coeff.device)
    a_s = modular.mont_mul(a_eval.to(torch.int64), s_mont.to(torch.int64), tabs.p, tabs.pinv_neg)
    b = modular.add_mod(modular.neg_mod(a_s, tabs.p), e_eval, tabs.p).to(torch.int32)
    return SecretKey(s_mont=s_mont), PublicKey(
        b_mont=to_mont(ntt, b), a_mont=to_mont(ntt, a_eval)
    )


def keygen(
    ctx: CkksContext, gen: torch.Generator, device=None
) -> tuple[SecretKey, PublicKey]:
    """RLWE keygen on `device` (CUDA unless given): s ternary; pk = (b, a)
    with b = -(a s) + e in eval domain. Samples from `gen`."""
    device = resolve_device(device)
    s = sample_ternary_residues(ctx, gen, device=device)
    a = sample_uniform_eval(ctx, gen, device=device)
    e = sample_gaussian_residues(ctx, gen, device=device)
    return keygen_core(ctx, s, a, e)
