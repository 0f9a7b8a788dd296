"""Negacyclic NTT over RNS limbs: context tables and the plain PyTorch transforms.

Counterpart of `hefl_tpu.ckks.ntt`. The forward transform is the merged
Cooley-Tukey decimation-in-time with the 2N-th root folded into bit-reversed
twiddle tables, the inverse the matching Gentleman-Sande decimation-in-
frequency followed by a multiply by N^-1; the output order ("evaluation
domain") is bit-reversed. Twiddle multiplies use the Harvey/Shoup quotient.

Shapes: residue tensors are int32[..., L, N]. `ntt_forward`/`ntt_inverse`
run where their tensor lives: on a CUDA tensor they launch the hand-written
kernels (`cuda_ntt`), on a CPU tensor the plain stage loops below
(`ntt_forward_plain`/`ntt_inverse_plain`), which mirror the JAX package's
stage loops (hefl_tpu/ckks/ntt.py:224-236 and :252-266) in int64.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from hefl_tpu_torch.ckks import primes as primes_mod
from hefl_tpu_torch.ckks.modular import add_mod, mont_mul, shoup_mul, sub_mod


@dataclasses.dataclass(frozen=True)
class NTTContext:
    """Per-modulus-chain constant tables (host numpy, uint32).

    The same fields as the JAX package's NTTContext, built by the same host
    number theory from the same seed, so the tables are equal word for word.
    Device copies are made on demand by `plain_tables`/`kernel_tables` and
    cached on the context.
    """

    n: int
    logn: int
    p: np.ndarray             # uint32[L, 1]
    pinv_neg: np.ndarray      # uint32[L, 1]
    r2: np.ndarray            # uint32[L, 1]
    psi_rev: np.ndarray       # uint32[L, N], Montgomery form
    psi_inv_rev: np.ndarray   # uint32[L, N], Montgomery form
    n_inv_mont: np.ndarray    # uint32[L, 1]
    _device_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @classmethod
    def build(cls, prime_list: list[int], n: int, seed: int = 0) -> "NTTContext":
        infos = [primes_mod.PrimeInfo.build(p, n, seed=seed) for p in prime_list]

        def col(attr):
            return np.array([[getattr(i, attr)] for i in infos], dtype=np.uint32)

        return cls(
            n=n,
            logn=n.bit_length() - 1,
            p=col("p"),
            pinv_neg=col("pinv_neg"),
            r2=col("r2"),
            psi_rev=np.stack([i.psi_rev for i in infos]),
            psi_inv_rev=np.stack([i.psi_inv_rev for i in infos]),
            n_inv_mont=col("n_inv_mont"),
        )

    @property
    def num_primes(self) -> int:
        return int(self.p.shape[0])

    def slice_limbs(self, lo: int, hi: int) -> "NTTContext":
        """Sub-context over primes [lo, hi) (rescale, level drops). Cached on
        this context, so the slice's device tables are built once."""
        key = ("slice", lo, hi)
        hit = self._device_cache.get(key)
        if hit is None:
            hit = NTTContext(
                n=self.n,
                logn=self.logn,
                p=self.p[lo:hi],
                pinv_neg=self.pinv_neg[lo:hi],
                r2=self.r2[lo:hi],
                psi_rev=self.psi_rev[lo:hi],
                psi_inv_rev=self.psi_inv_rev[lo:hi],
                n_inv_mont=self.n_inv_mont[lo:hi],
            )
            self._device_cache[key] = hit
        return hit

    def __hash__(self):
        return hash((self.n, tuple(int(x) for x in self.p[:, 0]), self.psi_rev[:, :2].tobytes()))

    def __eq__(self, other):
        return (
            isinstance(other, NTTContext)
            and self.n == other.n
            and np.array_equal(self.p, other.p)
            and np.array_equal(self.psi_rev, other.psi_rev)
        )


@dataclasses.dataclass(frozen=True)
class ShoupTables:
    """Plain-domain twiddles + Harvey/Shoup quotients (host numpy, uint32)."""

    psi: np.ndarray           # uint32[L, N] plain-domain forward twiddles
    psi_shoup: np.ndarray     # uint32[L, N] floor(psi * 2**32 / p)
    psi_inv: np.ndarray       # uint32[L, N] plain-domain inverse twiddles
    psi_inv_shoup: np.ndarray
    n_inv: np.ndarray         # uint32[L, 1] plain-domain N^{-1}
    n_inv_shoup: np.ndarray   # uint32[L, 1]


@functools.lru_cache(maxsize=16)
def shoup_tables(ctx: NTTContext) -> ShoupTables:
    """Derived exactly on the host from the Montgomery tables:
    plain = mont * 2**-32 mod p, shoup = floor(plain * 2**32 / p)."""
    p = np.asarray(ctx.p)[:, 0].astype(object)[:, None]       # [L, 1]
    inv32 = np.array([[pow(1 << 32, -1, int(pi))] for pi in p[:, 0]], dtype=object)

    def unmont(mont: np.ndarray) -> np.ndarray:
        return (mont.astype(object) * inv32) % p

    def shoup(plain: np.ndarray) -> np.ndarray:
        return (plain << 32) // p

    psi = unmont(np.asarray(ctx.psi_rev))
    psi_inv = unmont(np.asarray(ctx.psi_inv_rev))
    n_inv = unmont(np.asarray(ctx.n_inv_mont))
    return ShoupTables(
        psi=psi.astype(np.uint32),
        psi_shoup=shoup(psi).astype(np.uint32),
        psi_inv=psi_inv.astype(np.uint32),
        psi_inv_shoup=shoup(psi_inv).astype(np.uint32),
        n_inv=n_inv.astype(np.uint32),
        n_inv_shoup=shoup(n_inv).astype(np.uint32),
    )


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """The context's tables on one device, in one integer type.

    Plain versions use int64 values; the kernels use int32 tensors holding
    the uint32 bit patterns (Shoup quotients and -p^-1 can exceed 2**31).
    Per-prime scalars are [L, 1] in the plain kind and [L] in the kernel kind.
    """

    p: torch.Tensor
    pinv_neg: torch.Tensor
    r2: torch.Tensor
    psi: torch.Tensor
    psi_shoup: torch.Tensor
    psi_inv: torch.Tensor
    psi_inv_shoup: torch.Tensor
    n_inv: torch.Tensor
    n_inv_shoup: torch.Tensor


def _device_tables(ctx: NTTContext, device, kind: str) -> DeviceTables:
    device = torch.device(device)
    key = (str(device), kind)
    hit = ctx._device_cache.get(key)
    if hit is not None:
        return hit
    sh = shoup_tables(ctx)
    arrays = dict(
        p=ctx.p, pinv_neg=ctx.pinv_neg, r2=ctx.r2,
        psi=sh.psi, psi_shoup=sh.psi_shoup,
        psi_inv=sh.psi_inv, psi_inv_shoup=sh.psi_inv_shoup,
        n_inv=sh.n_inv, n_inv_shoup=sh.n_inv_shoup,
    )
    def conv(a: np.ndarray) -> torch.Tensor:
        if kind == "plain":
            return torch.from_numpy(a.astype(np.int64))
        if a.shape[1] == 1:                                      # [L, 1] -> [L]
            a = a[:, 0]
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))

    out = DeviceTables(**{k: conv(np.asarray(v)).to(device) for k, v in arrays.items()})
    ctx._device_cache[key] = out
    return out


def plain_tables(ctx: NTTContext, device) -> DeviceTables:
    """int64 tables for the plain versions ([L, 1] scalars, [L, N] twiddles)."""
    return _device_tables(ctx, device, "plain")


def kernel_tables(ctx: NTTContext, device) -> DeviceTables:
    """int32 (uint32-bit) tables for the CUDA kernels ([L] scalars)."""
    return _device_tables(ctx, device, "kernel")


def _check_rows(ctx: NTTContext, a: torch.Tensor) -> None:
    if a.dtype != torch.int32:
        raise TypeError(f"residues must be torch.int32, got {a.dtype}")
    if a.dim() < 2 or a.shape[-1] != ctx.n or a.shape[-2] != ctx.num_primes:
        raise ValueError(
            f"residues must be [..., {ctx.num_primes}, {ctx.n}], got {tuple(a.shape)}"
        )


def ntt_forward_plain(ctx: NTTContext, a: torch.Tensor) -> torch.Tensor:
    """Coefficient -> evaluation domain, plain int64 stage loop (any device).

    Stage s has m = 2**s blocks of half-width t = N/2m and twiddle slice
    psi[:, m:2m], exactly as the JAX package's `ntt_forward`.
    """
    _check_rows(ctx, a)
    tabs = plain_tables(ctx, a.device)
    n, batch, num_l = ctx.n, a.shape[:-2], a.shape[-2]
    p = tabs.p[:, :, None]                                        # [L, 1, 1]
    x = a.to(torch.int64)
    for s in range(ctx.logn):
        m = 1 << s
        t = n // (2 * m)
        blocks = x.reshape(*batch, num_l, m, 2, t)
        lo, hi = blocks[..., 0, :], blocks[..., 1, :]
        tw = tabs.psi[:, m: 2 * m, None]                          # [L, m, 1]
        tw_sh = tabs.psi_shoup[:, m: 2 * m, None]
        v = shoup_mul(hi, tw, tw_sh, p)
        x = torch.stack([add_mod(lo, v, p), sub_mod(lo, v, p)], dim=-2)
        x = x.reshape(*batch, num_l, n)
    return x.to(torch.int32)


def ntt_inverse_plain(ctx: NTTContext, a: torch.Tensor) -> torch.Tensor:
    """Evaluation -> coefficient domain incl. N^-1, plain int64 (any device)."""
    _check_rows(ctx, a)
    return _inverse_stages_plain(ctx, a.to(torch.int64)).to(torch.int32)


def _inverse_stages_plain(ctx: NTTContext, x: torch.Tensor) -> torch.Tensor:
    """int64 [..., L, N] eval-domain -> int64 coefficients (stages + N^-1)."""
    tabs = plain_tables(ctx, x.device)
    n, batch, num_l = ctx.n, x.shape[:-2], x.shape[-2]
    p = tabs.p[:, :, None]
    for s in range(ctx.logn - 1, -1, -1):
        h = 1 << s
        t = n // (2 * h)
        blocks = x.reshape(*batch, num_l, h, 2, t)
        lo, hi = blocks[..., 0, :], blocks[..., 1, :]
        tw = tabs.psi_inv[:, h: 2 * h, None]
        tw_sh = tabs.psi_inv_shoup[:, h: 2 * h, None]
        out_hi = shoup_mul(sub_mod(lo, hi, p), tw, tw_sh, p)
        x = torch.stack([add_mod(lo, hi, p), out_hi], dim=-2).reshape(*batch, num_l, n)
    return shoup_mul(x, tabs.n_inv, tabs.n_inv_shoup, tabs.p)


def ntt_forward(ctx: NTTContext, a: torch.Tensor) -> torch.Tensor:
    """Coefficient -> evaluation domain. CUDA tensor: kernel K1; CPU: plain."""
    from hefl_tpu_torch.ckks import cuda_ntt

    return cuda_ntt.ntt_forward(ctx, a)


def ntt_inverse(ctx: NTTContext, a: torch.Tensor) -> torch.Tensor:
    """Evaluation -> coefficient domain. CUDA tensor: kernel K2; CPU: plain."""
    from hefl_tpu_torch.ckks import cuda_ntt

    return cuda_ntt.ntt_inverse(ctx, a)


def pointwise_mul(ctx: NTTContext, a: torch.Tensor, b_mont: torch.Tensor) -> torch.Tensor:
    """Evaluation-domain product a∘b with `b_mont` in Montgomery form."""
    tabs = plain_tables(ctx, a.device)
    return mont_mul(
        a.to(torch.int64), b_mont.to(torch.int64), tabs.p, tabs.pinv_neg
    ).to(torch.int32)


def to_mont(ctx: NTTContext, a: torch.Tensor) -> torch.Tensor:
    """Lift residues to Montgomery form (multiply by 2**32 mod p)."""
    tabs = plain_tables(ctx, a.device)
    return mont_mul(a.to(torch.int64), tabs.r2, tabs.p, tabs.pinv_neg).to(torch.int32)


def negacyclic_poly_mul(ctx: NTTContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full coefficient-domain negacyclic product a*b mod (X^N + 1) (a test
    and reference path): two forward transforms, the pointwise Montgomery
    product, one inverse transform."""
    ea = ntt_forward(ctx, a)
    eb = to_mont(ctx, ntt_forward(ctx, b))
    return ntt_inverse(ctx, pointwise_mul(ctx, ea, eb))
