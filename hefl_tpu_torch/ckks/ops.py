"""CKKS cipher operations of the FedAvg round: encrypt, decrypt, add, scale.

Counterpart of the main-path part of `hefl_tpu.ckks.ops`. Ciphertexts are
`Ciphertext(c0, c1, scale)` with int32[..., L, N] components living in
evaluation (NTT) domain, so addition and the cross-client sum are pointwise.

Dispatch depends only on where the tensors live: on CUDA, `encrypt_core` is
one launch of the fused encrypt kernel (K3) over every row, `decrypt` one
launch of the fused decrypt kernel (K4), `ct_add_plain` a forward-NTT launch
(K1); on the CPU the plain versions in `cuda_ntt` run. There is no switch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hefl_tpu_torch.ckks import cuda_ntt, modular
from hefl_tpu_torch.ckks.keys import (
    CkksContext,
    PublicKey,
    SecretKey,
    sample_gaussian_residues,
    sample_ternary_residues,
)
from hefl_tpu_torch.ckks.ntt import ntt_forward, plain_tables
from hefl_tpu_torch.ckks.primes import host_to_mont


@dataclasses.dataclass
class Ciphertext:
    """RLWE pair in eval domain; decrypt(c0 + c1*s) = m*scale + noise.
    `scale` is the exact cumulative integer factor applied to the message."""

    c0: torch.Tensor
    c1: torch.Tensor
    scale: float


def encrypt_samples(
    ctx: CkksContext, gen: torch.Generator, batch: tuple = (), device=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The coefficient-domain randomness (u, e0, e1) of one encrypt call."""
    return (
        sample_ternary_residues(ctx, gen, batch, device),
        sample_gaussian_residues(ctx, gen, batch, device),
        sample_gaussian_residues(ctx, gen, batch, device),
    )


def encrypt_core(
    ctx: CkksContext, pk: PublicKey, m_res, u, e0, e1
) -> Ciphertext:
    """Deterministic encrypt of sampled randomness: (b*u + e0 + m, a*u + e1),
    eval domain. One fused-encrypt kernel launch on CUDA."""
    c0, c1 = cuda_ntt.encrypt_fused(ctx.ntt, m_res, u, e0, e1, pk.b_mont, pk.a_mont)
    return Ciphertext(c0=c0, c1=c1, scale=ctx.scale)


def encrypt(
    ctx: CkksContext, pk: PublicKey, m_res: torch.Tensor, gen: torch.Generator
) -> Ciphertext:
    """Public-key encrypt coefficient-domain residues `m_res` [..., L, N] with
    independent (u, e0, e1) per ciphertext drawn from `gen`."""
    u, e0, e1 = encrypt_samples(ctx, gen, tuple(m_res.shape[:-2]), m_res.device)
    return encrypt_core(ctx, pk, m_res, u, e0, e1)


def decrypt(ctx: CkksContext, sk: SecretKey, ct: Ciphertext) -> torch.Tensor:
    """-> coefficient-domain residues int32[..., L, N] of m*scale + noise.
    One fused-decrypt kernel launch on CUDA."""
    return cuda_ntt.decrypt_fused(ctx.ntt, ct.c0, ct.c1, sk.s_mont)


def _i64(ctx: CkksContext, *ts):
    tabs = plain_tables(ctx.ntt, ts[0].device)
    return tabs, [t.to(torch.int64) for t in ts]


def ct_add(ctx: CkksContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """Homomorphic addition."""
    if a.scale != b.scale:
        raise ValueError(f"scale mismatch: {a.scale} vs {b.scale}")
    tabs, (a0, a1, b0, b1) = _i64(ctx, a.c0, a.c1, b.c0, b.c1)
    return Ciphertext(
        c0=modular.add_mod(a0, b0, tabs.p).to(torch.int32),
        c1=modular.add_mod(a1, b1, tabs.p).to(torch.int32),
        scale=a.scale,
    )


def ct_add_plain(ctx: CkksContext, a: Ciphertext, m_res: torch.Tensor) -> Ciphertext:
    """ct + plaintext (coefficient-domain residues at the same scale)."""
    m_eval = ntt_forward(ctx.ntt, m_res)
    tabs, (a0, m64) = _i64(ctx, a.c0, m_eval)
    return Ciphertext(
        c0=modular.add_mod(a0, m64, tabs.p).to(torch.int32), c1=a.c1, scale=a.scale
    )


def ct_mul_scalar(ctx: CkksContext, a: Ciphertext, k: int) -> Ciphertext:
    """ct * integer plaintext scalar; the tracked scale absorbs k exactly."""
    primes = [int(p) for p in np.asarray(ctx.ntt.p)[:, 0]]
    tabs, (a0, a1) = _i64(ctx, a.c0, a.c1)
    k_mont = torch.tensor(
        [[host_to_mont(int(k), p)] for p in primes], dtype=torch.int64, device=a0.device
    )
    mul = lambda t: modular.mont_mul(t, k_mont, tabs.p, tabs.pinv_neg)  # noqa: E731
    return Ciphertext(
        c0=mul(a0).to(torch.int32), c1=mul(a1).to(torch.int32), scale=a.scale * k
    )
