"""CKKS cipher operations: encrypt, decrypt, add, scale, rotate, multiply, rescale.

Counterpart of `hefl_tpu.ckks.ops` for the FedAvg round and the serving
path. Ciphertexts are `Ciphertext(c0, c1, scale)` with int32[..., L, N]
components living in evaluation (NTT) domain, so addition and the
cross-client sum are pointwise.

Dispatch depends only on where the tensors live: on CUDA, `encrypt_core` is
one launch of the fused encrypt kernel (K3) over every row, `decrypt` one
launch of the fused decrypt kernel (K4), `ct_add_plain` a forward-NTT launch
(K1), every key-switch one K5 call and a hoisted rotation sweep one K6
launch; on the CPU the plain versions in `cuda_ntt` run. There is no switch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hefl_tpu_torch.ckks import cuda_ntt, galois, modular
from hefl_tpu_torch.ckks.keys import (
    CkksContext,
    GaloisKey,
    PublicKey,
    RelinKey,
    SecretKey,
    sample_gaussian_residues,
    sample_ternary_residues,
)
from hefl_tpu_torch.ckks.ntt import ntt_forward, ntt_inverse, plain_tables, to_mont
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


def encrypt_batch(
    ctx: CkksContext, pk: PublicKey, m_res: torch.Tensor, gens=None, samples=None
) -> Ciphertext:
    """Encrypt residues int32[C, n_ct, L, N] in ONE encrypt core call (one
    K3 launch on CUDA). Batch entry c draws its (u, e0, e1) from `gens[c]`,
    or `samples` = (u, e0, e1) int32[C, n_ct, L, N] are given (a test
    feeding the JAX package's samples)."""
    c, n_ct = int(m_res.shape[0]), int(m_res.shape[1])
    if samples is None:
        draws = [encrypt_samples(ctx, g, (n_ct,), m_res.device) for g in gens]
        samples = tuple(torch.stack([d[i] for d in draws]) for i in range(3))
    rows = (c * n_ct, ctx.num_primes, ctx.n)
    u, e0, e1 = (s.reshape(rows).contiguous() for s in samples)
    ct = encrypt_core(ctx, pk, m_res.reshape(rows), u, e0, e1)
    shape = (c, n_ct, ctx.num_primes, ctx.n)
    return Ciphertext(c0=ct.c0.reshape(shape), c1=ct.c1.reshape(shape), scale=ct.scale)


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


def ct_mul_plain_poly(ctx: CkksContext, a: Ciphertext, m_res: torch.Tensor,
                      pt_scale: float) -> Ciphertext:
    """ct * plaintext polynomial (coefficient-domain residues [..., L, N]
    encoded at pt_scale, broadcast against the ciphertext): one forward-NTT
    launch (K1) on the plaintext rows, then the Montgomery product."""
    m_mont = to_mont(ctx.ntt, ntt_forward(ctx.ntt, m_res))
    tabs, (a0, a1, m64) = _i64(ctx, a.c0, a.c1, m_mont)
    mul = lambda t: modular.mont_mul(t, m64, tabs.p, tabs.pinv_neg).to(torch.int32)  # noqa: E731
    return Ciphertext(c0=mul(a0), c1=mul(a1), scale=a.scale * pt_scale)


# --- Key-switching, rotations, ct x ct, rescale ------------------------------


def _keyswitch_coeff(ctx: CkksContext, coeff, b_mont, a_mont):
    """Gadget key-switch of a COEFFICIENT-domain polynomial [..., L, N] with
    key rows [C, L, N] -> eval-domain (c0, c1) correction pair. One K5 call
    on CUDA, its plain version on the CPU."""
    return cuda_ntt.keyswitch_fused(
        ctx.ntt, coeff.contiguous(), b_mont, a_mont,
        ctx.ksk_digit_bits, ctx.ksk_num_digits,
    )


def _keyswitch_d2(ctx: CkksContext, d2, rlk: RelinKey):
    """Key-switch the degree-2 component d2 * s^2 -> s: K5 with the
    per-limb inverse NTT in the same call (`eval_input`)."""
    return cuda_ntt.keyswitch_fused(
        ctx.ntt, d2.contiguous(), rlk.b_mont, rlk.a_mont,
        ctx.ksk_digit_bits, ctx.ksk_num_digits, eval_input=True,
    )


def ct_apply_galois(ctx: CkksContext, a: Ciphertext, gk: GaloisKey) -> Ciphertext:
    """Apply X -> X^g homomorphically and switch back to s: automorphism of
    both components in the coefficient domain, key-switch of phi(c1)."""
    ntt = ctx.ntt
    tabs = plain_tables(ntt, a.c0.device)
    src, flip = galois.automorphism_tensors(ctx.n, gk.g, a.c0.device)
    pc0 = galois.apply_automorphism(ntt_inverse(ntt, a.c0), tabs.p, src, flip)
    pc1 = galois.apply_automorphism(ntt_inverse(ntt, a.c1), tabs.p, src, flip)
    k0, k1 = _keyswitch_coeff(ctx, pc1, gk.b_mont, gk.a_mont)
    c0 = modular.add_mod(ntt_forward(ntt, pc0).to(torch.int64), k0.to(torch.int64), tabs.p)
    return Ciphertext(c0=c0.to(torch.int32), c1=k1, scale=a.scale)


def ct_rotate(ctx: CkksContext, a: Ciphertext, gk: GaloisKey, steps: int) -> Ciphertext:
    """Cyclically LEFT-rotate the slot vector by `steps`; `gk` must be the
    key for `galois.galois_elt_rotation(n, steps)`."""
    want = galois.galois_elt_rotation(ctx.n, steps)
    if gk.g != want:
        raise ValueError(f"galois key has g={gk.g}, rotation by {steps} needs g={want}")
    return ct_apply_galois(ctx, a, gk)


def ct_conjugate(ctx: CkksContext, a: Ciphertext, gk: GaloisKey) -> Ciphertext:
    """Conjugate every slot; `gk` must be the key for
    `galois.galois_elt_conjugation(n)`."""
    want = galois.galois_elt_conjugation(ctx.n)
    if gk.g != want:
        raise ValueError(f"galois key has g={gk.g}, conjugation needs g={want}")
    return ct_apply_galois(ctx, a, gk)


# Hoisted rotations (Halevi-Shoup): decompose c1 once with the UNCENTERED
# gadget identity sum_c digit_c(x) * g_c = x (no correction row), which
# commutes with phi_g, so every step of a sweep shares the eval-domain
# digits; per step only the key product (K6) and an output permutation run.
# `hoisted_rotations_reference` is the per-step twin, bitwise equal.


def hoisted_digits(ctx: CkksContext, c1_coeff: torch.Tensor) -> torch.Tensor:
    """COEFFICIENT-domain c1 [..., L, N] -> uncentered eval-domain gadget
    digits int32[..., L*d, L, N]: one K1 launch over every digit row."""
    w = ctx.ksk_digit_bits
    if (1 << w) > int(np.asarray(ctx.ntt.p)[:, 0].min()):
        raise ValueError(
            f"ksk_digit_bits={w} digits overflow the smallest prime; the "
            "uncentered hoisted decomposition needs 2**w <= min(p)"
        )
    lifted = cuda_ntt.gadget_digits(c1_coeff, w, ctx.ksk_num_digits)
    return ntt_forward(ctx.ntt, lifted.to(torch.int32).contiguous())


def hoisted_rotation_tables(ctx: CkksContext, gks: dict, steps, device=None):
    """-> (perm int64[S, N], b_mont int32[S, L*d, L, N], a_mont likewise):
    per step the eval-domain permutation and the Galois key rows (correction
    row dropped) pre-gathered through the inverse permutation. Built once
    per scorer, on `device` (default: the keys' device)."""
    steps = [int(s) for s in steps]
    num_r = ctx.num_primes * ctx.ksk_num_digits
    if not steps:
        dev = torch.device(device or "cpu")
        zk = torch.zeros((0, num_r, ctx.num_primes, ctx.n), dtype=torch.int32, device=dev)
        return torch.zeros((0, ctx.n), dtype=torch.int64, device=dev), zk, zk
    missing = [s for s in steps if s not in gks]
    if missing:
        raise ValueError(f"rotation keys missing for steps {missing}")
    dev = torch.device(device or gks[steps[0]].b_mont.device)
    perms, bks, aks = [], [], []
    for s in steps:
        want = galois.galois_elt_rotation(ctx.n, s)
        if gks[s].g != want:
            raise ValueError(
                f"galois key for step {s} has g={gks[s].g}, rotation needs g={want}"
            )
        perm, inv_perm = galois.eval_permutation(ctx.ntt, want)
        perms.append(perm)
        inv = torch.from_numpy(inv_perm.astype(np.int64)).to(dev)
        bks.append(torch.index_select(gks[s].b_mont[:num_r].to(dev), -1, inv))
        aks.append(torch.index_select(gks[s].a_mont[:num_r].to(dev), -1, inv))
    perms_t = torch.from_numpy(np.stack(perms).astype(np.int64)).to(dev)
    return perms_t, torch.stack(bks), torch.stack(aks)


def hoisted_rotations_core(ctx: CkksContext, c0, d_eval, perms, b_mont, a_mont):
    """All planned rotations from the shared digits -> stacked (r0, r1)
    int32[S, ..., L, N], eval domain: one K6 launch, then the per-step
    output permutation as a gather."""
    acc0, acc1 = cuda_ntt.hoisted_products(ctx.ntt, c0.contiguous(), d_eval, b_mont, a_mont)
    idx = perms.reshape((perms.shape[0],) + (1,) * (c0.dim() - 1) + (perms.shape[-1],))
    idx = idx.expand(acc0.shape)
    return torch.gather(acc0, -1, idx), torch.gather(acc1, -1, idx)


def hoisted_rotations(ctx: CkksContext, ct: Ciphertext, steps, gks: dict) -> Ciphertext:
    """Rotate `ct` by every step in `steps` sharing ONE gadget decomposition
    -> stacked Ciphertext (leading axis S)."""
    perms, bk, ak = hoisted_rotation_tables(ctx, gks, steps, ct.c0.device)
    d_eval = hoisted_digits(ctx, ntt_inverse(ctx.ntt, ct.c1))
    r0, r1 = hoisted_rotations_core(ctx, ct.c0, d_eval, perms, bk, ak)
    return Ciphertext(c0=r0, c1=r1, scale=ct.scale)


def _uncentered_products(ctx: CkksContext, d_eval, bk, ak):
    """sum_c D_c * key_c over the gadget axis (-3), int64, exact add_mod."""
    tabs = plain_tables(ctx.ntt, d_eval.device)
    p, pinv = tabs.p, tabs.pinv_neg
    d64 = d_eval.to(torch.int64)
    out = []
    for key in (bk, ak):
        k64 = key.to(torch.int64)
        acc = modular.mont_mul(d64[..., 0, :, :], k64[0], p, pinv)
        for c in range(1, d64.shape[-3]):
            acc = modular.add_mod(acc, modular.mont_mul(d64[..., c, :, :], k64[c], p, pinv), p)
        out.append(acc)
    return out


def hoisted_rotations_reference(
    ctx: CkksContext, ct: Ciphertext, steps, gks: dict
) -> Ciphertext:
    """The UNHOISTED twin (bitwise anchor): per step, the coefficient-domain
    automorphism of every uncentered digit polynomial, fresh forward NTTs,
    and the inner product against the ORIGINAL key rows."""
    ntt = ctx.ntt
    tabs = plain_tables(ntt, ct.c0.device)
    p = tabs.p
    num_r = ctx.num_primes * ctx.ksk_num_digits
    c0_coeff = ntt_inverse(ntt, ct.c0)
    lifted = cuda_ntt.gadget_digits(ntt_inverse(ntt, ct.c1), ctx.ksk_digit_bits,
                                     ctx.ksk_num_digits).to(torch.int32)
    r0s, r1s = [], []
    for s in steps:
        g = galois.galois_elt_rotation(ctx.n, int(s))
        if gks[int(s)].g != g:
            raise ValueError(f"galois key for step {s} has g={gks[int(s)].g}")
        src, flip = galois.automorphism_tensors(ctx.n, g, ct.c0.device)
        d_eval = ntt_forward(ntt, galois.apply_automorphism(lifted, p, src, flip))
        k0, k1 = _uncentered_products(ctx, d_eval, gks[int(s)].b_mont[:num_r],
                                      gks[int(s)].a_mont[:num_r])
        pc0 = ntt_forward(ntt, galois.apply_automorphism(c0_coeff, p, src, flip))
        r0s.append(modular.add_mod(pc0.to(torch.int64), k0, p).to(torch.int32))
        r1s.append(k1.to(torch.int32))
    return Ciphertext(c0=torch.stack(r0s), c1=torch.stack(r1s), scale=ct.scale)


def ct_mul(ctx: CkksContext, a: Ciphertext, b: Ciphertext, rlk: RelinKey) -> Ciphertext:
    """Ciphertext x ciphertext multiply with relinearization (K5 in its
    eval-input mode); the result scale is the product of the input scales."""
    out_scale = a.scale * b.scale
    if out_scale * 16 >= ctx.modulus:
        raise ValueError(
            f"ct_mul result scale 2**{int(out_scale).bit_length() - 1} leaves no "
            f"headroom under q~2**{ctx.modulus.bit_length()}; rescale between "
            "multiplies or add RNS primes"
        )
    ntt = ctx.ntt
    tabs, (a0, a1, b0m, b1m) = _i64(ctx, a.c0, a.c1, to_mont(ntt, b.c0), to_mont(ntt, b.c1))
    p, pinv = tabs.p, tabs.pinv_neg
    d0 = modular.mont_mul(a0, b0m, p, pinv)
    d1 = modular.add_mod(modular.mont_mul(a0, b1m, p, pinv), modular.mont_mul(a1, b0m, p, pinv), p)
    d2 = modular.mont_mul(a1, b1m, p, pinv).to(torch.int32)
    k0, k1 = _keyswitch_d2(ctx, d2, rlk)
    return Ciphertext(
        c0=modular.add_mod(d0, k0.to(torch.int64), p).to(torch.int32),
        c1=modular.add_mod(d1, k1.to(torch.int64), p).to(torch.int32),
        scale=out_scale,
    )


def rescale(ctx: CkksContext, a: Ciphertext) -> tuple[CkksContext, Ciphertext]:
    """Drop the last RNS limb and divide the plaintext by p_last:
    c'_i = (c_i - [c_last]) * p_last^-1 mod p_i, the dropped limb through the
    coefficient domain (K2 under p_last, K1 under the head primes). Returns
    the shrunken context with the rescaled ciphertext."""
    num_l = ctx.num_primes
    if num_l < 2:
        raise ValueError("cannot rescale at the last level")
    p_np = np.asarray(ctx.ntt.p)[:, 0]
    p_last = int(p_np[-1])
    last_tables = ctx.ntt.slice_limbs(num_l - 1, num_l)
    head_tables = ctx.ntt.slice_limbs(0, num_l - 1)
    dev = a.c0.device
    head = plain_tables(head_tables, dev)
    inv_mont = torch.tensor(
        [[host_to_mont(pow(p_last % int(pi), int(pi) - 2, int(pi)), int(pi))] for pi in p_np[:-1]],
        dtype=torch.int64, device=dev,
    )

    def _drop(c: torch.Tensor) -> torch.Tensor:
        c_head, c_last = c[..., :-1, :], c[..., -1:, :].contiguous()
        last_coeff = ntt_inverse(last_tables, c_last)                 # [..., 1, N] < p_last
        rep_eval = ntt_forward(head_tables, last_coeff.expand(c_head.shape).contiguous())
        diff = modular.sub_mod(c_head.to(torch.int64), rep_eval.to(torch.int64), head.p)
        return modular.mont_mul(diff, inv_mont, head.p, head.pinv_neg).to(torch.int32)

    sub_ctx = CkksContext(
        ntt=head_tables, scale=ctx.scale, sigma=ctx.sigma, ksk_digit_bits=ctx.ksk_digit_bits
    )
    return sub_ctx, Ciphertext(c0=_drop(a.c0), c1=_drop(a.c1), scale=a.scale / p_last)
