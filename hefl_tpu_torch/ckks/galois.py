"""Galois automorphisms X -> X^g of R_q = Z_q[x]/(x^N+1).

Counterpart of `hefl_tpu.ckks.galois`. With the orbit slot ordering
(`encoding.encode_slots`), g = 5^k cyclically LEFT-rotates the slot vector by
k and g = 2N-1 conjugates every slot; with a key-switch back to s
(`ops.ct_rotate`) these give encrypted rotations.

In the coefficient domain the automorphism is a signed permutation:
phi_g(a)[m] = (-1)^flip[m] * a[src[m]]. In the evaluation domain it is a pure
permutation of the evaluation points (`eval_permutation`), which is what
lets the hoisted rotation sweep share one gadget decomposition. Tables are
static host numpy built once per (n, g) or per context; `automorphism_tensors`
caches their device copies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hefl_tpu_torch.ckks.modular import neg_mod


def galois_elt_rotation(n: int, steps: int) -> int:
    """Galois element whose automorphism left-rotates slots by `steps`."""
    return pow(5, steps % (n // 2), 2 * n)


def galois_elt_conjugation(n: int) -> int:
    """Galois element (X -> X^{-1}) that conjugates every slot."""
    return 2 * n - 1


@functools.lru_cache(maxsize=64)
def automorphism_tables(n: int, g: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (src int32[N], flip bool[N]): output coefficient m pulls from
    n0 = m * g^-1 mod 2N, with a sign flip when n0 lands in [N, 2N)."""
    if g % 2 == 0 or not (0 < g < 2 * n):
        raise ValueError(f"galois element must be odd in (0, 2N); got {g}")
    ginv = pow(g, -1, 2 * n)
    m = np.arange(n, dtype=np.int64)
    n0 = (m * ginv) % (2 * n)
    flip = n0 >= n
    src = np.where(flip, n0 - n, n0).astype(np.int32)
    return src, flip


_TENSORS: dict = {}


def automorphism_tensors(n: int, g: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """`automorphism_tables` on `device`: (src int64[N], flip bool[N])."""
    key = (n, g, str(torch.device(device)))
    hit = _TENSORS.get(key)
    if hit is None:
        src, flip = automorphism_tables(n, g)
        hit = (torch.from_numpy(src.astype(np.int64)).to(device),
               torch.from_numpy(flip).to(device))
        _TENSORS[key] = hit
    return hit


def apply_automorphism(
    residues: torch.Tensor, p: torch.Tensor, src: torch.Tensor, flip: torch.Tensor
) -> torch.Tensor:
    """Signed coefficient permutation of canonical residues int32[..., L, N]
    (`p`: int64 [L, 1]): a gather, then a negate where `flip`."""
    gathered = torch.index_select(residues, -1, src).to(torch.int64)
    return torch.where(flip, neg_mod(gathered, p), gathered).to(torch.int32)


@functools.lru_cache(maxsize=16)
def _eval_point_index(ntt) -> tuple[np.ndarray, int, dict]:
    """The evaluation points under the context's first prime, as a
    value -> index map: the forward NTT of the monomial X is the vector of
    the points themselves, whatever order the transform emits them in (the
    port's own plain NTT on the CPU). The order is the same for every prime,
    so one prime serves every permutation table."""
    from hefl_tpu_torch.ckks.ntt import ntt_forward_plain

    one_hot = torch.zeros((1, ntt.n), dtype=torch.int32)
    one_hot[0, 1] = 1
    sub = ntt.slice_limbs(0, 1)
    r = ntt_forward_plain(sub, one_hot)[0].numpy().astype(np.int64)
    p0 = int(np.asarray(sub.p)[0, 0])
    index = {int(v): j for j, v in enumerate(r)}
    if len(index) != ntt.n:
        raise AssertionError("evaluation points are not distinct: the NTT tables are broken")
    return r, p0, index


@functools.lru_cache(maxsize=128)
def eval_permutation(ntt, g: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (perm int32[N], inv_perm int32[N]) with, for canonical residues a,

        ntt_forward(apply_automorphism(a, p, *automorphism_tables(n, g)))
            == ntt_forward(a)[..., perm]

    perm[j] is the index of zeta_j^g among the evaluation points; inv_perm
    pre-permutes static key tensors so a hoisted inner product needs no
    per-step gather of the digits: sum_c perm(D_c)*B_c == perm(sum_c D_c *
    inv_perm(B_c))."""
    if g % 2 == 0 or not (0 < g < 2 * ntt.n):
        raise ValueError(f"galois element must be odd in (0, 2N); got {g}")
    r, p0, index = _eval_point_index(ntt)
    perm = np.empty(ntt.n, np.int32)
    for j in range(ntt.n):
        perm[j] = index[pow(int(r[j]), g, p0)]
    inv_perm = np.empty(ntt.n, np.int32)
    inv_perm[perm] = np.arange(ntt.n, dtype=np.int32)
    return perm, inv_perm
