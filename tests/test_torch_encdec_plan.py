"""K3 and K4 on the NTT routine: an exact emulation of their index maps.

The fused encrypt (K3) and decrypt (K4) kernels are `ntt_kernel` in
csrc/ntt.cu under their own load and store policies. The CUDA kernels
cannot run here, so `_emulate_encrypt` and `_emulate_decrypt` replay, in
int64 with the plain versions' modular helpers, every index the kernels
compute: EncryptRows (three transforms a row: u, (e0 + m) mod p, e1) and
DecryptRows (d = c0 + c1*s from 8 consecutive words of each), the passes
over T transforms (the cross-block first pass and its scatter into the
owning block's padded shared memory, the in-block passes, the last pass),
and EncryptStore's epilogue (c0 = b*U + E, c1 = a*U + F on 8 consecutive
words). Held bitwise against `encrypt_fused_plain` and
`decrypt_fused_plain` at every cluster size, which
tests/test_torch_ckks.py holds against the JAX package, an index slip shows
here before the kernels run on a card.

K3 runs three transforms where the plain version (and the TPU kernel) runs
four: the transform is linear mod p and every word is canonical, so
NTT(e0) + NTT(m) = NTT((e0 + m) mod p) word for word. The plain test below
shows it on the transforms themselves.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hefl_tpu.ckks import modular as jmod
from hefl_tpu.ckks import ntt as jntt
from hefl_tpu.ckks import ops as jops

from hefl_tpu_torch.ckks import cuda_ntt, ntt
from hefl_tpu_torch.ckks.modular import add_mod, mont_mul, shoup_mul, sub_mod
from hefl_tpu_torch.ckks.primes import find_ntt_primes

torch.set_num_threads(2)

WORDS = 8        # ntt.cu kWords: words a thread holds of each transform
UNSET = -1       # a shared-memory word no thread has written


def _ctx(n: int, num_l: int) -> ntt.NTTContext:
    return ntt.NTTContext.build(find_ntt_primes(num_l, 27, 2 * n), n)


def _res(ctx, shape, seed) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    p = np.asarray(ctx.p).astype(np.int64)
    return torch.from_numpy((rng.integers(0, 2**40, size=shape) % p).astype(np.int32))


def _pad(x):
    """ntt.cu pad(): one spare word after every 32."""
    return x + (x >> 5)


def _stages(v, s, j, tw, tw_sh, p, inverse):
    """ntt.cu group_stages<R, inverse, T> on groups v [rows, T, M, 2**R]
    whose global block indices are j [M]; tw/tw_sh [rows, N], p [rows, 1].
    Forward stages run r = 0..R-1 (Cooley-Tukey), inverse R-1..0
    (Gentleman-Sande); one twiddle serves all T transforms."""
    big_r = v.shape[-1].bit_length() - 1
    v = v.clone()
    p = p[:, :, None]
    for r in (range(big_r - 1, -1, -1) if inverse else range(big_r)):
        half = 1 << (big_r - 1 - r)
        first = (1 << (s + r)) + (j << r)
        for g in range(1 << r):
            w, ws = tw[:, first + g][:, None, :], tw_sh[:, first + g][:, None, :]
            for k0 in range(half):
                lo, hi = g * 2 * half + k0, g * 2 * half + k0 + half
                a, b = v[..., lo], v[..., hi]
                if inverse:
                    v[..., lo], v[..., hi] = add_mod(a, b, p), shoup_mul(sub_mod(a, b, p), w, ws, p)
                else:
                    t = shoup_mul(b, w, ws, p)
                    v[..., lo], v[..., hi] = add_mod(a, t, p), sub_mod(a, t, p)
    return v


def _local_pass(sm, s, big_r, logn, cluster, tw, tw_sh, p, inverse):
    """local_pass<LOGN, SEG, R, inverse, T> in every block of the cluster:
    thread tid takes local groups q*THREADS + tid of each transform's
    segment. sm [rows, T, C, pad(SEG)] is updated in place."""
    n = 1 << logn
    seg_words = n // cluster
    threads = seg_words // WORDS
    size, log_u, span = 1 << big_r, logn - s - big_r, n >> s
    gl = (torch.arange(WORDS // size)[:, None] * threads + torch.arange(threads)[None, :]).flatten()
    jl = gl >> log_u
    x0 = jl * span + (gl & ((1 << log_u) - 1))
    addr = _pad(x0[:, None] + (torch.arange(size) << log_u))              # [M, 2**R]
    assert len(set(addr.flatten().tolist())) == seg_words                 # every word once
    for rank in range(cluster):
        block = sm[:, :, rank]                                            # [rows, T, pad(SEG)]
        block[..., addr] = _stages(block[..., addr], s, rank * seg_words // span + jl,
                                   tw, tw_sh, p, inverse)


def _in_block_passes(logn, inverse):
    """(first stage, stages) of the in-block passes in the kernel's order:
    forward the short pass (if any) then 3 at a time up to log2 N - 3;
    inverse 3 at a time from log2 N - 6 down, then the short pass."""
    short = (logn - 3) % 3
    if inverse:
        return [(s, 3) for s in range(logn - 6, 3 + short - 1, -3)] + ([(3, short)] if short else [])
    return ([(3, short)] if short else []) + [(s, 3) for s in range(3 + short, logn - 3, 3)]


def _row_tables(ctx, rows, inverse):
    """Per-row prime, twiddles and Shoup quotients: row r -> prime r % L."""
    tabs = ntt.plain_tables(ctx, "cpu")
    l = torch.arange(rows) % ctx.num_primes
    if inverse:
        return tabs, l, tabs.p[l], tabs.psi_inv[l], tabs.psi_inv_shoup[l]
    return tabs, l, tabs.p[l], tabs.psi[l], tabs.psi_shoup[l]


def _emulate_forward(ctx, loads, cluster):
    """ntt_kernel<LOGN, cluster, false, Src, Dst> up to the store: `loads`
    int64 [rows, T, N] are the load policy's words (word x of transform t of
    row r). Returns the last pass's words int64 [rows, T, N/8, 8] (thread
    group M = rank*THREADS + tid holds words 8M..8M+7) and the row tables."""
    n, logn = ctx.n, ctx.logn
    rows, num_t = loads.shape[:2]
    seg_words = n // cluster
    tabs, l, p, tw, tw_sh = _row_tables(ctx, rows, inverse=False)
    # First pass: group g = rank*THREADS + tid holds words g + k*N/8 of each
    # transform, runs stages 0-2 and scatters each word into the owning
    # block's shared memory (transform t's segment at t*pad(SEG)).
    g = torch.arange(n // WORDS)
    x = g[:, None] + torch.arange(WORDS)[None, :] * (n // WORDS)          # [N/8, 8]
    v = _stages(loads[:, :, x], 0, torch.zeros_like(g), tw, tw_sh, p, inverse=False)
    sm = torch.full((rows, num_t, cluster, _pad(seg_words)), UNSET, dtype=torch.int64)
    owner, off = x // seg_words, _pad(x % seg_words)
    assert len(set(zip(owner.flatten().tolist(), off.flatten().tolist()))) == n
    sm[:, :, owner, off] = v
    for s, big_r in _in_block_passes(logn, inverse=False):
        _local_pass(sm, s, big_r, logn, cluster, tw, tw_sh, p, inverse=False)
    # Last pass: thread tid of block rank takes the 8 consecutive words
    # 8*tid.. of its segment of each transform, block index rank*SEG/8 + tid.
    threads = seg_words // WORDS
    mine = _pad(WORDS * torch.arange(threads)[:, None] + torch.arange(WORDS))  # [THREADS, 8]
    v = torch.cat([sm[:, :, rank][..., mine] for rank in range(cluster)], dim=2)
    assert bool((v != UNSET).all())
    return _stages(v, logn - 3, torch.arange(n // WORDS), tw, tw_sh, p, inverse=False), tabs, l, p


def _emulate_encrypt(ctx, m, u, e0, e1, b_mont, a_mont, cluster):
    """K3: EncryptRows -> three transforms -> EncryptStore. int32 [B, L, N]
    inputs and [L, N] keys -> int32 (c0, c1) [B, L, N]."""
    n = ctx.n
    rows = m.numel() // n
    flat = [t.reshape(rows, n).to(torch.int64) for t in (u, e0, e1, m)]
    tabs0 = ntt.plain_tables(ctx, "cpu")
    p_row = tabs0.p[torch.arange(rows) % ctx.num_primes]
    # EncryptRows: transform 0 u, 1 (e0 + m) mod p, 2 e1.
    loads = torch.stack([flat[0], add_mod(flat[1], flat[3], p_row), flat[2]], dim=1)
    v, tabs, l, p = _emulate_forward(ctx, loads, cluster)
    # EncryptStore: c0 = b*U + E, c1 = a*U + F on words 8M..8M+7.
    x = WORDS * torch.arange(n // WORDS)[:, None] + torch.arange(WORDS)          # [N/8, 8]
    pinv = tabs.pinv_neg[l][:, :, None]
    pe = p[:, :, None]
    keys = [k.to(torch.int64)[l][:, x] for k in (b_mont, a_mont)]                # [rows, N/8, 8]
    outs = []
    for key, other in zip(keys, (v[:, 1], v[:, 2])):
        out = torch.full((rows, n), UNSET, dtype=torch.int64)
        out[:, x] = add_mod(mont_mul(v[:, 0], key, pe, pinv), other, pe)
        assert bool((out != UNSET).all())
        outs.append(out.reshape(m.shape).to(torch.int32))
    return tuple(outs)


def _emulate_decrypt(ctx, c0, c1, s_mont, cluster):
    """K4: DecryptRows -> the inverse passes -> N^-1 on the store. int32
    [B, L, N] ciphertext and [L, N] key -> int32 [B, L, N]."""
    n, logn = ctx.n, ctx.logn
    rows = c0.numel() // n
    seg_words = n // cluster
    threads = seg_words // WORDS
    tabs, l, p, tw, tw_sh = _row_tables(ctx, rows, inverse=True)
    # First pass: thread tid of block rank, group M = rank*THREADS + tid,
    # loads words 8M..8M+7 of c0, c1 and s (row l) and forms d in registers.
    x = WORDS * torch.arange(n // WORDS)[:, None] + torch.arange(WORDS)         # [N/8, 8]
    pe, pinv = p[:, :, None], tabs.pinv_neg[l][:, :, None]
    a, b = (t.reshape(rows, n).to(torch.int64)[:, x] for t in (c0, c1))
    d = add_mod(a, mont_mul(b, s_mont.to(torch.int64)[l][:, x], pe, pinv), pe)
    v = _stages(d[:, None], logn - 3, torch.arange(n // WORDS), tw, tw_sh, p, inverse=True)
    sm = torch.full((rows, 1, cluster, _pad(seg_words)), UNSET, dtype=torch.int64)
    for rank in range(cluster):
        mine = _pad(WORDS * torch.arange(threads)[:, None] + torch.arange(WORDS))
        sm[:, :, rank][..., mine] = v[:, :, rank * threads:(rank + 1) * threads]
    for s, big_r in _in_block_passes(logn, inverse=True):
        _local_pass(sm, s, big_r, logn, cluster, tw, tw_sh, p, inverse=True)
    # Last pass: group g reads words g + k*N/8 from the owning blocks,
    # stages 2..0, then N^-1 (Shoup) on the store.
    g = torch.arange(n // WORDS)
    x = g[:, None] + torch.arange(WORDS)[None, :] * (n // WORDS)
    v = sm[:, :, x // seg_words, _pad(x % seg_words)]
    assert bool((v != UNSET).all())
    v = _stages(v, 0, torch.zeros_like(g), tw, tw_sh, p, inverse=True)[:, 0]
    out = torch.full((rows, n), UNSET, dtype=torch.int64)
    out[:, x] = shoup_mul(v, tabs.n_inv[l][:, :, None], tabs.n_inv_shoup[l][:, :, None], pe)
    assert bool((out != UNSET).all())
    return out.reshape(c0.shape).to(torch.int32)


def _inputs(ctx, batch, seed):
    """m, u, e0, e1 [batch, L, N] and the keys b, a, s [L, N]."""
    shape = (batch, ctx.num_primes, ctx.n)
    polys = [_res(ctx, shape, seed + i) for i in range(4)]
    keys = [_res(ctx, (ctx.num_primes, ctx.n), seed + 10 + i) for i in range(3)]
    return polys, keys


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [2048, 4096])
def test_emulated_k3_bitwise_at_every_cluster_size(n, cluster):
    # N = 2048: a short pass of 2 stages between the cross-block pass and
    # the last; 4096: none. Two ciphertexts of 3 primes: 6 rows.
    ctx = _ctx(n, 3)
    (m, u, e0, e1), (b, a, _) = _inputs(ctx, 2, n + cluster)
    got = _emulate_encrypt(ctx, m, u, e0, e1, b, a, cluster)
    want = cuda_ntt.encrypt_fused_plain(ctx, m, u, e0, e1, b, a)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [2048, 4096])
def test_emulated_k4_bitwise_at_every_cluster_size(n, cluster):
    ctx = _ctx(n, 3)
    (c0, c1, _, _), (_, _, s) = _inputs(ctx, 2, 3 * n + cluster)
    got = _emulate_decrypt(ctx, c0, c1, s, cluster)
    assert torch.equal(got, cuda_ntt.decrypt_fused_plain(ctx, c0, c1, s))


# The rings beside 1024..8192, at the clusters ntt_plan gives them: one
# block a row at N = 256 (a short pass of 2 stages; one warp a block) and 512
# (no short pass), two and eight at N = 16384 (a short pass of 2 stages).
NEW_RINGS = [(256, 1), (512, 1), (16384, 2), (16384, 8)]


@pytest.mark.parametrize("n,cluster", NEW_RINGS)
def test_emulated_k3_k4_bitwise_at_the_smallest_and_largest_rings(n, cluster):
    ctx = _ctx(n, 3)
    (m, u, e0, e1), (b, a, s) = _inputs(ctx, 2, 7 * n + cluster)
    for g, w in zip(_emulate_encrypt(ctx, m, u, e0, e1, b, a, cluster),
                    cuda_ntt.encrypt_fused_plain(ctx, m, u, e0, e1, b, a)):
        assert torch.equal(g, w)
    assert torch.equal(_emulate_decrypt(ctx, m, u, s, cluster),
                       cuda_ntt.decrypt_fused_plain(ctx, m, u, s))


@pytest.mark.parametrize("cluster", [1, 8])
def test_emulated_k3_k4_bitwise_vs_jax(cluster):
    # The slice as a whole at N = 1024 (the short pass of 1 stage): the
    # emulated kernels against the JAX package's XLA encrypt core (four
    # transforms) and XLA decrypt, on the same numpy-made inputs.
    ctx = _ctx(1024, 3)
    jctx = jntt.NTTContext.build(find_ntt_primes(3, 27, 2048), 1024)
    (m, u, e0, e1), (b, a, s) = _inputs(ctx, 2, 70 + cluster)
    j = {name: jnp.asarray(t.numpy().view(np.uint32))
         for name, t in zip("m u e0 e1 b a s".split(), (m, u, e0, e1, b, a, s))}
    want = jops._encrypt_core_xla(types.SimpleNamespace(ntt=jctx), j["m"], j["u"], j["e0"],
                                  j["e1"], j["b"], j["a"])
    got = _emulate_encrypt(ctx, m, u, e0, e1, b, a, cluster)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
    p, pinv = jnp.asarray(jctx.p), jnp.asarray(jctx.pinv_neg)
    c0, c1 = got
    jd = jntt.ntt_inverse(jctx, jmod.add_mod(
        jnp.asarray(c0.numpy().view(np.uint32)),
        jmod.mont_mul(jnp.asarray(c1.numpy().view(np.uint32)), j["s"], p, pinv), p))
    np.testing.assert_array_equal(_emulate_decrypt(ctx, c0, c1, s, cluster).numpy().view(np.uint32),
                                  np.asarray(jd))


@pytest.mark.parametrize("n", [1024, 4096])
def test_three_transforms_equal_the_plain_encrypt(n):
    # NTT(u), NTT((e0 + m) mod p), NTT(e1) and the pointwise products give
    # encrypt_fused_plain's (c0, c1) bitwise: NTT(e0) + NTT(m) mod p equals
    # NTT((e0 + m) mod p) word for word.
    ctx = _ctx(n, 3)
    (m, u, e0, e1), (b, a, _) = _inputs(ctx, 3, 5 * n)
    tabs = ntt.plain_tables(ctx, "cpu")
    p, pinv = tabs.p, tabs.pinv_neg
    e0m = add_mod(e0.to(torch.int64), m.to(torch.int64), p).to(torch.int32)
    fwd = lambda t: ntt.ntt_forward_plain(ctx, t).to(torch.int64)  # noqa: E731
    assert torch.equal(fwd(e0m), add_mod(fwd(e0), fwd(m), p))
    u_ev = fwd(u)
    c0 = add_mod(mont_mul(u_ev, b.to(torch.int64), p, pinv), fwd(e0m), p).to(torch.int32)
    c1 = add_mod(mont_mul(u_ev, a.to(torch.int64), p, pinv), fwd(e1), p).to(torch.int32)
    want = cuda_ntt.encrypt_fused_plain(ctx, m, u, e0, e1, b, a)
    assert torch.equal(c0, want[0]) and torch.equal(c1, want[1])


@pytest.mark.parametrize("rows,n,cluster", [
    (330, 4096, 1),     # the round's encrypt: 2 clients x 55 ciphertexts x 3 primes
    (456, 4096, 1),     # the HHE pads: 8 clients x 19 packed rows x 3 primes
    (165, 4096, 1),     # the round's decrypt: 55 ciphertexts
    (57, 4096, 2),      # the HHE round's decrypt: 19 packed rows
    (3, 4096, 8),       # serving's one-ciphertext encrypt, L = 3
    (5, 8192, 8),       # the MLP's encrypt, L = 5
    (3216, 4096, 1),    # cifar-resnet16's encrypt: 16 clients x 67 ciphertexts
    (201, 4096, 1),     # its decrypt: 67 ciphertexts
    (7056, 256, 1),     # hhe-smoke's pads: 8 clients x 294 packed rows, N = 256
    (882, 256, 1),      # its decrypt
    (3, 16384, 8),
    (456, 16384, 2),    # never one block a row at N = 16384
])
def test_encrypt_decrypt_follow_ntt_plan(rows, n, cluster):
    # K3 and K4 launch at ntt_plan(rows, N), as K1 and K2 do.
    assert cuda_ntt.ntt_plan(rows, n) == cluster
