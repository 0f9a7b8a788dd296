"""K6's host-side plan, and an exact emulation of its kernel's index maps.

`cuda_ntt.hoisted_plan` picks K6's component split Q and its
lazy-reduction chunk, and refuses primes whose 64-bit lazy sums the kernel
cannot reduce exactly. The CUDA kernel cannot run here, so
`_emulate_k6` replays, in int64, every index that csrc/ntt.cu's
hoisted_lazy_kernel computes: the grid of kHoistThreads/Q groups a block,
the block -> (ciphertext, tile, step) and lane -> (group, prime, word)
maps, the Q-way split inside
each chunk of at most K components, the tree that combines the Q partial
sums through the shared-memory slots, the 64-bit REDC, and the later
chunks' read-back of the output. Held bitwise against
`hoisted_products_plain` (which tests/test_torch_keyswitch.py holds against
the JAX package) and against the per-term Montgomery sum at the largest
27-bit prime, an index slip or an overflowing sum shows here before the
kernel runs on a card.
"""

import numpy as np
import pytest
import torch

from hefl_tpu_torch.ckks import cuda_ntt, ntt
from hefl_tpu_torch.ckks.modular import MASK32, add_mod, mont_mul, mont_reduce
from hefl_tpu_torch.ckks.primes import find_ntt_primes

torch.set_num_threads(2)

THREADS = 256           # ntt.cu kHoistThreads
SHARE_SLOTS = THREADS // 2
# (S, R, B, L, N) of every K6 launch of the serving paths (chip_smoke.py's
# HOIST_SHAPES), and the plan's (split, chunk) on a 132-SM card: the
# largest Q whose groups x Q threads fit its 135,168 resident threads.
PLANS = {
    (22, 18, 1, 3, 4096): (2, 32),    # linear score, 67,584 groups
    (22, 18, 4, 3, 4096): (1, 32),    # score_many, 4 ciphertexts: 270,336 groups
    (8, 30, 1, 5, 8192): (1, 32),     # MLP layer 1, 81,920 groups
    (4, 18, 1, 3, 8192): (4, 32),     # MLP layer 2, 24,576 groups
}


def _ctx(n: int, num_l: int) -> ntt.NTTContext:
    return ntt.NTTContext.build(find_ntt_primes(num_l, 27, 2 * n), n)


def _res(primes, shape, seed) -> torch.Tensor:
    """Canonical residues of `primes` along axis -2, shape [..., L, N]."""
    rng = np.random.default_rng(seed)
    p = np.asarray(primes, dtype=np.int64)[:, None]
    return torch.from_numpy((rng.integers(0, 2**40, size=shape) % p).astype(np.int32))


def _pinv_neg(p: int) -> int:
    return (-pow(p, -1, 1 << 32)) % (1 << 32)


def _emulate_k6(primes, c0, d_eval, b_mont, a_mont, plan):
    """hoisted_lazy_kernel with blockDim (THREADS/Q, Q), index for index:
    c0 [B, L, N], d_eval [B, R, L, N], keys [S, R, L, N] int32 -> (out0,
    out1) int32 [S, B, L, N]."""
    batch, num_l, n = c0.shape
    num_s, num_r = b_mont.shape[:2]
    split, chunk = plan.split, plan.chunk
    logn = n.bit_length() - 1
    per = (num_l << logn) // 4                       # 4-word groups of one [L, N]
    per_block = min(THREADS // split, n // 4)      # at most N/4 groups below N = 1024
    assert per % per_block == 0
    tiles = per // per_block
    blocks = num_s * batch * tiles
    # Lane x of block blk: ciphertext blk % B, group (blk // B % tiles) *
    # per_block + x, step blk // (B * tiles). Every (step, ciphertext,
    # group) exactly once.
    blk = torch.arange(blocks).repeat_interleave(per_block)
    x = torch.arange(per_block).repeat(blocks)
    b = blk % batch
    ln = blk // batch % tiles * per_block + x
    s = blk // (batch * tiles)
    assert torch.equal(torch.sort((s * batch + b) * per + ln).values,
                       torch.arange(num_s * batch * per))
    j = (ln * 4) >> logn                            # the prime
    p = torch.tensor(primes, dtype=torch.int64)[j][:, None]
    pinv = torch.tensor([_pinv_neg(int(q)) for q in primes], dtype=torch.int64)[j][:, None]
    word = ln[:, None] * 4 + torch.arange(4)         # [G, 4] within one [L, N]
    d = d_eval.to(torch.int64).reshape(batch, num_r, num_l * n)
    keys = [k.to(torch.int64).reshape(num_s, num_r, num_l * n) for k in (b_mont, a_mont)]
    c64 = c0.to(torch.int64).reshape(batch, num_l * n)
    outs = [torch.full((num_s, batch, num_l * n), -1, dtype=torch.int64) for _ in range(2)]
    idx = (s[:, None], b[:, None], word)
    for base in range(0, num_r, chunk):
        end = min(num_r, base + chunk)
        # t[q][which]: thread q's 64-bit sums over c = base + q, base + q + Q, ...
        t = torch.zeros((split, 2, s.numel(), 4), dtype=torch.int64)
        for q in range(split):
            for c in range(base + q, end, split):
                dc = d[b[:, None], c, word]
                for which in range(2):
                    t[q, which] += dc * keys[which][s[:, None], c, word]
        # The tree through shared memory: share[row][slot], one per block.
        h = split // 2
        while h:
            share = torch.full((blocks, 8, SHARE_SLOTS), -1, dtype=torch.int64)
            for q in range(h, 2 * h):
                slot = (q - h) * per_block + x
                assert int(slot.max()) < SHARE_SLOTS
                assert bool((share[blk, :, slot] == -1).all())
                share[blk, :, slot] = t[q].permute(1, 0, 2).reshape(-1, 8)
            for q in range(h):
                got = share[blk, :, q * per_block + x]
                assert bool((got >= 0).all())
                t[q] += got.reshape(-1, 2, 4).permute(1, 0, 2)
            h //= 2
        total = t[0]
        assert bool((total < p << 32).all())         # the lazy sum REDC reduces exactly
        r = mont_reduce(total >> 32, total & MASK32, p, pinv)
        if base == 0:
            outs[0][idx] = add_mod(r[0], c64[b[:, None], word], p)
            outs[1][idx] = r[1]
        else:
            outs[0][idx] = add_mod(r[0], outs[0][idx], p)
            outs[1][idx] = add_mod(r[1], outs[1][idx], p)
    assert all(bool((o >= 0).all()) for o in outs)
    return tuple(o.reshape(num_s, batch, num_l, n).to(torch.int32) for o in outs)


def _per_term(primes, c0, d_eval, b_mont, a_mont):
    """The plain per-term form at arbitrary primes: c0 + sum_c mont_mul(D_c,
    B'[s, c]) and sum_c mont_mul(D_c, A'[s, c]), add_mod in component order."""
    p = torch.tensor(primes, dtype=torch.int64)[:, None]
    pinv = torch.tensor([_pinv_neg(int(q)) for q in primes], dtype=torch.int64)[:, None]
    d = d_eval.to(torch.int64)
    outs = []
    for key in (b_mont, a_mont):
        k = key.to(torch.int64)[:, None]                      # [S, 1, R, L, N]
        acc = torch.zeros((k.shape[0],) + tuple(c0.shape), dtype=torch.int64)
        for c in range(d.shape[1]):
            acc = add_mod(acc, mont_mul(d[:, c], k[:, :, c], p, pinv), p)
        outs.append(acc)
    return (add_mod(outs[0], c0.to(torch.int64), p).to(torch.int32), outs[1].to(torch.int32))


def _case(n, num_l, num_s, batch, seed, num_r=None):
    ctx = _ctx(n, num_l)
    primes = [int(q) for q in ctx.p[:, 0]]
    num_r = 6 * num_l if num_r is None else num_r
    return ctx, primes, (_res(primes, (batch, num_l, n), seed),
                         _res(primes, (batch, num_r, num_l, n), seed + 1),
                         _res(primes, (num_s, num_r, num_l, n), seed + 2),
                         _res(primes, (num_s, num_r, num_l, n), seed + 3))


SPLITS = cuda_ntt.HOIST_SPLITS
PRIME_COUNTS = (1, 3, 5, 6)      # R = 6, 18, 30, 36: L = 6 runs two chunks of K = 32
BATCHES = (1, 2, 4, 5)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("num_l", PRIME_COUNTS)
def test_emulated_k6_bitwise_vs_plain(num_l, split):
    # N = 1024; B cycles through 1, 2, 4, 5 and S through 1, 3 across the
    # grid.
    i = SPLITS.index(split) + PRIME_COUNTS.index(num_l)
    batch, num_s = BATCHES[i % 4], (1, 3)[SPLITS.index(split) % 2]
    ctx, primes, args = _case(1024, num_l, num_s, batch, 10 * num_l + split)
    plan = cuda_ntt.hoisted_plan(num_s, batch, 6 * num_l, primes, 1024, split=split)
    assert (plan.split, plan.chunk) == (split, 32)
    got = _emulate_k6(primes, *args, plan)
    want = cuda_ntt.hoisted_products_plain(ctx, *args)
    for gw, ww in zip(got, want):
        assert torch.equal(gw, ww)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("n,num_l", [(256, 1), (256, 3), (512, 3)])
def test_emulated_k6_bitwise_vs_plain_at_small_rings(n, num_l, split):
    # Below N = 1024 a block takes at most N/4 groups (64 at N = 256), which
    # divide the L*N/4 groups of a step at any L.
    ctx, primes, args = _case(n, num_l, 2, 3, 7 * num_l + split + n)
    plan = cuda_ntt.hoisted_plan(2, 3, 6 * num_l, primes, n, split=split)
    want = cuda_ntt.hoisted_products_plain(ctx, *args)
    for gw, ww in zip(_emulate_k6(primes, *args, plan), want):
        assert torch.equal(gw, ww)


@pytest.mark.parametrize("num_s,batch,num_l,split", [
    (3, 1, 3, None),    # the linear score's ring: the plan's own Q
    (2, 4, 3, 2),       # score_many's batch of 4
    (1, 5, 6, 8),       # two component chunks
    (6, 3, 1, 4),
])
def test_emulated_k6_bitwise_vs_plain_at_n4096(num_s, batch, num_l, split):
    ctx, primes, args = _case(4096, num_l, num_s, batch, 100 + num_l)
    plan = cuda_ntt.hoisted_plan(num_s, batch, 6 * num_l, primes, 4096, split=split)
    want = cuda_ntt.hoisted_products_plain(ctx, *args)
    for gw, ww in zip(_emulate_k6(primes, *args, plan), want):
        assert torch.equal(gw, ww)


@pytest.mark.parametrize("num_r", [32, 33])
@pytest.mark.parametrize("split", [1, 8])
def test_emulated_k6_at_the_largest_27_bit_prime_with_every_word_p_minus_1(num_r, split):
    # 2**27 - 39, the largest prime below 2**27, gives K = 32: R = 32 sums
    # 32 products (p-1)**2 in one chunk right under p * 2**32 (the
    # emulation asserts it), R = 33 runs a second chunk of one component.
    p = 2**27 - 39
    assert cuda_ntt.lazy_terms([p]) == 32
    full = lambda shape: torch.full(shape, p - 1, dtype=torch.int32)  # noqa: E731
    args = (full((2, 1, 1024)), full((2, num_r, 1, 1024)), full((3, num_r, 1, 1024)),
            full((3, num_r, 1, 1024)))
    plan = cuda_ntt.hoisted_plan(3, 2, num_r, [p], 1024, split=split)
    assert plan.chunk == 32
    got = _emulate_k6([p], *args, plan)
    for gw, ww in zip(got, _per_term([p], *args)):
        assert torch.equal(gw, ww)


def test_per_term_reference_is_the_plain_version():
    ctx, primes, args = _case(1024, 3, 2, 2, 7)
    for gw, ww in zip(_per_term(primes, *args), cuda_ntt.hoisted_products_plain(ctx, *args)):
        assert torch.equal(gw, ww)


@pytest.mark.parametrize("bits", [20, 27, 30, 31])
def test_lazy_terms_is_the_largest_exact_chunk(bits):
    # K * (p-1)**2 < p * 2**32 <= (K+1) * (p-1)**2 at the largest prime of
    # each width: 4,136 at 20 bits, 32 at 27, 4 at 30, 2 just below 2**31.
    p = max(find_ntt_primes(1, bits, 2048))
    k = cuda_ntt.lazy_terms([p])
    assert k * (p - 1) ** 2 < p << 32 <= (k + 1) * (p - 1) ** 2
    assert cuda_ntt.lazy_terms([p, 65537]) == k


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_hoisted_plan_at_the_serving_shapes(shape):
    num_s, num_r, batch, num_l, n = shape
    plan = cuda_ntt.hoisted_plan(num_s, batch, num_r, find_ntt_primes(num_l, 27, 2 * n), n,
                                 sms=132)
    assert (plan.split, plan.chunk) == PLANS[shape]
    assert plan.terms == 32 and -(-num_r // plan.chunk) == 1     # one REDC a word


def test_hoisted_plan_follows_the_sm_count():
    primes = find_ntt_primes(3, 27, 8192)
    assert cuda_ntt.hoisted_plan(22, 1, 18, primes, 4096, sms=16).split == 1
    assert cuda_ntt.hoisted_plan(22, 1, 18, primes, 4096, sms=264).split == 4
    assert cuda_ntt.hoisted_plan(4, 1, 18, primes, 8192, sms=1000).split == 8
    # Q never exceeds R, nor K
    assert cuda_ntt.hoisted_plan(1, 1, 3, primes, 1024, sms=132).split == 2
    assert cuda_ntt.hoisted_plan(1, 1, 6, [(1 << 31) - 1], 1024, sms=132).split == 2


@pytest.mark.parametrize("args,kwargs", [
    ((0, 1, 18, None, 4096), {}),                      # no steps
    ((1, 0, 18, None, 4096), {}),                      # no batch
    ((1, 1, 0, None, 4096), {}),                       # no digits
    ((1, 1, 18, [], 4096), {}),                        # no primes
    ((1, 1, 18, [(1 << 31) + 11], 4096), {}),          # past the 32-bit REDC
    ((1, 1, 18, [2], 4096), {}),                       # p - 1 = 1: no Montgomery inverse
    ((1, 1, 18, None, 128), {}),                       # a ring below 256
    ((1, 1, 18, None, 4096), {"split": 3}),            # not a power of two
    ((1, 1, 18, None, 4096), {"split": 16}),           # more than 8 threads a group
    ((1, 1, 18, [(1 << 31) - 1], 4096), {"split": 4}),  # Q above K = 2
])
def test_hoisted_plan_refuses_what_the_kernel_cannot_compute(args, kwargs):
    num_s, batch, num_r, primes, n = args
    primes = find_ntt_primes(3, 27, 8192) if primes is None else primes
    with pytest.raises(ValueError):
        cuda_ntt.hoisted_plan(num_s, batch, num_r, primes, n, **kwargs)
