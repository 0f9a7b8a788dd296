"""K5's host-side plan, and an exact emulation of its kernels' index maps.

`cuda_ntt.keyswitch_plan` picks the cluster sizes of K5's two transforms
(the digit stage on B*R*L rows, the eval-input inverse on B*L rows) and
refuses gadgets the kernel cannot compute exactly. The CUDA kernels cannot
run here, so `_emulate_keyswitch` replays, in int64 with the plain
versions' modular helpers, every index that csrc/ntt.cu computes on K5's
coefficient path: the DigitRows load policy (row r -> ciphertext b,
component c, limb c // d, digit c % d, prime r % L), ntt_kernel's passes
(the cross-block first pass and its scatter into the owning block's
padded shared memory, the in-block passes, the last pass's store) and
keyswitch_reduce_kernel's 4-word groups with the components split over 8
threads. Held bitwise against `keyswitch_fused_plain`, which
tests/test_torch_keyswitch.py holds against the JAX package, an index slip
shows here before the kernel runs on a card.
"""

import numpy as np
import pytest
import torch

from hefl_tpu_torch.ckks import cuda_ntt, ntt
from hefl_tpu_torch.ckks.keys import CkksContext
from hefl_tpu_torch.ckks.modular import add_mod, mont_mul, shoup_mul, sub_mod
from hefl_tpu_torch.ckks.primes import find_ntt_primes

torch.set_num_threads(2)

WORDS = 8        # ntt.cu kWords: words a thread holds
SPLIT = 8        # ntt.cu kReduceSplit: threads sharing one group's components
DIGIT_BITS, NUM_DIGITS = 5, 6


def _ctx(n: int, num_l: int) -> ntt.NTTContext:
    return ntt.NTTContext.build(find_ntt_primes(num_l, 27, 2 * n), n)


def _res(ctx, shape, seed) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    p = np.asarray(ctx.p).astype(np.int64)
    return torch.from_numpy((rng.integers(0, 2**40, size=shape) % p).astype(np.int32))


def _pad(x):
    """ntt.cu pad(): one spare word after every 32."""
    return x + (x >> 5)


def _group_stages(v, s, j, tw, tw_sh, p):
    """ntt.cu group_stages<R, forward> on groups v [rows, M, 2**R] whose
    global block indices are j [M]; tw/tw_sh [rows, N], p [rows, 1]."""
    big_r = v.shape[-1].bit_length() - 1
    v = v.clone()
    for r in range(big_r):
        half = 1 << (big_r - 1 - r)
        first = (1 << (s + r)) + (j << r)
        for g in range(1 << r):
            w, ws = tw[:, first + g], tw_sh[:, first + g]
            for k0 in range(half):
                lo, hi = g * 2 * half + k0, g * 2 * half + k0 + half
                t = shoup_mul(v[..., hi], w, ws, p)
                a = v[..., lo]
                v[..., lo], v[..., hi] = add_mod(a, t, p), sub_mod(a, t, p)
    return v


def _emulate_digit_stage(ctx, coeff, digit_bits, num_digits, cluster):
    """ntt_kernel<LOGN, cluster, false, DigitRows> on every row of the digit
    tensor: int32 coeff [B, L, N] -> int64 D [B, R, L, N]."""
    n, logn, num_l = ctx.n, ctx.logn, ctx.num_primes
    batch, num_r = coeff.shape[0], num_l * num_digits
    tabs = ntt.plain_tables(ctx, "cpu")
    rows = batch * num_r * num_l
    seg_words, threads = n // cluster, n // cluster // WORDS
    # DigitRows::row: r = (b*R + c)*L + j
    r = torch.arange(rows)
    j, bc = r % num_l, r // num_l
    c, b = bc % num_r, bc // num_r
    src = coeff.to(torch.int64)[b, c // num_digits]                       # [rows, N]
    shift = (digit_bits * (c % num_digits))[:, None]
    p = tabs.p[j]                                                          # [rows, 1]
    tw, tw_sh = tabs.psi[j], tabs.psi_shoup[j]
    # First pass: group g = rank*threads + tid holds words g + k*N/8, loads
    # and centres the digits, runs stages 0-2 and scatters each word into
    # the shared memory of the block that owns it.
    g = torch.arange(n // WORDS)
    x = g[:, None] + torch.arange(WORDS)[None, :] * (n // WORDS)          # [N/8, 8]
    digit = (src[:, x] >> shift[:, :, None]) & ((1 << digit_bits) - 1)
    v = _group_stages(sub_mod(digit, 1 << (digit_bits - 1), p[:, :, None]), 0,
                      torch.zeros_like(g), tw, tw_sh, p)
    sm = torch.full((rows, cluster, _pad(seg_words)), -1, dtype=torch.int64)
    owner, off = x // seg_words, _pad(x % seg_words)
    assert len(set(zip(owner.flatten().tolist(), off.flatten().tolist()))) == n
    sm[:, owner, off] = v
    # In-block passes: the short one (if any), then 3 stages at a time.
    short = (logn - 3) % 3
    passes = ([(3, short)] if short else []) + [(s, 3) for s in range(3 + short, logn - 3, 3)]
    rank = torch.arange(cluster)[:, None, None]
    for s, big_r in passes:
        size, log_u, span = 1 << big_r, logn - s - big_r, n >> s
        gl = (torch.arange(WORDS // size)[None, :, None] * threads
              + torch.arange(threads)[None, None, :])                      # [1, Q, T]
        jl = gl >> log_u
        x0 = jl * span + (gl & ((1 << log_u) - 1))
        addr = (x0[..., None] + (torch.arange(size) << log_u)).expand(cluster, -1, -1, -1)
        blk = rank[..., None].expand_as(addr)
        touched = torch.zeros(cluster, _pad(seg_words), dtype=torch.int64)
        touched.index_put_((blk.flatten(), _pad(addr).flatten()), torch.ones(addr.numel(),
                           dtype=torch.int64), accumulate=True)
        assert int(touched.sum()) == n and int(touched.max()) == 1
        jg = (rank * seg_words // span + jl).expand(cluster, -1, -1).flatten()
        vals = sm[:, blk, _pad(addr)].reshape(rows, -1, size)
        sm[:, blk, _pad(addr)] = _group_stages(vals, s, jg, tw, tw_sh, p).reshape(
            rows, *addr.shape)
    # Last pass: 8 consecutive words a thread, stored as two 16-byte vectors.
    tid = torch.arange(threads)[None, :, None]
    addr = (WORDS * tid + torch.arange(WORDS)).expand(cluster, -1, -1)    # [C, T, 8]
    blk = rank.expand_as(addr)
    jg = (rank[..., 0] * seg_words // WORDS + tid[..., 0]).flatten()
    vals = sm[:, blk, _pad(addr)].reshape(rows, -1, WORDS)
    assert bool((vals >= 0).all())
    out = torch.empty((rows, n), dtype=torch.int64)
    out[:, (rank * seg_words + addr).flatten()] = _group_stages(
        vals, logn - 3, jg, tw, tw_sh, p).reshape(rows, -1)
    return out.reshape(batch, num_r, num_l, n)


def _emulate_reduce(ctx, d_eval, b_mont, a_mont):
    """keyswitch_reduce_kernel: thread (x, q) of 4-word group g sums the
    components c = q, q + 8, ...; share 0 adds the others in q order and the
    correction row. int64 D [B, R, L, N] -> int32 (c0, c1) [B, L, N]."""
    n, num_l = ctx.n, ctx.num_primes
    batch, num_r = d_eval.shape[:2]
    tabs = ntt.plain_tables(ctx, "cpu")
    per = num_l * n // 4
    g = torch.arange(batch * per)
    b, ln = g // per, g % per
    j = (ln * 4) >> ctx.logn
    p, pinv = tabs.p[j], tabs.pinv_neg[j]                                  # [groups, 1]
    word = ln[:, None] * 4 + torch.arange(4)                               # [groups, 4]
    digits = d_eval.reshape(batch, num_r, num_l * n)
    outs = []
    for key in (b_mont, a_mont):
        k = key.to(torch.int64).reshape(num_r + 1, num_l * n)
        shares = []
        for q in range(SPLIT):
            acc = torch.zeros_like(word)
            for c in range(q, num_r, SPLIT):
                acc = add_mod(acc, mont_mul(digits[b[:, None], c, word], k[c][word], p, pinv), p)
            shares.append(acc)
        acc = shares[0]
        for share in shares[1:]:
            acc = add_mod(acc, share, p)
        acc = add_mod(acc, mont_mul(1, k[num_r][word], p, pinv), p)
        outs.append(acc.reshape(batch, num_l, n).to(torch.int32))
    return tuple(outs)


def _emulate_keyswitch(ctx, x, b_mont, a_mont, eval_input, cluster=None):
    """K5 as the card runs it, index for index, at `cluster` (default: the
    plan's) for the digit stage; the eval-input inverse is K2, which
    tests/test_torch_cuda.py holds bitwise on the card, so it is the plain
    inverse here."""
    batch = x.shape[0]
    plan = cuda_ntt.keyswitch_plan(batch, ctx.p[:, 0], NUM_DIGITS, DIGIT_BITS, ctx.n)
    coeff = ntt.ntt_inverse_plain(ctx, x) if eval_input else x
    d_eval = _emulate_digit_stage(ctx, coeff, DIGIT_BITS, NUM_DIGITS,
                                  cluster or plan.digit_cluster)
    return _emulate_reduce(ctx, d_eval, b_mont, a_mont)


@pytest.mark.parametrize("eval_input", [False, True], ids=["coeff", "eval"])
@pytest.mark.parametrize("num_l,cluster", [(1, 8), (2, 4), (3, 2), (5, 1)])
def test_emulated_k5_bitwise_vs_plain(num_l, cluster, eval_input):
    # N = 1024, B = 2: 12, 48, 108 and 300 digit rows. At B = 1 the plan
    # gives 6, 24, 54 and 150 rows C = 8, 4, 2, 1; here the emulation runs
    # at those cluster sizes too, so every plan of the digit stage is met.
    ctx = _ctx(1024, num_l)
    num_c = num_l * NUM_DIGITS + 1
    x = _res(ctx, (2, num_l, 1024), 10 + num_l)
    bk, ak = _res(ctx, (num_c, num_l, 1024), 20 + num_l), _res(ctx, (num_c, num_l, 1024), 30)
    assert cuda_ntt.keyswitch_plan(1, ctx.p[:, 0], NUM_DIGITS, DIGIT_BITS, 1024).digit_cluster \
        == cluster
    got = _emulate_keyswitch(ctx, x, bk, ak, eval_input, cluster)
    want = cuda_ntt.keyswitch_fused_plain(ctx, x, bk, ak, DIGIT_BITS, NUM_DIGITS, eval_input)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [2048, 4096])
def test_emulated_digit_stage_bitwise_at_every_cluster_size(n, cluster):
    # The pass geometry differs with log2 N (N = 2048: a short pass of 2
    # stages; 4096: none) and the scatter with C: the digit stage equals the
    # plain forward NTT of the centred digits at each.
    ctx = _ctx(n, 1)
    x = _res(ctx, (1, 1, n), n + cluster)
    d_eval = _emulate_digit_stage(ctx, x, DIGIT_BITS, NUM_DIGITS, cluster)
    p = ntt.plain_tables(ctx, "cpu").p
    lifted = sub_mod(cuda_ntt.gadget_digits(x, DIGIT_BITS, NUM_DIGITS), 1 << (DIGIT_BITS - 1), p)
    assert torch.equal(d_eval, ntt.ntt_forward_plain(ctx, lifted.to(torch.int32)).to(torch.int64))


@pytest.mark.parametrize("n,cluster", [(256, 1), (512, 1), (16384, 2), (16384, 8)])
def test_emulated_digit_stage_bitwise_at_the_smallest_and_largest_rings(n, cluster):
    ctx = _ctx(n, 1)
    x = _res(ctx, (1, 1, n), 5 * n + cluster)
    d_eval = _emulate_digit_stage(ctx, x, DIGIT_BITS, NUM_DIGITS, cluster)
    p = ntt.plain_tables(ctx, "cpu").p
    lifted = sub_mod(cuda_ntt.gadget_digits(x, DIGIT_BITS, NUM_DIGITS), 1 << (DIGIT_BITS - 1), p)
    assert torch.equal(d_eval, ntt.ntt_forward_plain(ctx, lifted.to(torch.int32)).to(torch.int64))


@pytest.mark.parametrize("batch,num_l,n,digit,inverse", [
    (1, 3, 4096, (54, 2), (3, 8)),       # a linear score's giant steps
    (4, 3, 4096, (216, 1), (12, 8)),     # score_many, 4 ciphertexts
    (1, 3, 8192, (54, 2), (3, 8)),       # the MLP's second layer
    (1, 5, 8192, (150, 1), (5, 8)),      # the MLP's first layer and relinearization
    (1, 1, 1024, (6, 8), (1, 8)),
    (1, 2, 1024, (24, 4), (2, 8)),
    (1, 3, 256, (54, 1), (3, 1)),        # one block a row below N = 1024
    (1, 3, 16384, (54, 2), (3, 8)),
    (4, 3, 16384, (216, 2), (12, 8)),    # at least two blocks a row at N = 16384
])
def test_keyswitch_plan_cluster_sizes(batch, num_l, n, digit, inverse):
    plan = cuda_ntt.keyswitch_plan(batch, find_ntt_primes(num_l, 27, 2 * n), 6, 5, n)
    assert (plan.digit_rows, plan.digit_cluster) == digit
    assert (plan.inverse_rows, plan.inverse_cluster) == inverse
    assert plan.digit_cluster == cuda_ntt.ntt_plan(plan.digit_rows, n)


def test_keyswitch_plan_takes_the_default_gadget_and_follows_the_sm_count():
    ctx = CkksContext.create(n=4096)
    plan = cuda_ntt.keyswitch_plan(1, ctx.ntt.p[:, 0], ctx.ksk_num_digits, ctx.ksk_digit_bits,
                                   4096, sms=16)
    assert (plan.digit_cluster, plan.inverse_cluster) == (1, 4)


@pytest.mark.parametrize("num_digits,digit_bits,primes", [
    (8, 5, None),                 # the last digit shifted by 35 bits
    (1, 0, None),                 # no bits
    (1, 32, None),                # a digit wider than the word
    (0, 5, None),                 # no digits
    (1, 28, None),                # digits up to 2**28 - 1 above 27-bit primes
    (6, 5, [(1 << 31) + 11]),     # a prime past the 32-bit modular arithmetic
    (6, 5, []),                   # no primes
])
def test_keyswitch_plan_refuses_what_the_kernel_cannot_compute(num_digits, digit_bits, primes):
    primes = find_ntt_primes(3, 27, 2048) if primes is None else primes
    with pytest.raises(ValueError):
        cuda_ntt.keyswitch_plan(1, primes, num_digits, digit_bits, 1024)


def test_keyswitch_plan_refuses_an_empty_batch_and_unsupported_rings():
    primes = find_ntt_primes(3, 27, 2048)
    with pytest.raises(ValueError):
        cuda_ntt.keyswitch_plan(0, primes, 6, 5, 1024)
    with pytest.raises(ValueError, match="not 128"):      # below the kernels' 256..16384
        cuda_ntt.keyswitch_plan(1, find_ntt_primes(3, 27, 256), 6, 5, 128)
