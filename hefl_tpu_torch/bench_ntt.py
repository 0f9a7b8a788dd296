"""Kernel benchmark of the port: every hand-written kernel K1-K7 against its
plain PyTorch version at the shapes the main paths launch it at.

Counterpart of the repository's root `bench_ntt.py` (which times the Pallas
kernels against the XLA graph path on a TPU), on one CUDA card. For each
kernel at each of NTT_SHAPES (K1, K2), ENC_SHAPES (K3), DEC_SHAPES (K4),
KS_SHAPES (K5, both modes), HOIST_SHAPES (K6) and TC_SHAPES (K7) it
  * holds the kernel BITWISE against its plain version on the same card
    tensors (exit 42 on a mismatch, the root harness's contract);
  * records `ms`, the kernels' own device time (torch.profiler kernel
    events, median of 30 calls, L2 flushed before each;
    `utils.roofline.device_ms`), `call_ms`, CUDA events around the Python
    wrapper (`utils.roofline.time_ms`), `plain_ms`, the plain version's
    call, and `bound_ms`, the least time of the same bytes and 32-bit
    instructions on the card (`utils.roofline.bound`, by the cost model
    below). The plain version is recorded, not used as a yardstick.

These shape lists are the one list of the kernels' launched shapes:
`chip_smoke.py` fails its run when a main path launches K3, K4, K6 or K7 at
a shape not in them, and `time_kernels.py` times another checkout's kernels
at them.

    python -m hefl_tpu_torch.bench_ntt [--out BENCH_TORCH_NTT.json]
        [--device cpu]

Needs a card; with `--device cpu` it runs the plain versions on one small
shape per kernel (the artifact's schema, no device time).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from hefl_tpu_torch.utils.roofline import Ops, bound, device_ms, log, time_ms

# The fewest 32-bit integer instructions per element operation that compute
# it, whatever the kernel issues (so that a bound can show waste in the
# kernel's own choice: K3's SASS (chip_smoke.py, phase 1) reduces with a compare and a
# select, two ALU instructions where one unsigned min does). A conditional
# subtract of p from a value below 2p is r - p and min(r, r - p) as
# unsigned: one add, one ALU instruction (IMNMX.U32). So a Shoup product
# is umulhi, mul, mad (a*w - q*p) and the conditional subtract; a
# Montgomery product a wide multiply (2), mul, umulhi, 2 adds and the
# min; add/sub mod p a + b, a + b - p (IADD3) and the min; a Barrett
# reduction umulhi, mad, the subtract and the min.
SHOUP_OPS, MONT_OPS, ADDMOD_OPS = Ops(3, 1, 1), Ops(4, 1, 2), Ops(0, 1, 2)
BUTTERFLY_OPS = SHOUP_OPS + 2 * ADDMOD_OPS
DIGIT_OPS = Ops(0, 2) + ADDMOD_OPS   # shift, mask, centre (sub mod p)
# K6 sums raw 32x32->64 products lazily: one wide multiply-add a term (SASS
# IMAD.WIDE.U32 with a 64-bit addend; chip_smoke.py's phase 1 prints the opcode counts of
# its instantiations from cuobjdump), and one REDC at MONT_OPS per chunk of
# at most K = cuda_ntt.lazy_terms terms.
MAD64_OPS = Ops(1, 0)
BARRETT_OPS = Ops(2, 1, 1)           # umulhi, mad; the min; the subtract
DIGIT_BITS, NUM_DIGITS = 5, 6        # the default gadget at 27-bit primes
PALLAS = "hefl_tpu/ckks/pallas_ntt.py"
SOURCE = "hefl_tpu_torch/csrc/ntt.cu"
# The shapes below are every shape at which the main paths, as
# chip_smoke.py's phases 3-12 drive them, launch each kernel (those phases
# print their `launches by (kernel, rows x N)`).
# [B, L, N] shapes of K1 and K2: the main paths launch them on 1 to 640
# rows. Phase 11's ladders launch them at: the linear ladder's K = 10 class
# rows (K1 30 rows: the weights, each stage's rotated c0, the bias; K2 60:
# c0 and c1 of a stage) and score_many's 4 queries (K1 120, K2 240); the
# MLP's 16 hidden units at L = 5 (K1 80, K2 160), its rescales (K2 16 on the
# dropped limb, K1 64 and 48 on the head) and score_many's 4 queries (K1
# 320, 256, 192; K2 640, 64). Each (rows, N) once: a launch is priced at its
# rows.
NTT_SHAPES = ((1, 3, 4096), (2, 3, 4096), (18, 3, 4096), (55, 3, 4096),
              (1, 1, 8192), (1, 3, 8192), (2, 3, 8192), (1, 4, 8192), (1, 5, 8192),
              (2, 5, 8192), (18, 3, 8192), (30, 5, 8192), (1, 3, 256),
              (10, 3, 4096), (20, 3, 4096), (40, 3, 4096), (80, 3, 4096),
              (16, 1, 8192), (16, 3, 8192), (16, 4, 8192), (16, 5, 8192), (32, 5, 8192),
              (64, 3, 8192), (64, 4, 8192), (64, 5, 8192), (128, 5, 8192))
# (eval_input, B, L, N) of K5: a linear BSGS score's giant steps at [1, 3,
# 4096], the MLP's key switches at [1, 5, 8192] and [1, 3, 8192] (after two
# rescales) and its relinearization (eval input) at [1, 5, 8192]; and
# `score_many`'s 4 packed ciphertexts at [4, 3, 4096] (phases 4-5).
# Phase 11's ladders: a linear stage on the K = 10 class rows [10, 3, 4096]
# and score_many's [40, 3, 4096]; an MLP stage on its 16 hidden units
# [16, 5, 8192] and score_many's [64, 5, 8192], each also the square's
# relinearization (eval input).
KS_SHAPES = ((False, 1, 3, 4096), (False, 4, 3, 4096), (False, 1, 3, 8192),
             (False, 1, 5, 8192), (True, 1, 5, 8192),
             (False, 10, 3, 4096), (False, 40, 3, 4096), (False, 16, 5, 8192),
             (False, 64, 5, 8192), (True, 16, 5, 8192), (True, 64, 5, 8192))
# [B, L, N] of K3 and K4. K3: 2 clients x 55 ciphertexts (phase 3,
# mnist-enc, the flagship round), the HHE round's pads for 8 clients x 19
# packed rows, 8 clients x 55 (medical-8, medical-skew), 16 clients x 67
# (cifar-resnet16's ResNet-20), and hhe-smoke's pads for 8 clients x 294
# packed rows at N = 256. K4: the rounds' 55 ciphertexts, the HHE round's
# 19 packed rows, ResNet-20's 67, hhe-smoke's 294.
# Phase 8's chaos-smoke adds K3 over 8 clients x 880 ciphertexts (SmallCNN's
# 225,034 parameters at N = 256) and K4 over 880.
# Phase 9's medical-8 streaming rounds sample a cohort of 4 of 8 clients,
# which trains and encrypts fedavg.cohort_bucket(4, 8) = 4 clients x 55.
# Phase 10's error-feedback rounds (s) pack b = 4 at k = 6 (C = 8, guard
# 16): 10 rows a client, so a cohort of 4 encrypts (or, on the hybrid-HE
# path, provisions pads for) 40 rows and decrypts 10; the b = 8 twin 4 x 19.
# Phase 12's headline benchmark (`bench.py`): the standalone
# `encrypt_params` of one MedCNN client (55) and the packed flagship
# geometry (b = 8, k = 4: 14 rows a client; `encrypt_params_packed` 14, the
# packed round 2 x 14, its decrypt 14); its cohort comparison, SmallCNN at
# N = 256, trains and encrypts all 16 clients x 880 and a cohort's bucket of
# 2 x 880, and its DCN comparison a bucket of 8 x 880 (chaos-smoke's 7040).
# Phase 17 across ranks: a rank's block of a streaming cohort's bucket
# (medical-8's cohort of 4 on 2 or 4 ranks: 2 clients x 55, the [110]
# above), a rank's 2 clients x 10 rows of the b = 4 error-feedback upload,
# and the ct split of 2 clients' 55 rows over 2 ct ranks: 2 x ceil(55 / 2).
ENC_SHAPES = ((110, 3, 4096), (152, 3, 4096), (440, 3, 4096), (1072, 3, 4096), (2352, 3, 256),
              (7040, 3, 256), (220, 3, 4096), (40, 3, 4096), (76, 3, 4096),
              (55, 3, 4096), (14, 3, 4096), (28, 3, 4096), (14080, 3, 256), (1760, 3, 256),
              (20, 3, 4096), (56, 3, 4096))
DEC_SHAPES = ((55, 3, 4096), (19, 3, 4096), (67, 3, 4096), (294, 3, 256), (880, 3, 256),
              (10, 3, 4096), (14, 3, 4096))
# [B', L, N] (B' upload rows) of K7: the HHE round's 8 clients x 19 packed
# rows, hhe-smoke's 8 x 294 at N = 256, phase 9's journal replay of one
# hhe-smoke upload (294 rows) at a time, and phase 10's error-feedback
# cohort of 4 x 10 packed rows.
TC_SHAPES = ((152, 3, 4096), (2352, 3, 256), (294, 3, 256), (40, 3, 4096))
# (S, R, B, L, N) of K6 (S rotation steps, R = L*NUM_DIGITS gadget
# components): the linear BSGS score (bsgs_plan: 22 baby steps),
# `score_many`'s 4 packed ciphertexts, the MLP's first layer at L=5 (8 baby
# steps) and its second after two rescales (4); and the unhoisted twins'
# one step at a time (S = 1) at each of the three single-query geometries.
# LAUNCH_ROWS keys K6 by (S*B*L, N), distinct for these seven.
HOIST_SHAPES = ((22, 18, 1, 3, 4096), (22, 18, 4, 3, 4096), (8, 30, 1, 5, 8192),
                (4, 18, 1, 3, 8192), (1, 18, 1, 3, 4096), (1, 30, 1, 5, 8192),
                (1, 18, 1, 3, 8192))


def rand_residues(ntt_ctx, shape, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    p = np.asarray(ntt_ctx.p).astype(np.int64)
    x = rng.integers(0, 2**40, size=shape, dtype=np.int64) % p
    return torch.from_numpy(x.astype(np.int32)).to(device)


def ntt_cases(cuda_ntt, ntt_ctx, batch: int, device, seed: int):
    """(name, replaces, shape, kernel fn, plain fn, bytes, ops) for K1 and K2
    on [batch, L, N]: row in, row out, the prime's twiddle tables."""
    n, logn, num_l = ntt_ctx.n, ntt_ctx.logn, ntt_ctx.num_primes
    x = rand_residues(ntt_ctx, (batch, num_l, n), seed, device)
    rows = batch * num_l
    fwd_ops = (n // 2) * logn * BUTTERFLY_OPS
    words = 2 * rows * n + 2 * num_l * n
    return [
        ("ntt_forward", f"{PALLAS}:413", [batch, num_l, n],
         lambda: cuda_ntt.ntt_forward(ntt_ctx, x),
         lambda: cuda_ntt.ntt_forward_plain(ntt_ctx, x),
         4 * words, rows * fwd_ops),
        ("ntt_inverse", f"{PALLAS}:418", [batch, num_l, n],
         lambda: cuda_ntt.ntt_inverse(ntt_ctx, x),
         lambda: cuda_ntt.ntt_inverse_plain(ntt_ctx, x),
         4 * words, rows * (fwd_ops + n * SHOUP_OPS)),
    ]


def encrypt_transforms_ops(shape, transforms: int) -> int:
    """Operations of K3 on `shape` [B, L, N] counting `transforms` forward
    transforms a row, plus the pointwise work: e0 + m and the epilogue's
    two Montgomery products and two adds (3 add_mod, 2 Montgomery a word)."""
    batch, num_l, n = shape
    fwd_ops = (n // 2) * (n.bit_length() - 1) * BUTTERFLY_OPS
    return batch * num_l * (transforms * fwd_ops + n * (2 * MONT_OPS + 3 * ADDMOD_OPS))


def encrypt_case(cuda_ntt, ntt_ctx, batch: int, device, seed: int):
    """(name, replaces, shape, kernel fn, plain fn, bytes, ops) for K3 on
    [batch, L, N]. Bytes: 6 words a coefficient (m, u, e0, e1 in; c0, c1
    out), the key rows and the twiddle tables. Operations: the least work
    that computes the function, three forward transforms a row (u, e0 + m,
    e1), not the TPU kernel's four."""
    n, num_l = ntt_ctx.n, ntt_ctx.num_primes
    m, u, e0, e1 = (rand_residues(ntt_ctx, (batch, num_l, n), seed + i, device)
                    for i in range(4))
    b, a = (rand_residues(ntt_ctx, (num_l, n), seed + i, device) for i in (4, 5))
    words = 6 * batch * num_l * n + 2 * num_l * n + 2 * num_l * n
    return ("encrypt_fused", f"{PALLAS}:480", [batch, num_l, n],
            lambda: cuda_ntt.encrypt_fused(ntt_ctx, m, u, e0, e1, b, a),
            lambda: cuda_ntt.encrypt_fused_plain(ntt_ctx, m, u, e0, e1, b, a),
            4 * words, encrypt_transforms_ops((batch, num_l, n), 3))


def decrypt_case(cuda_ntt, ntt_ctx, batch: int, device, seed: int):
    """(name, replaces, shape, kernel fn, plain fn, bytes, ops) for K4 on
    [batch, L, N]: c0, c1 in, one row out, the key row and the twiddle
    tables; one inverse transform a row and c0 + c1*s."""
    n, logn, num_l = ntt_ctx.n, ntt_ctx.logn, ntt_ctx.num_primes
    c0, c1 = (rand_residues(ntt_ctx, (batch, num_l, n), seed + i, device) for i in range(2))
    s = rand_residues(ntt_ctx, (num_l, n), seed + 2, device)
    inv_ops = (n // 2) * logn * BUTTERFLY_OPS + n * SHOUP_OPS
    words = 3 * batch * num_l * n + num_l * n + 2 * num_l * n
    return ("decrypt_fused", f"{PALLAS}:633", [batch, num_l, n],
            lambda: cuda_ntt.decrypt_fused(ntt_ctx, c0, c1, s),
            lambda: cuda_ntt.decrypt_fused_plain(ntt_ctx, c0, c1, s),
            4 * words, batch * num_l * (inv_ops + n * (MONT_OPS + ADDMOD_OPS)))


def serving_kernel_cases(cuda_ntt, ntt_mod, n: int, device, seed: int, shapes="slice"):
    """(name, replaces, shape, kernel fn, plain fn, bytes, ops) for K5 (both
    modes) and K6. `shapes="slice"`: the serving paths' shapes (K5 at each
    of KS_SHAPES, with R+1 = 6L+1 key rows; K6 at each of HOIST_SHAPES,
    shape [S, R, B, L, N]); otherwise the same kinds at ring size n."""
    from hefl_tpu_torch.ckks.primes import find_ntt_primes

    word = 4
    cases = []

    def ctx_of(num_l, ring):
        return ntt_mod.NTTContext.build(find_ntt_primes(num_l, 27, 2 * ring), ring)

    def keyswitch(b, num_l, ring, eval_input, k):
        ctx = ctx_of(num_l, ring)
        logn = ring.bit_length() - 1
        r = num_l * NUM_DIGITS
        c = r + 1
        x = rand_residues(ctx, (b, num_l, ring), seed + k, device)
        bk = rand_residues(ctx, (c, num_l, ring), seed + k + 1, device)
        ak = rand_residues(ctx, (c, num_l, ring), seed + k + 2, device)
        fwd_ops = (ring // 2) * logn * BUTTERFLY_OPS
        inv_ops = fwd_ops + ring * SHOUP_OPS
        words = 3 * b * num_l * ring + 2 * c * num_l * ring + (4 if eval_input else 2) * num_l * ring
        ops = (b * r * num_l * (fwd_ops + ring * DIGIT_OPS)
               + 2 * c * b * num_l * ring * (MONT_OPS + ADDMOD_OPS)
               + (b * num_l * inv_ops if eval_input else 0))
        name = "keyswitch_fused_eval" if eval_input else "keyswitch_fused"
        return (name, f"{PALLAS}:527", [b, num_l, ring],
                lambda: cuda_ntt.keyswitch_fused(ctx, x, bk, ak, DIGIT_BITS, NUM_DIGITS, eval_input),
                lambda: cuda_ntt.keyswitch_fused_plain(ctx, x, bk, ak, DIGIT_BITS, NUM_DIGITS,
                                                       eval_input),
                words * word, ops)

    def hoisted(s_steps, r, b, num_l, ring, k):
        ctx = ctx_of(num_l, ring)
        c0 = rand_residues(ctx, (b, num_l, ring), seed + k, device)
        d = rand_residues(ctx, (b, r, num_l, ring), seed + k + 1, device)
        # Both keys in one tensor, so that one reduction reads them (read()).
        keys = rand_residues(ctx, (2, s_steps, r, num_l, ring), seed + k + 2, device)
        bk, ak = keys[0], keys[1]
        poly = num_l * ring
        words = b * poly + b * r * poly + 2 * s_steps * r * poly + 2 * s_steps * b * poly
        # The least work of the function: per output word pair 2R lazy
        # multiply-adds, one REDC per K terms of each sum and the c0 add_mod
        # (the per-term count below, a Montgomery product and an add_mod a
        # term, is the earlier one-thread-a-word kernel's and is printed
        # beside it).
        # K = cuda_ntt.lazy_terms(primes), restated so that time_kernels.py
        # can time a tree without it.
        terms = min(((int(q) << 32) - 1) // (int(q) - 1) ** 2 for q in ctx.p[:, 0])
        redcs = 2 * -(-r // terms)
        ops = s_steps * b * poly * (2 * r * MAD64_OPS + redcs * MONT_OPS + ADDMOD_OPS)
        ops_mont = s_steps * b * poly * (2 * r * (MONT_OPS + ADDMOD_OPS) + ADDMOD_OPS)

        def read():
            # One PyTorch read of the same key bytes, a yardstick for
            # streaming them (not the same function, so not a library call):
            # one max reduction over both keys reads the int32 words as they
            # are (torch.sum to int64 first casts them to a new tensor).
            return torch.amax(keys)

        return ("hoisted_products", f"{PALLAS}:701", [s_steps, r, b, num_l, ring],
                lambda: cuda_ntt.hoisted_products(ctx, c0, d, bk, ak),
                lambda: cuda_ntt.hoisted_products_plain(ctx, c0, d, bk, ak),
                words * word, ops, {"ops_mont": ops_mont, "read": read,
                                    "at": lambda **kw: cuda_ntt.hoisted_products(
                                        ctx, c0, d, bk, ak, plan=cuda_ntt.hoisted_plan(
                                            s_steps, b, r, ctx.p[:, 0], ring, **kw))})

    if shapes == "slice":
        for k, (eval_input, b, num_l, ring) in enumerate(KS_SHAPES):
            cases.append(keyswitch(b, num_l, ring, eval_input, 10 * k))
        for k, (s_steps, r, b, num_l, ring) in enumerate(HOIST_SHAPES):
            cases.append(hoisted(s_steps, r, b, num_l, ring, 100 + 10 * k))
    else:
        cases.append(keyswitch(2, 3, n, False, 0))
        cases.append(keyswitch(1, 5, n, True, 10))
        cases.append(hoisted(22, 3 * NUM_DIGITS, 2, 3, n, 20))
    return cases


def transcipher_case(cuda_ntt, ntt_ctx, rows: int, device, seed: int):
    """(name, replaces, shape, kernel fn, plain fn, bytes, ops) for K7 over
    `rows` upload rows: words [rows, N] below 2**31, pads [rows, L, N].
    Bytes: the word pair once (the L rows of an upload row re-read it from
    the L2), both pads in, c0 and c1 out, the twiddle tables."""
    n, logn, num_l = ntt_ctx.n, ntt_ctx.logn, ntt_ctx.num_primes
    rng = np.random.default_rng(seed)
    w_hi, w_lo = (torch.from_numpy(rng.integers(0, 2**31, (rows, n)).astype(np.int32)).to(device)
                  for _ in range(2))
    p0, p1 = (rand_residues(ntt_ctx, (rows, num_l, n), seed + i, device) for i in (1, 2))
    fwd_ops = (n // 2) * logn * BUTTERFLY_OPS
    words = 2 * rows * n + 4 * rows * num_l * n + 2 * num_l * n     # + twiddle tables
    ops = rows * num_l * (fwd_ops + n * (2 * BARRETT_OPS + MONT_OPS + 3 * ADDMOD_OPS))
    return ("transcipher_fused", f"{PALLAS}:423", [rows, num_l, n],
            lambda: cuda_ntt.transcipher_fused(ntt_ctx, w_hi, w_lo, p0, p1),
            lambda: cuda_ntt.transcipher_fused_plain(ntt_ctx, w_hi, w_lo, p0, p1),
            words * 4, ops)


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def ntt_shape_cases(cuda_ntt, ntt_mod, device, seed: int):
    """(name, replaces, shape, kernel fn, plain fn, bytes, ops) for K1 and K2
    at each of NTT_SHAPES."""
    from hefl_tpu_torch.ckks.primes import find_ntt_primes

    cases = []
    for k, (b, num_l, n) in enumerate(NTT_SHAPES):
        ctx = ntt_mod.NTTContext.build(find_ntt_primes(num_l, 27, 2 * n), n)
        cases += ntt_cases(cuda_ntt, ctx, b, device, seed + k)
    return cases


def encdec_shape_cases(cuda_ntt, ntt_mod, device, seed: int):
    """(name, replaces, shape, kernel fn, plain fn, bytes, ops) for K3 at
    each of ENC_SHAPES, K4 at each of DEC_SHAPES and K7 at each of
    TC_SHAPES."""
    from hefl_tpu_torch.ckks.primes import find_ntt_primes

    def ctx_of(num_l, n):
        return ntt_mod.NTTContext.build(find_ntt_primes(num_l, 27, 2 * n), n)

    return ([encrypt_case(cuda_ntt, ctx_of(num_l, n), b, device, seed + 10 * k)
             for k, (b, num_l, n) in enumerate(ENC_SHAPES)]
            + [decrypt_case(cuda_ntt, ctx_of(num_l, n), b, device, seed + 100 + 10 * k)
               for k, (b, num_l, n) in enumerate(DEC_SHAPES)]
            + [transcipher_case(cuda_ntt, ctx_of(num_l, n), b, device, seed + 200 + 10 * k)
               for k, (b, num_l, n) in enumerate(TC_SHAPES)])


class KernelMismatch(AssertionError):
    """A kernel's output differs from its plain version's."""


def is_torch_reduction(name: str) -> bool:
    return "at::native::reduce_kernel" in name


def _fmt(ms: float | None) -> str:
    return "-" if ms is None else f"{ms:.6f}"


def _host_ms(fn, reps: int) -> float:
    """Median host-clock time of one call (the CPU's plain versions)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def kernel_record(case, flush, time_plain: bool = True) -> dict:
    """Hold a kernel bitwise against its plain version on the same card
    tensors (KernelMismatch otherwise), then time it: `ms` device time
    (device_ms), `call_ms` the wrapper's call (time_ms), `plain_ms` the
    plain version (time_ms). A case's optional extras (K6's) add
    `bound_mont_ms`, the bound on the per-term Montgomery count, and
    `read_ms`, the device time of PyTorch's reduction over the same key
    bytes. On CPU tensors the wrapper runs the plain version: no device
    time, the plain version's host-clock ms."""
    name, replaces, shape, kern, plain, bytes_moved, ops, *extra = case
    got = kern()
    on_card = (got[0] if isinstance(got, tuple) else got).is_cuda
    err = max_abs_err(got, plain())
    if on_card:
        torch.cuda.synchronize()
    if err != 0:
        raise KernelMismatch(f"{name} at {shape} differs from its plain version")
    if on_card:
        (ms, split), call_ms = device_ms(kern, 30, flush), time_ms(kern, 30, flush)
        plain_ms = time_ms(plain, 5, flush) if time_plain else None
    else:
        ms, split, call_ms = None, [], None
        plain_ms = _host_ms(plain, 3) if time_plain else None
    bound_ms, bound_by = bound(bytes_moved, ops)
    log(f"  {name} {shape}: bitwise equal; device {_fmt(ms)} ms, call {_fmt(call_ms)} ms, plain "
        f"{_fmt(plain_ms)} ms, bound {bound_ms:.6f} ms ({bound_by}: {bytes_moved} B, {ops} int32 "
        "ops)")
    if len(split) > 1:
        log("    by launch: " + "; ".join(f"{label} {t:.6f} ms" for label, t in split))
    rec = {
        "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
        "shape": shape, "launches": None, "max_abs_err": err, "ms": ms, "call_ms": call_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "split": [{"kernel": label, "ms": t} for label, t in split],
    }
    if extra:
        rec["bound_mont_ms"] = bound(bytes_moved, extra[0]["ops_mont"])[0]
        rec["read_ms"] = (device_ms(extra[0]["read"], 30, flush, own=is_torch_reduction)[0]
                          if on_card else None)
        log(f"    bound on a Montgomery product a term {rec['bound_mont_ms']:.6f} ms; PyTorch's "
            f"read of the keys (torch.amax) {_fmt(rec['read_ms'])} ms")
    return rec


def timed_records(cuda_ntt, ntt_mod, ckks_ntt, device, time_plain: bool = True) -> dict:
    """{kernel name: record} of every kernel at every shape of its list
    (kernel_record each): K1 and K2 first at the CKKS context's [55, 3,
    4096] (the record's own numbers, kept for continuity with earlier
    runs), then at NTT_SHAPES; K3 at ENC_SHAPES (with `bound_4t_ms`, the
    bound on the TPU kernel's four transforms a row), K4 at DEC_SHAPES, K7
    at TC_SHAPES, K5 at KS_SHAPES and K6 at HOIST_SHAPES (with its plan).
    A kernel's record is its first shape's; every shape is an entry of its
    "shapes"."""
    from hefl_tpu_torch.ckks.primes import find_ntt_primes

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    records = {}
    for case in ntt_cases(cuda_ntt, ckks_ntt, 55, device, 200):
        records[case[0]] = kernel_record(case, flush, time_plain)
    for case in ntt_shape_cases(cuda_ntt, ntt_mod, device, 500) + encdec_shape_cases(
            cuda_ntt, ntt_mod, device, 600):
        name = case[0]
        rec = kernel_record(case, flush, time_plain)
        entry = {k: rec[k] for k in ("shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")}
        if name == "encrypt_fused":
            entry["bound_4t_ms"] = bound(case[5], encrypt_transforms_ops(rec["shape"], 4))[0]
            log(f"    bound on four transforms a row: {entry['bound_4t_ms']:.6f} ms")
        records.setdefault(name, rec).setdefault("shapes", []).append(entry)
    for case in serving_kernel_cases(cuda_ntt, ntt_mod, 4096, device, 400):
        rec = kernel_record(case, flush, time_plain)
        entry = {k: rec[k] for k in ("shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                     "split", "bound_mont_ms", "read_ms") if k in rec}
        if rec["name"] == "hoisted_products":
            s_steps, r, b, num_l, n = rec["shape"]
            plan = cuda_ntt.hoisted_plan(s_steps, b, r, find_ntt_primes(num_l, 27, 2 * n), n)
            entry["plan"] = dataclasses.asdict(plan)
            log(f"    plan: {entry['plan']}")
        records.setdefault(rec["name"], rec).setdefault("shapes", []).append(entry)
    del flush
    return records


def small_records(cuda_ntt, ntt_mod, device) -> dict:
    """{kernel name: record} of every kernel at one small shape each, at
    N = 256 (the plain versions on the CPU): the artifact's schema."""
    from hefl_tpu_torch.ckks.primes import find_ntt_primes

    ctx = ntt_mod.NTTContext.build(find_ntt_primes(3, 27, 512), 256)
    cases = (ntt_cases(cuda_ntt, ctx, 2, device, 10)
             + [encrypt_case(cuda_ntt, ctx, 2, device, 20), decrypt_case(cuda_ntt, ctx, 2, device, 30),
                transcipher_case(cuda_ntt, ctx, 2, device, 40)]
             + serving_kernel_cases(cuda_ntt, ntt_mod, 256, device, 50, shapes="small"))
    records = {}
    for case in cases:
        rec = kernel_record(case, None)
        entry = {k: rec[k] for k in ("shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")}
        records.setdefault(rec["name"], rec).setdefault("shapes", []).append(entry)
    return records


# The seven TPU kernels (`hefl_tpu/ckks/pallas_ntt.py`), by the line of the
# function that reaches `pl.pallas_call`.
PALLAS_KERNELS = {f"{PALLAS}:{line}": k for k, line in (
    ("K1", 413), ("K2", 418), ("K3", 480), ("K4", 633), ("K5", 527), ("K6", 701), ("K7", 423))}


def run(device=None, time_plain: bool = True) -> dict:
    """The BENCH_TORCH_NTT artifact on `device` (CUDA unless given): every
    kernel bitwise against its plain version and timed at every shape of
    its list; on the CPU one small shape each, untimed but for the plain
    versions' host clock. Raises KernelMismatch on a mismatch."""
    from hefl_tpu_torch import device_record, resolve_device
    from hefl_tpu_torch.ckks import cuda_ntt, ntt as ntt_mod
    from hefl_tpu_torch.ckks.keys import CkksContext
    from hefl_tpu_torch.utils import roofline

    device = resolve_device(device)
    if device.type == "cuda":
        cuda_ntt.load_library()
        records = timed_records(cuda_ntt, ntt_mod, CkksContext.create().ntt, device, time_plain)
    else:
        records = small_records(cuda_ntt, ntt_mod, device)
    kernels = list(records.values())
    covered = {PALLAS_KERNELS[rec["replaces"]] for rec in kernels}
    return {
        "metric": "kernel_device_ms",
        "device": device_record(device),
        "parity": "bitwise against the plain PyTorch version at every shape",
        "timing_method": ("ms: torch.profiler kernel events, median of 30 calls, L2 flushed; "
                          "call_ms: CUDA events around the wrapper; plain_ms: CUDA events "
                          "around the plain version (host clock on the CPU)"),
        "bound_model": {"hbm_bytes_per_s": roofline.HBM_BYTES_PER_S,
                        "pipe_ops_per_s": roofline.PIPE_OPS_PER_S,
                        "issue_ops_per_s": roofline.ISSUE_OPS_PER_S},
        "shapes": {"ntt": NTT_SHAPES, "encrypt": ENC_SHAPES, "decrypt": DEC_SHAPES,
                   "keyswitch": KS_SHAPES, "hoisted": HOIST_SHAPES, "transcipher": TC_SHAPES},
        "kernels": kernels,
        "kernels_covered": sorted(covered),
        "bitwise": all(rec["max_abs_err"] == 0 for rec in kernels) and len(covered) == 7,
    }


def _main(argv: list[str] | None = None) -> int:
    """`python -m hefl_tpu_torch.bench_ntt [--out BENCH_TORCH_NTT.json]
    [--device cpu]`: exit 42 when a kernel differs from its plain version."""
    import argparse

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--out", default="BENCH_TORCH_NTT.json")
    ap.add_argument("--device", default=None, help="where the kernels run (default: cuda)")
    args = ap.parse_args(argv)
    try:
        art = run(args.device)
    except KernelMismatch as e:
        print(f"bench_ntt: PARITY FAILURE: {e}", file=sys.stderr)
        return 42
    with open(args.out, "w") as f:
        json.dump(art, f, indent=2)
    dev = art["device"]
    print(f"bench_ntt: {len(art['kernels'])} kernels ({', '.join(art['kernels_covered'])}) "
          f"bitwise={art['bitwise']} on {dev['kind']} ({dev['power_limit']}) -> {args.out}")
    return 0 if art["bitwise"] else 42


if __name__ == "__main__":
    raise SystemExit(_main())
