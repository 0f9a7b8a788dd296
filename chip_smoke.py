#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`hefl_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the repository checkout (it imports the port from
the directory it sits in); it imports nothing of JAX or of `hefl_tpu`.
Phases, each of which fails the run (non-zero exit, no result line) on any
error:

  1. Print the card's name and power limit (nvidia-smi) and build the
     kernels from `hefl_tpu_torch/csrc/ntt.cu` with nvcc (timed).
  2. For each kernel K1-K4 (forward NTT, inverse NTT, fused encrypt, fused
     decrypt): call its wrapper on card tensors at the shapes of the
     encrypted MedCNN round (N=4096, L=3: 55 ciphertexts per client, 2
     clients), and at N=1024, and require it to be BITWISE equal to its
     plain PyTorch version run on the same card tensors. Time kernel and
     plain version with CUDA events (median of repeats, L2 flushed before
     each timed launch) and compute the kernel's lower bound on this card.
  3. Drive the main path once through the port's entry points: MedCNN at
     full width (256x256x3, 222,722 parameters, random weights from a seed),
     the `medical` synthetic data, 2 clients of 96 images, 2 local epochs,
     the default CKKS ring; keygen, `secure_fedavg_round` (train, encrypt,
     sum mod p), `decrypt_average`, `evaluate`. The kernel launch counts are
     zeroed just before and read just after; K1, K3 and K4 must have run,
     and the decrypted average must sit within 5e-6 of the same program's
     plaintext FedAvg mean (the repo's encrypted-average yardstick).
  4. Encrypted-inference serving, linear BSGS (the JAX package's
     bench_inference.py configuration): N=4096, L=3, d=512 features, K=10
     classes, 45 Galois keys. One query through `BsgsLinearScorer.score`
     (hoisted) must decrypt within 0.05 of W x + b with the same argmax, be
     bitwise equal to the "unhoisted" scorer's output and to the same
     scorer run on CPU copies of the keys and query (the plain versions),
     and launch exactly 23 K5 and 1 K6 (and at least one K1 and one K2).
     Then 16 queries packed 4 per ciphertext through `score_many`, with the
     same error and argmax checks. Warm latency (median, p95 of 20 calls)
     and queries per second for both.
  5. Encrypted-inference serving, depth-2 MLP BSGS: N=8192, L=5, d=64,
     H=16, K=10, two rescales. `BsgsMlpScorer.score` with the same argmax
     as the plaintext circuit and within MLP_ERR_LIMIT of it (see there),
     at least one K5 launch in its eval-input mode (relinearization),
     bitwise equal to the unhoisted scorer and to the same scorer on CPU
     copies; warm latency. Phases 4 and 5 also print one warm score's
     device time by kernel (torch.profiler).
  6. Print one JSON line {"kernels": [...]} (launches: the sum over the
     main-path runs of phases 3-5, each counted from zero) and, last, the
     result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks at the 700 W limit: HBM3 bandwidth (NVIDIA data sheet), and
# the 32-bit integer instruction rate that bounds the kernels' work: 132 SMs x
# 64 INT32 lanes x 1.98 GHz boost clock (NVIDIA Hopper architecture white
# paper) = 16.7e12 instructions/s. (The data sheet's 67 TFLOP/s float32 rate
# counts an FMA as two operations and does not apply to integer code.)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit integer instructions per element operation, as the kernels issue them:
# a Shoup product is umulhi + 2 mul + sub + compare/select; a Montgomery product
# a wide multiply (2) + mul + umulhi + 2 adds + compare/select; add/sub mod p
# an add, a compare and a select.
SHOUP_OPS, MONT_OPS, ADDMOD_OPS = 6, 8, 3
BUTTERFLY_OPS = SHOUP_OPS + 2 * ADDMOD_OPS
DIGIT_OPS = 2 + ADDMOD_OPS           # shift, mask, centre (sub mod p)
DIGIT_BITS, NUM_DIGITS = 5, 6        # the default gadget at 27-bit primes
PALLAS = "hefl_tpu/ckks/pallas_ntt.py"
SOURCE = "hefl_tpu_torch/csrc/ntt.cu"
ERR_LIMIT = 5e-6
SCORE_ERR_LIMIT = 0.05               # the JAX package's serving tolerance
# The depth-2 MLP at N=8192 carries more noise than the JAX tests' n=512 ring:
# the baby rotations' key-switch noise grows with N and the square doubles
# its relative size (0.174 on the H100 in chip_smoke.py, bitwise the same
# integers as the plain versions). Its check is the repo's serving gate
# (argmax agrees, run_perf_smoke.sh) plus this bound against broken decodes.
MLP_ERR_LIMIT = 0.25


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of `fn` over `reps` launches, L2 flushed before each
    (after `reps` untimed warm-up calls, so the clocks have ramped up)."""
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rand_residues(ntt_ctx, shape, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    p = np.asarray(ntt_ctx.p).astype(np.int64)
    x = rng.integers(0, 2**40, size=shape, dtype=np.int64) % p
    return torch.from_numpy(x.astype(np.int32)).to(device)


def kernel_cases(cuda_ntt, ntt_ctx, rows: int, enc_rows: int, device, seed: int):
    """(name, replaces, shape, kernel fn, plain fn, bytes, ops) for K1-K4."""
    n, logn, num_l = ntt_ctx.n, ntt_ctx.logn, ntt_ctx.num_primes
    word = 4
    poly = num_l * n
    fwd_ops = (n // 2) * logn * BUTTERFLY_OPS
    inv_ops = fwd_ops + n * SHOUP_OPS
    x = rand_residues(ntt_ctx, (rows, num_l, n), seed, device)
    m, u, e0, e1 = (rand_residues(ntt_ctx, (enc_rows, num_l, n), seed + i, device)
                    for i in range(1, 5))
    c1 = rand_residues(ntt_ctx, (rows, num_l, n), seed + 5, device)
    b, a, s = (rand_residues(ntt_ctx, (num_l, n), seed + i, device) for i in (6, 7, 8))
    tables = 2 * poly * word                         # twiddles + Shoup quotients
    return [
        ("ntt_forward", f"{PALLAS}:413", [rows, num_l, n],
         lambda: cuda_ntt.ntt_forward(ntt_ctx, x),
         lambda: cuda_ntt.ntt_forward_plain(ntt_ctx, x),
         2 * rows * poly * word + tables, rows * num_l * fwd_ops),
        ("ntt_inverse", f"{PALLAS}:418", [rows, num_l, n],
         lambda: cuda_ntt.ntt_inverse(ntt_ctx, x),
         lambda: cuda_ntt.ntt_inverse_plain(ntt_ctx, x),
         2 * rows * poly * word + tables, rows * num_l * inv_ops),
        ("encrypt_fused", f"{PALLAS}:480", [enc_rows, num_l, n],
         lambda: cuda_ntt.encrypt_fused(ntt_ctx, m, u, e0, e1, b, a),
         lambda: cuda_ntt.encrypt_fused_plain(ntt_ctx, m, u, e0, e1, b, a),
         6 * enc_rows * poly * word + 2 * poly * word + tables,
         enc_rows * num_l * (4 * fwd_ops + n * (2 * MONT_OPS + 3 * ADDMOD_OPS))),
        ("decrypt_fused", f"{PALLAS}:633", [rows, num_l, n],
         lambda: cuda_ntt.decrypt_fused(ntt_ctx, x, c1, s),
         lambda: cuda_ntt.decrypt_fused_plain(ntt_ctx, x, c1, s),
         3 * rows * poly * word + poly * word + tables,
         rows * num_l * (inv_ops + n * (MONT_OPS + ADDMOD_OPS))),
    ]


def serving_kernel_cases(cuda_ntt, ntt_mod, n: int, device, seed: int, shapes="slice"):
    """(name, replaces, shape, kernel fn, plain fn, bytes, ops) for K5 (both
    modes) and K6. `shapes="slice"`: the serving path's shapes (K5 at
    [1, 3, 4096] and [4, 3, 4096] with C=19, in eval-input mode at
    [1, 5, 8192] with C=31; K6 with S=22, R=18, B=1 at N=4096); otherwise
    the same kinds at ring size n."""
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

    def hoisted(s_steps, b, ring, k):
        num_l = 3
        ctx = ctx_of(num_l, ring)
        r = num_l * NUM_DIGITS
        c0 = rand_residues(ctx, (b, num_l, ring), seed + k, device)
        d = rand_residues(ctx, (b, r, num_l, ring), seed + k + 1, device)
        bk = rand_residues(ctx, (s_steps, r, num_l, ring), seed + k + 2, device)
        ak = rand_residues(ctx, (s_steps, r, num_l, ring), seed + k + 3, device)
        poly = num_l * ring
        words = b * poly + b * r * poly + 2 * s_steps * r * poly + 2 * s_steps * b * poly
        ops = s_steps * b * poly * (2 * r * (MONT_OPS + ADDMOD_OPS) + ADDMOD_OPS)
        return ("hoisted_products", f"{PALLAS}:701", [s_steps, r, b, num_l, ring],
                lambda: cuda_ntt.hoisted_products(ctx, c0, d, bk, ak),
                lambda: cuda_ntt.hoisted_products_plain(ctx, c0, d, bk, ak),
                words * word, ops)

    if shapes == "slice":
        cases.append(keyswitch(1, 3, 4096, False, 0))
        cases.append(keyswitch(4, 3, 4096, False, 10))
        cases.append(keyswitch(1, 5, 8192, True, 20))
        cases.append(hoisted(22, 1, 4096, 30))
    else:
        cases.append(keyswitch(2, 3, n, False, 0))
        cases.append(keyswitch(1, 5, n, True, 10))
        cases.append(hoisted(22, 2, n, 20))
    return cases


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def check_kernels(cuda_ntt, ntt_mod, ckks_ctx, device) -> dict:
    """Phase 2: bitwise checks at the slice's shapes and at N=1024; timings."""
    from hefl_tpu_torch.ckks.primes import find_ntt_primes

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    records = {}
    small = ntt_mod.NTTContext.build(find_ntt_primes(3, 27, 2048), 1024)
    for name, _, shape, kern, plain, _, _ in kernel_cases(cuda_ntt, small, 8, 8, device, 100):
        err = max_abs_err(kern(), plain())
        torch.cuda.synchronize()
        log(f"  N=1024 {name} {shape}: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"{name} at N=1024 differs from its plain version")
    # The keygen shape of K1 (one polynomial, all primes) on the main path.
    x = rand_residues(ckks_ctx.ntt, (ckks_ctx.num_primes, ckks_ctx.n), 99, device)
    err = max_abs_err(cuda_ntt.ntt_forward(ckks_ctx.ntt, x), cuda_ntt.ntt_forward_plain(ckks_ctx.ntt, x))
    log(f"  ntt_forward [3, 4096] (keygen shape): max_abs_err {err}, "
        f"{time_ms(lambda: cuda_ntt.ntt_forward(ckks_ctx.ntt, x), 20, flush):.6f} ms")
    if err != 0:
        raise AssertionError("ntt_forward at the keygen shape differs from its plain version")
    cases = kernel_cases(cuda_ntt, ckks_ctx.ntt, 55, 110, device, 200)
    for name, replaces, shape, kern, plain, bytes_moved, ops in cases:
        err = max_abs_err(kern(), plain())
        torch.cuda.synchronize()
        if err != 0:
            raise AssertionError(f"{name} at {shape} differs from its plain version")
        ms = time_ms(kern, 30, flush)
        plain_ms = time_ms(plain, 5, flush)
        bound_ms, bound_by = bound(bytes_moved, ops)
        records[name] = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "shape": shape, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        }
        log(f"  {name} {shape}: bitwise equal; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by}: {bytes_moved} B, {ops} int32 ops)")
    for name, _, shape, kern, plain, _, _ in serving_kernel_cases(cuda_ntt, ntt_mod, 1024, device,
                                                                   300, shapes="small"):
        err = max_abs_err(kern(), plain())
        torch.cuda.synchronize()
        log(f"  N=1024 {name} {shape}: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"{name} at N=1024 differs from its plain version")
    for name, replaces, shape, kern, plain, bytes_moved, ops in serving_kernel_cases(
            cuda_ntt, ntt_mod, 4096, device, 400):
        err = max_abs_err(kern(), plain())
        torch.cuda.synchronize()
        if err != 0:
            raise AssertionError(f"{name} at {shape} differs from its plain version")
        ms = time_ms(kern, 30, flush)
        plain_ms = time_ms(plain, 5, flush)
        bound_ms, bound_by = bound(bytes_moved, ops)
        rec = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "shape": shape, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        }
        if name in records:       # K5 at the packed batch: kept beside the B=1 row
            records[name]["batch"] = {k: rec[k] for k in ("shape", "ms", "plain_ms",
                                                          "bound_ms", "bound_by")}
        else:
            records[name] = rec
        log(f"  {name} {shape}: bitwise equal; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by}: {bytes_moved} B, {ops} int32 ops)")
    del flush
    return records


def main_path(device) -> dict:
    """Phase 3: one encrypted FedAvg round of full-width MedCNN."""
    from hefl_tpu_torch.ckks import cuda_ntt
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen
    from hefl_tpu_torch.ckks.packing import PackSpec
    from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
    from hefl_tpu_torch.data.synthetic import make_dataset
    from hefl_tpu_torch.fl.config import TrainConfig
    from hefl_tpu_torch.fl.fedavg import evaluate
    from hefl_tpu_torch.fl.secure import decrypt_average, secure_fedavg_round
    from hefl_tpu_torch.models import count_params, create_model

    times = {}
    t = time.perf_counter()
    (x, y), (xt, yt), _ = make_dataset("medical", seed=0, n_train=192, n_test=64)
    xs, ys = stack_federated(x, y, iid_contiguous(len(y), 2))
    xs_d, ys_d = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    xt_d = torch.from_numpy(xt).to(device)
    gen = torch.Generator().manual_seed(0)
    model = create_model("medcnn", gen=gen, device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    cfg = TrainConfig(epochs=2, num_classes=2)
    torch.cuda.synchronize()
    times["setup_s"] = time.perf_counter() - t
    if count_params(params) != 222_722:
        raise AssertionError(f"MedCNN has {count_params(params)} params, expected 222,722")

    cuda_ntt.reset_launch_counts()

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    ctx = phase("context_s", CkksContext.create)
    sk, pk = phase("keygen_s", lambda: keygen(ctx, gen, device=device))
    ct_sum, mets, overflow, ref = phase("train_encrypt_aggregate_s", lambda: secure_fedavg_round(
        model, cfg, ctx, pk, params, xs_d, ys_d, gen, with_plain_reference=True))
    spec = PackSpec.for_params(params, ctx.n)
    avg = phase("decrypt_s", lambda: decrypt_average(ctx, sk, ct_sum, 2, spec))
    results = phase("evaluate_s", lambda: evaluate(model, avg, xt_d, yt))
    counts = cuda_ntt.launch_counts()

    log(f"  main path launches: {counts}")
    for name in ("ntt_forward", "encrypt_fused", "decrypt_fused"):
        if counts[name] < 1:
            raise AssertionError(f"main path did not launch {name}")
    if spec.n_ct != 55 or tuple(ct_sum.c0.shape) != (55, 3, 4096):
        raise AssertionError(f"unexpected ciphertext geometry {tuple(ct_sum.c0.shape)}")
    if int(overflow.sum()) != 0:
        raise AssertionError(f"encode saturated {int(overflow.sum())} weights")
    if tuple(mets.shape) != (2, 2, 4) or not torch.isfinite(mets).all():
        raise AssertionError(f"bad training metrics {mets}")
    err = max((avg[k] - ref[k]).abs().max().item() for k in ref)
    finite = all(torch.isfinite(v).all().item() for v in avg.values())
    log(f"  decrypted average vs plaintext mean: max abs err {err:.3e} (limit {ERR_LIMIT})")
    if not finite or not err <= ERR_LIMIT:
        raise AssertionError(f"decrypted average off the plaintext mean by {err}")
    if not 0.0 <= results["accuracy"] <= 1.0:
        raise AssertionError(f"bad evaluation {results}")
    log(f"  val_loss per client/epoch {mets[:, :, 0].tolist()}; test accuracy "
        f"{results['accuracy']:.4f} f1 {results['f1']:.4f}")
    log("  phase times (s): " + json.dumps(times))
    return counts


def warm_latency(fn, calls: int = 20) -> tuple[float, float]:
    """(median, p95) seconds of `fn` over `calls` warm calls, each ending in
    torch.cuda.synchronize() (host clock)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), float(np.percentile(times, 95))


def device_time_breakdown(label: str, fn) -> None:
    """Device time of one warm call of `fn` by kernel (torch.profiler with
    CUDA activity, kernel events only), beside its host-clock wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if "(anonymous namespace)::" in r[0])
    log(f"  {label}: wall {wall_ms:.3f} ms (profiled), device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f} % of wall) in {sum(r[2] for r in rows)} kernels; "
        f"the port's CUDA kernels {ours:.3f} ms, PyTorch's own {busy - ours:.3f} ms")
    for key, ms, count in rows[:8]:
        log(f"    {ms:9.4f} ms  x{count:<5d} {key[:90]}")


def same_ciphertext(a, b) -> bool:
    return (torch.equal(a.c0.cpu(), b.c0.cpu()) and torch.equal(a.c1.cpu(), b.c1.cpu())
            and a.scale == b.scale)


def check_scores(label: str, got, want, limit: float = SCORE_ERR_LIMIT) -> None:
    err = float(np.max(np.abs(got - want)))
    agree = bool(np.all(np.argmax(got, -1) == np.argmax(want, -1)))
    log(f"  {label}: max |scores - reference| {err:.3e} (limit {limit}), "
        f"argmax agrees: {agree}")
    if not (np.all(np.isfinite(got)) and err <= limit and agree):
        raise AssertionError(f"{label}: scores off the plaintext reference ({err}, argmax {agree})")


def serving_linear(device, n: int = 4096) -> dict:
    """Phase 4: linear BSGS serving at N=4096, L=3, d=N/8 = 512, K=10."""
    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.ckks import cuda_ntt, encoding
    from hefl_tpu_torch.ckks.keys import CkksContext, GaloisKey, keygen

    times = {}
    t = time.perf_counter()
    ctx = CkksContext.create(n=n)
    gen = torch.Generator().manual_seed(42)
    sk, pk = keygen(ctx, gen, device=device)
    slots = encoding.num_slots(ctx.ntt)
    d, k = slots // 4, 10
    rng = np.random.default_rng(42)
    W, b = rng.normal(0, 0.3, (k, d)), rng.normal(0, 0.2, k)
    plan = hei.bsgs_plan(slots, d, k)
    if n == 4096 and (len(plan.baby_steps), len(plan.giant_steps)) != (22, 23):
        raise AssertionError(f"unexpected plan {plan.baby_steps} / {plan.giant_steps}")
    gks = hei.gen_rotation_keys_for_steps(ctx, sk, 2, plan.rotation_steps_needed)
    torch.cuda.synchronize()
    times["keygen_45_galois_s"] = time.perf_counter() - t
    t = time.perf_counter()
    scorer = hei.BsgsLinearScorer(ctx, W, b, gks)
    torch.cuda.synchronize()
    times["scorer_build_s"] = time.perf_counter() - t
    x = rng.normal(0, 0.5, d)
    ct = hei.encrypt_features(ctx, pk, x, gen)
    torch.cuda.synchronize()

    cuda_ntt.reset_launch_counts()
    out = scorer.score(ct)
    torch.cuda.synchronize()
    counts = cuda_ntt.launch_counts()
    log(f"  one score's launches: {counts}")
    if counts["keyswitch_fused"] != len(plan.giant_steps) or counts["hoisted_products"] != 1:
        raise AssertionError(f"a linear score must launch exactly {len(plan.giant_steps)} K5 "
                             "(one per giant step) and 1 K6")
    if counts["ntt_forward"] < 1 or counts["ntt_inverse"] < 1:
        raise AssertionError("a linear score must launch K1 and K2")
    check_scores("linear score (1 query)", hei.decrypt_class_scores(ctx, sk, out, k), x @ W.T + b)

    unhoisted = hei.BsgsLinearScorer(ctx, W, b, gks, rotation_mode="unhoisted")
    if not same_ciphertext(out, unhoisted.score(ct)):
        raise AssertionError("hoisted and unhoisted linear scores differ")
    log("  hoisted == unhoisted: bitwise")
    t = time.perf_counter()
    cpu_gks = {s: GaloisKey(g=v.g, b_mont=v.b_mont.cpu(), a_mont=v.a_mont.cpu())
               for s, v in gks.items()}
    cpu_out = hei.BsgsLinearScorer(ctx, W, b, cpu_gks, device="cpu").score(
        hei.Ciphertext(ct.c0.cpu(), ct.c1.cpu(), ct.scale))
    times["cpu_plain_score_s"] = time.perf_counter() - t
    if not same_ciphertext(out, cpu_out):
        raise AssertionError("the card's linear score differs from the CPU plain versions'")
    log(f"  card == CPU plain versions: bitwise ({times['cpu_plain_score_s']:.3f} s on the CPU)")

    med, p95 = warm_latency(lambda: scorer.score(ct))
    lat = {"single_median_s": med, "single_p95_s": p95, "single_qps": 1.0 / med}
    device_time_breakdown("one linear score", lambda: scorer.score(ct))

    q, n_ct = 4, 4
    packed = hei.BsgsLinearScorer(ctx, W, b, gks, queries_per_ct=q)
    xs = rng.normal(0, 0.5, (n_ct, q, d))
    cts = hei.encrypt_query_block(ctx, pk, xs, gen, q)
    outs = packed.score_many(cts)
    check_scores("linear score_many (16 queries, 4 per ciphertext)",
                 hei.decrypt_class_scores(ctx, sk, outs, k, queries_per_ct=q), xs @ W.T + b)
    med, p95 = warm_latency(lambda: packed.score_many(cts))
    lat.update(packed_median_s=med, packed_p95_s=p95, packed_qps=q * n_ct / med)
    log("  latency: " + json.dumps(lat))
    log("  phase times (s): " + json.dumps(times))
    return counts


def serving_mlp(device, n: int = 8192) -> dict:
    """Phase 5: depth-2 MLP BSGS serving at N=8192, L=5, d=64, H=16, K=10."""
    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.ckks import cuda_ntt, encoding
    from hefl_tpu_torch.ckks.keys import CkksContext, GaloisKey, RelinKey, gen_relin_key, keygen

    t = time.perf_counter()
    ctx = CkksContext.create(n=n, num_primes=5)
    gen = torch.Generator().manual_seed(10)
    sk, pk = keygen(ctx, gen, device=device)
    rlk = gen_relin_key(ctx, sk, gen)
    d, hidden, k = 64, 16, 10
    rng = np.random.default_rng(43)
    w1, b1 = rng.normal(0, 0.3, (hidden, d)), rng.normal(0, 0.2, hidden)
    w2, b2 = rng.normal(0, 0.3, (k, hidden)), rng.normal(0, 0.2, k)
    plan1, plan2 = hei.bsgs_mlp_plans(encoding.num_slots(ctx.ntt), d, hidden, k)
    sub = hei.mlp_sub_context(ctx, 2)
    sub_sk = hei.slice_secret_key(sk, sub.num_primes)
    gks1 = hei.gen_rotation_keys_for_steps(ctx, sk, 13, plan1.rotation_steps_needed)
    gks2 = hei.gen_rotation_keys_for_steps(sub, sub_sk, 14, plan2.rotation_steps_needed)
    scorer = hei.BsgsMlpScorer(ctx, w1, b1, w2, b2, gks1, rlk, gks2)
    x = rng.normal(0, 0.4, d)
    ct = hei.encrypt_features(ctx, pk, x, gen)
    torch.cuda.synchronize()
    log(f"  keys + scorer build: {time.perf_counter() - t:.3f} s; plan 1 "
        f"{len(plan1.baby_steps)} baby / {len(plan1.giant_steps)} giant steps, plan 2 "
        f"{len(plan2.baby_steps)} / {len(plan2.giant_steps)}")

    cuda_ntt.reset_launch_counts()
    out = scorer.score(ct)
    torch.cuda.synchronize()
    counts = cuda_ntt.launch_counts()
    log(f"  one score's launches: {counts}")
    if counts["keyswitch_fused_eval"] < 1:
        raise AssertionError("the MLP's relinearization did not launch K5 in eval-input mode")
    want = ((x @ w1.T + b1) ** 2) @ w2.T + b2
    check_scores("MLP score", hei.decrypt_class_scores(sub, sub_sk, out, k), want, MLP_ERR_LIMIT)
    twin = hei.BsgsMlpScorer(ctx, w1, b1, w2, b2, gks1, rlk, gks2, rotation_mode="unhoisted")
    if not same_ciphertext(out, twin.score(ct)):
        raise AssertionError("hoisted and unhoisted MLP scores differ")
    log("  hoisted == unhoisted: bitwise")
    t = time.perf_counter()
    cpu = lambda g: {s: GaloisKey(g=v.g, b_mont=v.b_mont.cpu(), a_mont=v.a_mont.cpu())  # noqa: E731
                     for s, v in g.items()}
    cpu_rlk = RelinKey(b_mont=rlk.b_mont.cpu(), a_mont=rlk.a_mont.cpu())
    cpu_out = hei.BsgsMlpScorer(ctx, w1, b1, w2, b2, cpu(gks1), cpu_rlk, cpu(gks2),
                                device="cpu").score(hei.Ciphertext(ct.c0.cpu(), ct.c1.cpu(), ct.scale))
    if not same_ciphertext(out, cpu_out):
        raise AssertionError("the card's MLP score differs from the CPU plain versions'")
    log(f"  card == CPU plain versions: bitwise ({time.perf_counter() - t:.3f} s on the CPU)")
    med, p95 = warm_latency(lambda: scorer.score(ct))
    log("  latency: " + json.dumps({"median_s": med, "p95_s": p95, "qps": 1.0 / med}))
    device_time_breakdown("one MLP score", lambda: scorer.score(ct))
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from hefl_tpu_torch.ckks import cuda_ntt, ntt as ntt_mod
    from hefl_tpu_torch.ckks.keys import CkksContext

    t = time.perf_counter()
    cuda_ntt.load_library()
    log(f"phase 1: built {cuda_ntt.library_path().name} in {time.perf_counter() - t:.3f} s")

    log("phase 2: kernels vs plain versions")
    records = check_kernels(cuda_ntt, ntt_mod, CkksContext.create(), device)

    log("phase 3: encrypted FedAvg round, MedCNN 256x256x3, N=4096 L=3, 2 clients")
    counts = [main_path(device)]
    log("phase 4: linear BSGS serving, N=4096 L=3, d=512, K=10")
    counts.append(serving_linear(device))
    log("phase 5: MLP BSGS serving, N=8192 L=5, d=64, H=16, K=10")
    counts.append(serving_mlp(device))
    for name, rec in records.items():
        rec["launches"] = sum(c[name] for c in counts)
        if rec["launches"] < 1:
            raise AssertionError(f"no main path launched {name}")

    log(smi)
    log(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
