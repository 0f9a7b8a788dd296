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
  4. Print one JSON line {"kernels": [...]} and, last, the result line
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

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth, and
# the 32-bit non-tensor-core rate, which bounds the kernels' 32-bit integer work.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# 32-bit integer instructions per element operation, as the kernels issue them:
# a Shoup product is umulhi + 2 mul + sub + compare/select; a Montgomery product
# a wide multiply (2) + mul + umulhi + 2 adds + compare/select; add/sub mod p
# an add, a compare and a select.
SHOUP_OPS, MONT_OPS, ADDMOD_OPS = 6, 8, 3
BUTTERFLY_OPS = SHOUP_OPS + 2 * ADDMOD_OPS
PALLAS = "hefl_tpu/ckks/pallas_ntt.py"
SOURCE = "hefl_tpu_torch/csrc/ntt.cu"
ERR_LIMIT = 5e-6


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
    counts = main_path(device)
    for name, rec in records.items():
        rec["launches"] = counts[name]

    log(smi)
    log(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
