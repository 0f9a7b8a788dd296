"""Benchmark: the reference's headline experiment, end to end on one card.

Counterpart of the repository's root `bench.py`, on the port. Reference
configuration (BASELINE.md): 2 clients, 10 local epochs, 1600 train / 400
test `medical` images at 256x256x3, the 222,722-parameter MedCNN, CKKS at
N = 4096, L = 3 (55 ciphertexts a client), encrypted FedAvg — 6583.6 s of
total pipeline wall clock on the reference's CPU (`flagship.py`).

What it measures, every timed span ending in `torch.cuda.synchronize()`:

  * round 0 — the reference-equivalent pipeline, COLD: one encrypted round
    (2-client 10-epoch training + CKKS encrypt + the ciphertext sum), the
    owner's decrypt and the test-set evaluation, with every one-time cost
    this process pays (the kernel build, cuDNN's first calls). `value` and
    `vs_baseline`.
  * rounds 1..R-1 — the same WARM. `warm_round_s` is their mean,
    `steady_round_s` their minimum, `rounds_per_sec_per_chip` its inverse.
    `train_mfu`: the round's train FLOPs (`utils.roofline.model_flops`,
    FlopCounterMode's conv and matmul count, x 3 for the backward) over the
    steady train-phase time and the card's dense bf16 peak.
  * the cell-6 comparison (`Encrypted FL Main-Rel.ipynb:428`): a plaintext
    FedAvg round timed warm (`plaintext_round_s`), the same round under
    each client-training backend (`client_fusion_compare`), and the
    encrypted round re-run with `with_plain_reference`, so the same trained
    weights go through both aggregators: `enc_plain_max_abs_diff` is pure
    CKKS encode / encrypt / sum / decrypt error (the float decode and the
    exact CRT decode).
  * the standalone HE phases (warm, min over repetitions,
    `utils.roofline.steady_seconds`): one client's `encrypt_params`, the
    sum of two, the decrypt core; `he_roofline`'s integer-op and byte rows
    (the JAX package's cost model) against the card's 32-bit issue rate.
  * packing (b = 8, k = 4): `encrypt_params_packed`, its decrypt core, the
    bytes on the wire and a packed `with_plain_reference` round within its
    error budget.
  * the cohort comparison (`fl.stream.cohort_compare_smoke_record`) and
    the DCN comparison (`fl.hierarchy.dcn_compare_smoke_record`).

    python -m hefl_tpu_torch.bench [--rounds 5] [--seed 0] [--smoke]
        [--device cpu] [--out BENCH_TORCH.json]

Runs on CUDA unless `--device` says otherwise (and raises without a card).
The artifact has the root bench's keys; `device` is the card's name and
power limit, `compile_cache` is "n/a" (nothing is cached across processes),
`flops_counter` names the FLOP counter.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

NUM_CLIENTS = 2
# The root bench's packed geometry.
PACKING = dict(bits=8, interleave=4, clip=0.5)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _max_abs_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in b)


def run(device=None, rounds: int = 5, seed: int = 0, smoke: bool = False) -> dict:
    """The BENCH_TORCH artifact: `rounds` flagship rounds (round 0 cold),
    the cell-6 comparison, the standalone and packed HE phases with their
    roofline, the cohort and DCN comparisons, on `device` (CUDA unless
    given). `smoke` is the flagship's tiny variant (SmallCNN, MNIST, N =
    512)."""
    from hefl_tpu_torch import device_record, resolve_device
    from hefl_tpu_torch.ckks import ops
    from hefl_tpu_torch.ckks.keys import keygen
    from hefl_tpu_torch.ckks.packing import PackedSpec, PackSpec, bytes_on_wire_record
    from hefl_tpu_torch.ckks.quantize import PackingConfig
    from hefl_tpu_torch.data import iid_contiguous, stack_federated
    from hefl_tpu_torch.data.augment import resolve_shift_backend
    from hefl_tpu_torch.ckks.backend import he_backend_report
    from hefl_tpu_torch.experiment import augment_backend_record
    from hefl_tpu_torch.fl import hierarchy, stream
    from hefl_tpu_torch.fl.client import train_batch_geometry
    from hefl_tpu_torch.fl.fedavg import evaluate, fedavg_round
    from hefl_tpu_torch.fl.fusion import fusion_report, resolve_fusion_backend, supports_fusion
    from hefl_tpu_torch.fl.secure import (
        aggregate_encrypted,
        decrypt_average,
        encrypt_params,
        encrypt_params_packed,
        secure_fedavg_round,
    )
    from hefl_tpu_torch.flagship import (
        BASELINE_ACC,
        BASELINE_TOTAL_S,
        flagship_keygen_gen,
        flagship_round_gen,
        flagship_setup,
    )
    from hefl_tpu_torch.models import count_params
    from hefl_tpu_torch.obs import metrics as obs_metrics
    from hefl_tpu_torch.utils import roofline

    device = resolve_device(device)
    rounds = max(1, int(rounds))
    log(f"device: {device} ({device_record(device)['kind']})")
    setup = flagship_setup(seed, smoke=smoke, device=device)
    model, params, cfg, ctx = setup["module"], setup["params"], setup["cfg"], setup["ctx"]
    (x, y), (xt, yt) = setup["train"], setup["test"]
    xs, ys = stack_federated(x, y, iid_contiguous(len(x), NUM_CLIENTS))
    log(f"data: train {x.shape} -> {xs.shape} federated, test {xt.shape}")
    # The training backend, resolved once ("auto" times both on the card)
    # and pinned for every round, as run_experiment does.
    cfg = dataclasses.replace(cfg, client_fusion=resolve_fusion_backend(
        cfg.client_fusion, model, device))
    if cfg.augment:                 # the augment's backend likewise
        cfg = dataclasses.replace(cfg, aug_backend=resolve_shift_backend(cfg.aug_backend, device))
    he_backend = he_backend_report(device)
    sk, pk = keygen(ctx, flagship_keygen_gen(), device=device)
    pack = PackSpec.for_params(params, ctx.n)
    log(f"CKKS: N={ctx.n}, L={ctx.num_primes}, n_ct={pack.n_ct}; client_fusion "
        f"{cfg.client_fusion}")
    xs_d, ys_d = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    xt_d = torch.from_numpy(xt).to(device)

    _, grp, steps_per_epoch = train_batch_geometry(cfg, int(xs.shape[1]))
    fwd_flops = roofline.model_flops(model, (grp, *x.shape[1:]))
    train_flops = roofline.train_flops_per_round(fwd_flops, steps_per_epoch, cfg.epochs,
                                                 NUM_CLIENTS)
    train_images = NUM_CLIENTS * cfg.epochs * steps_per_epoch * grp

    round_stats, history, exclusions_by_round = [], [], []
    overflow_total = 0
    cur = params
    for r in range(rounds):
        _sync(device)
        t0 = time.perf_counter()
        ct_sum, metrics, overflow = secure_fedavg_round(
            model, cfg, ctx, pk, cur, xs_d, ys_d, flagship_round_gen(seed, r))
        _sync(device)
        t1 = time.perf_counter()
        new_params = decrypt_average(ctx, sk, ct_sum, NUM_CLIENTS, pack)
        _sync(device)
        t2 = time.perf_counter()
        results = evaluate(model, new_params, xt_d, yt)
        _sync(device)
        t3 = time.perf_counter()
        round_stats.append({"train": t1 - t0, "decrypt": t2 - t1, "evaluate": t3 - t2,
                            "total": t3 - t0})
        history.append({k: float(results[k]) for k in ("accuracy", "f1")})
        ov = overflow.cpu().numpy()
        overflow_total += int(ov.sum())
        exclusions_by_round.append({"excluded": 0, "overflow_clients": int((ov > 0).sum())})
        log(f"round {r}: train+encrypt+aggregate {t1 - t0:.3f}s | decrypt {t2 - t1:.3f}s | "
            f"evaluate {t3 - t2:.3f}s | total {t3 - t0:.3f}s | acc {results['accuracy']:.4f} "
            f"f1 {results['f1']:.4f}")
        last_ct_sum, last_start, last_r = ct_sum, cur, r
        cur = new_params

    # --- the cell-6 comparison ------------------------------------------
    ct_bytes = (last_ct_sum.c0.numel() + last_ct_sum.c1.numel()) * 4
    param_bytes = count_params(params) * 4
    expansion = ct_bytes / param_bytes

    def plain_round(c):
        out = fedavg_round(model, c, last_start, xs_d, ys_d, flagship_round_gen(seed, last_r))[0]
        _sync(device)
        return out

    plain_round(cfg)                       # warm-up, untimed
    tp0 = time.perf_counter()
    plain_params = plain_round(cfg)
    plaintext_round_s = time.perf_counter() - tp0
    fusion_seconds = {}
    for backend in ("vmap", "fused"):
        if backend == "fused" and not supports_fusion(model):
            continue
        cfg_b = dataclasses.replace(cfg, client_fusion=backend)
        plain_round(cfg_b)
        tb = time.perf_counter()
        plain_round(cfg_b)
        fusion_seconds[backend] = time.perf_counter() - tb
        log(f"plaintext round [client_fusion={backend}]: {fusion_seconds[backend]:.3f}s")
    ct_diag, _, ov_diag, plain_ref = secure_fedavg_round(
        model, cfg, ctx, pk, last_start, xs_d, ys_d, flagship_round_gen(seed, last_r),
        with_plain_reference=True)
    cell6_overflow = int(ov_diag.sum())
    max_diff = _max_abs_diff(decrypt_average(ctx, sk, ct_diag, NUM_CLIENTS, pack), plain_ref)
    max_diff_exact = _max_abs_diff(
        decrypt_average(ctx, sk, ct_diag, NUM_CLIENTS, pack, exact=True), plain_ref)
    log(f"cell-6: plaintext round {plaintext_round_s:.3f}s, max |enc_avg - plain_avg| = "
        f"{max_diff:.2e} (float decode) / {max_diff_exact:.2e} (exact decode), ciphertext "
        f"{ct_bytes / 1e6:.1f} MB vs plain {param_bytes / 1e6:.1f} MB ({expansion:.1f}x)")

    # --- the standalone HE phases and their roofline ----------------------
    enc_gen = lambda: flagship_keygen_gen(device)  # noqa: E731
    ct_he = encrypt_params(ctx, pk, cur, enc_gen())
    t_he_encrypt = roofline.steady_seconds(lambda: encrypt_params(ctx, pk, cur, enc_gen()))
    two = ops.Ciphertext(c0=torch.stack([ct_he.c0, ct_he.c0]),
                         c1=torch.stack([ct_he.c1, ct_he.c1]), scale=ct_he.scale)
    t_he_aggregate = roofline.steady_seconds(lambda: aggregate_encrypted(ctx, two))
    t_he_decrypt = roofline.steady_seconds(lambda: ops.decrypt(ctx, sk, ct_he))
    he_rows = roofline.he_roofline(
        {"encrypt": t_he_encrypt, "aggregate": t_he_aggregate, "decrypt": t_he_decrypt},
        n=ctx.n, num_limbs=ctx.num_primes, n_ct=pack.n_ct, num_clients=NUM_CLIENTS,
        encrypt_clients=1, device=device)
    log(f"HE phases: encrypt {t_he_encrypt:.6f}s | aggregate {t_he_aggregate:.6f}s | "
        f"decrypt-core {t_he_decrypt:.6f}s | backend {he_backend['backend']}")

    # --- packed quantized aggregation -------------------------------------
    pspec = PackedSpec.for_params(params, ctx, PackingConfig(**PACKING), NUM_CLIENTS)
    ct_pk = encrypt_params_packed(ctx, pk, cur, cur, enc_gen(), pspec)
    t_he_encrypt_packed = roofline.steady_seconds(
        lambda: encrypt_params_packed(ctx, pk, cur, cur, enc_gen(), pspec))
    t_he_decrypt_packed = roofline.steady_seconds(lambda: ops.decrypt(ctx, sk, ct_pk))
    bytes_on_wire = bytes_on_wire_record(pspec, ctx.num_primes)
    ct_pd, _, sat_pd, plain_ref_pd = secure_fedavg_round(
        model, cfg, ctx, pk, last_start, xs_d, ys_d, flagship_round_gen(seed, last_r),
        with_plain_reference=True, packing=pspec)
    packed_max_diff = _max_abs_diff(
        decrypt_average(ctx, sk, ct_pd, NUM_CLIENTS, packing=pspec, base_params=last_start),
        plain_ref_pd)
    packing_rec = {
        **pspec.geometry_record(),
        "standalone_encrypt_packed_s": round(t_he_encrypt_packed, 6),
        "encrypt_speedup": round(t_he_encrypt / t_he_encrypt_packed, 3),
        "decrypt_core_packed_s": round(t_he_decrypt_packed, 6),
        "decrypt_speedup": round(t_he_decrypt / t_he_decrypt_packed, 3),
        "packed_round_max_abs_diff": packed_max_diff,
        "packed_round_within_budget": packed_max_diff <= pspec.error_budget,
        "packed_saturation_count": int(sat_pd.sum()),
        "he_roofline_packed": roofline.he_roofline(
            {"encrypt": t_he_encrypt_packed, "aggregate": None, "decrypt": t_he_decrypt_packed},
            n=ctx.n, num_limbs=ctx.num_primes, n_ct=pspec.n_ct, num_clients=NUM_CLIENTS,
            encrypt_clients=1, device=device),
    }
    log(f"packing (b={pspec.bits} k={pspec.k}): n_ct {pack.n_ct} -> {pspec.n_ct} | encrypt "
        f"{t_he_encrypt_packed:.6f}s | decrypt-core {t_he_decrypt_packed:.6f}s | uplink "
        f"{bytes_on_wire['ciphertext_unpacked'] / 1e6:.1f} -> "
        f"{bytes_on_wire['ciphertext_packed'] / 1e6:.1f} MB | packed fidelity "
        f"{packed_max_diff:.2e} (budget {pspec.error_budget:.2e})")

    # --- the cohort and DCN comparisons -----------------------------------
    cohort_rec = stream.cohort_compare_smoke_record(device)
    log(f"cohort_compare (C=16, cohort=2, bucket {cohort_rec['bucket']}): full-C "
        f"{cohort_rec['full_c_train_s']:.3f}s vs cohort-only {cohort_rec['cohort_train_s']:.3f}s "
        f"= {cohort_rec['speedup']}x, bitwise_equal={cohort_rec['bitwise_equal']}")
    dcn_rec = hierarchy.dcn_compare_smoke_record(device)
    log(f"dcn_compare (cohort={dcn_rec['cohort_size']}, hosts={dcn_rec['num_hosts']}): "
        f"{dcn_rec['bytes_ratio']}x (floor {dcn_rec['ratio_floor']}), "
        f"bitwise_equal={dcn_rec['bitwise_equal']}")
    obs_metrics.record_device_memory(device)

    cold, warm = round_stats[0], round_stats[1:]
    warm_round_s = float(np.mean([s["total"] for s in warm])) if warm else None
    steady = {k: float(np.min([s[k] for s in warm])) if warm else None
              for k in ("total", "train", "decrypt", "evaluate")}
    # decrypt: the round's whole decrypt_average step; flops and mfu the
    # core's integer-op model over the core's time (the he_roofline row).
    decrypt_phase = roofline.phase_stats(steady["decrypt"] if warm else cold["decrypt"],
                                         device=device)
    decrypt_phase.update(flops=he_rows["decrypt"]["int_ops"],
                         mfu=he_rows["decrypt"]["util_vs_peak_int_ops"],
                         core_seconds=round(t_he_decrypt, 6), op_kind="int32",
                         peak_is_estimate=True)
    phase_roofline = {
        "train+encrypt+aggregate": roofline.phase_stats(
            steady["train"] if warm else cold["train"], flops=train_flops, device=device,
            images=train_images),
        "decrypt": decrypt_phase,
        "evaluate": roofline.phase_stats(
            steady["evaluate"] if warm else cold["evaluate"],
            flops=roofline.model_flops(model, (len(xt), *x.shape[1:])), device=device,
            images=len(xt)),
    }
    mfu = roofline.mfu(train_flops, steady["train"], device)
    log(f"cold round {cold['total']:.3f}s | warm mean {warm_round_s}s | steady "
        f"{steady['total']}s | train MFU {mfu} | train images/s "
        f"{phase_roofline['train+encrypt+aggregate']['images_per_s']}")
    steady_round_s = steady["total"]
    return {
        "metric": "encrypted_fedavg_pipeline_wallclock",
        **({"smoke": True} if smoke else {}),
        "value": round(cold["total"], 3),
        "unit": "s",
        "vs_baseline": round(BASELINE_TOTAL_S / cold["total"], 2),
        "compile_cache": "n/a",
        "rounds": rounds,
        "round_stats": round_stats,
        "warm_round_s": warm_round_s and round(warm_round_s, 3),
        "steady_round_s": steady_round_s and round(steady_round_s, 3),
        "rounds_per_sec_per_chip": steady_round_s and round(1.0 / steady_round_s, 4),
        "train_mfu": mfu and round(mfu, 4),
        "flops_counter": "torch.utils.flop_counter",
        "phase_roofline": phase_roofline,
        "augment_backend": augment_backend_record(),
        "client_fusion": fusion_report(),
        "client_fusion_compare": roofline.backend_compare(
            fusion_seconds, flops=train_flops, device=device, images=train_images),
        "he_backend": he_backend,
        "he_roofline": he_rows,
        "packing": packing_rec,
        "bytes_on_wire": bytes_on_wire,
        "cohort_compare": cohort_rec,
        "dcn_compare": dcn_rec,
        "device": device_record(device),
        "seed": seed,
        "accuracy": history[0]["accuracy"],
        "accuracy_by_round": [h["accuracy"] for h in history],
        "acc_vs_reference": round(history[0]["accuracy"] - BASELINE_ACC, 4),
        "plaintext_round_s": round(plaintext_round_s, 3),
        "enc_plain_max_abs_diff": max_diff,
        "enc_plain_max_abs_diff_exact_decode": max_diff_exact,
        "encode_overflow_count": overflow_total,
        "exclusions_by_round": exclusions_by_round,
        "cell6_encode_overflow_count": cell6_overflow,
        "max_abs_trained_weight": round(max(float(v.abs().max()) for v in plain_params.values()),
                                        4),
        "ciphertext_expansion": round(expansion, 2),
        "obs_metrics": obs_metrics.snapshot(),
    }


def _main(argv: list[str] | None = None) -> int:
    """`python -m hefl_tpu_torch.bench [--rounds 5] [--seed 0] [--smoke]
    [--device cpu] [--out BENCH_TORCH.json]`."""
    import argparse

    ap = argparse.ArgumentParser(description="The port's headline benchmark (BENCH_TORCH).")
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds, round 0 cold (default 5; 2 with --smoke)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="SmallCNN, MNIST, N=512")
    ap.add_argument("--device", default=None, help="where the run runs (default: cuda)")
    ap.add_argument("--out", default="BENCH_TORCH.json")
    args = ap.parse_args(argv)
    rounds = args.rounds if args.rounds is not None else (2 if args.smoke else 5)
    art = run(args.device, rounds=rounds, seed=args.seed, smoke=args.smoke)
    with open(args.out, "w") as f:
        json.dump(art, f, indent=2)
    dev = art["device"]
    print(json.dumps({k: art[k] for k in (
        "metric", "value", "unit", "vs_baseline", "warm_round_s", "steady_round_s",
        "rounds_per_sec_per_chip", "train_mfu", "accuracy", "enc_plain_max_abs_diff")}))
    print(f"bench: {dev['kind']} ({dev['power_limit']}) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
