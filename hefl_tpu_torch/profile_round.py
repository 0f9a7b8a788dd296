"""Phase attribution of the encrypted round: where a round's time goes.

Counterpart of the repository's root `profile_round.py`, on the port. The
round is one `fl.secure.secure_fedavg_round` (train, encrypt, the ciphertext
sum), then the owner's `decrypt_average` and `evaluate`. This harness
attributes it two ways:

  * `--profile [DIR]` (PRIMARY, `attribution_source: "trace"`): ONE warm
    round + decrypt + evaluate runs under `torch.profiler` (CPU and, on a
    card, CUDA activity), each inside its `utils.PhaseTimer` phase;
    `obs.trace.trace_attribution` buckets the trace's device ops by the
    `obs.scopes` ranges the port's paths open (augment / sgd_core / val /
    encrypt / psum_aggregate / decrypt / evaluate), joined through each
    kernel's launch. Per-phase device time from one run, printed as the
    `trace_attribution` table, with `round_wall_agreement`: the round
    phase's device time over its wall time (the device's busy share). A
    trace that cannot be attributed fails the run; there is no fallback to
    the ablation.
  * Ablation (CROSS-CHECK, always runs): the full round, the plaintext
    round, the plaintext round without augmentation and with a 1-image
    validation split at the same training geometry, each timed warm
    (`utils.roofline.steady_seconds`, min over `reps`). Each delta
    subtracts two runs, so raw deltas can go negative: rows are clamped at
    0, the raw values kept (`*_raw`), and `attribution_unreliable` flags a
    negative one. Standalone encrypt / aggregate / decrypt / evaluate
    timings cross-check the HE rows.

The configuration is the flagship's (`flagship.flagship_setup`: 2 clients,
10 local epochs, MedCNN on 1600 `medical` images at 256x256x3, N = 4096,
L = 3; `epochs` cuts the local epochs); `--smoke` is the root harness's
CPU-sized one (mnist, 32 train images, SmallCNN, 1 epoch, batch 8, N = 256).

    python -m hefl_tpu_torch.profile_round [--profile [DIR]] [--smoke] [--device cpu]

prints the markdown tables to stdout, then one JSON line
`{"metric": "phase_attribution", ...}` with the root harness's keys (the
augment row is `augment_gather_ms`, the port's one warp). Runs on CUDA
unless `--device` says otherwise, and raises without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

NUM_CLIENTS = 2
# The root harness's packed geometry.
PACKING = dict(bits=8, interleave=4, clip=0.5)
ROUND_MODULE = "hefl.phase.train+encrypt+aggregate"
# The root harness's record keys (its `att`) that the port fills; its
# per-backend augment rows are the port's one warp, `augment_gather_ms`.
RECORD_KEYS = (
    "attribution_source", "trace_attribution", "full_round_s", "train_s", "he_in_round_s",
    "augment_s", "per_epoch_val_s", "sgd_core_s", "he_in_round_s_raw", "augment_s_raw",
    "per_epoch_val_s_raw", "sgd_core_s_raw", "attribution_unreliable", "standalone_encrypt_s",
    "standalone_aggregate_s", "decrypt_s", "decrypt_core_s", "evaluate_s", "augment_gather_ms",
    "augment_backend", "client_fusion", "client_fusion_compare", "phase_roofline",
    "he_backend", "he_roofline", "packing", "bytes_on_wire", "cohort_compare", "obs_metrics",
    "device",
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _setup(smoke: bool, device) -> dict:
    """The flagship's setup, or the smoke configuration."""
    from hefl_tpu_torch.ckks.keys import CkksContext
    from hefl_tpu_torch.data import make_dataset
    from hefl_tpu_torch.fl import TrainConfig
    from hefl_tpu_torch.flagship import flagship_setup
    from hefl_tpu_torch.models import create_model

    if not smoke:
        return flagship_setup(0, device=device)
    train, test, _ = make_dataset("mnist", seed=0, n_train=32, n_test=32)
    module = create_model("smallcnn", gen=torch.Generator().manual_seed(123), device=device)
    return {
        "module": module,
        "params": {k: v.detach() for k, v in module.named_parameters()},
        "cfg": TrainConfig(epochs=1, batch_size=8, num_classes=10, val_fraction=0.25),
        "ctx": CkksContext.create(n=256),
        "train": train,
        "test": test,
    }


def traced_round(model, cfg, ctx, sk, pk, params, xs_d, ys_d, xt_d, yt, pack, profile: str,
                 device) -> dict:
    """ONE warm round + decrypt + evaluate under the profiler into
    `profile`, each in its PhaseTimer phase -> the trace_attribution record
    with `wall_s`, `round_module`, `round_wall_agreement` and
    `attributed_sum_s`. Raises (TraceParseError, or on a trace without the
    round's phase) when the trace cannot be attributed."""
    from hefl_tpu_torch.fl.fedavg import evaluate
    from hefl_tpu_torch.fl.secure import decrypt_average, secure_fedavg_round
    from hefl_tpu_torch.flagship import flagship_round_gen
    from hefl_tpu_torch.obs import trace as obs_trace
    from hefl_tpu_torch.utils import PhaseTimer

    def one(timer):
        with timer.phase("train+encrypt+aggregate"):
            ct, _, _ = secure_fedavg_round(model, cfg, ctx, pk, params, xs_d, ys_d,
                                           flagship_round_gen(0, 0))
        with timer.phase("decrypt"):
            decrypt_average(ctx, sk, ct, NUM_CLIENTS, pack)
        with timer.phase("evaluate"):
            evaluate(model, params, xt_d, yt)
        return timer.summary()

    one(PhaseTimer(device))                     # warm-up, untraced
    with obs_trace.round_profiler(profile, device):
        wall = one(PhaseTimer(device))
    rec = obs_trace.trace_attribution(profile)
    if ROUND_MODULE not in rec["modules"]:
        raise obs_trace.TraceParseError(
            f"the trace in {profile!r} holds no device op inside {ROUND_MODULE}")
    wall_s = {"round": wall["train+encrypt+aggregate"], "decrypt": wall["decrypt"],
              "evaluate": wall["evaluate"], "total": wall["total"]}
    log(f"traced one round into {profile} (round {wall_s['round']:.3f}s decrypt "
        f"{wall_s['decrypt']:.3f}s evaluate {wall_s['evaluate']:.3f}s)")
    return {
        **rec,
        "wall_s": wall_s,
        "round_module": ROUND_MODULE,
        # The round phase's device-op time over its wall time: the device's
        # busy share of the round (the profiler's overhead inflates the wall).
        "round_wall_agreement": (round(rec["modules"][ROUND_MODULE] / wall_s["round"], 4)
                                 if wall_s["round"] else None),
        "attributed_sum_s": obs_trace.attributed_sum_s(rec),
    }


def run(device=None, profile: str | None = None, smoke: bool = False, epochs: int | None = None,
        reps: int = 3) -> dict:
    """The phase_attribution record, on `device` (CUDA unless given);
    `profile` a directory for the traced round (attribution_source "trace"),
    `epochs` cuts the local epochs, `reps` the warm repetitions a timing
    takes the minimum of."""
    from hefl_tpu_torch import device_record, resolve_device
    from hefl_tpu_torch.ckks import ops
    from hefl_tpu_torch.ckks.keys import keygen
    from hefl_tpu_torch.ckks.packing import PackedSpec, PackSpec, bytes_on_wire_record
    from hefl_tpu_torch.ckks.quantize import PackingConfig
    from hefl_tpu_torch.data import iid_contiguous, stack_federated
    from hefl_tpu_torch.data.augment import apply_affine, draw_affine_params
    from hefl_tpu_torch.ckks.backend import he_backend_report
    from hefl_tpu_torch.experiment import augment_backend_record
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
    from hefl_tpu_torch.fl.stream import cohort_compare_smoke_record
    from hefl_tpu_torch.flagship import flagship_keygen_gen, flagship_round_gen
    from hefl_tpu_torch.obs import metrics as obs_metrics
    from hefl_tpu_torch.utils import roofline

    device = resolve_device(device)
    steady = lambda fn, r=reps: roofline.steady_seconds(fn, reps=r)  # noqa: E731
    setup = _setup(smoke, device)
    model, params, cfg, ctx = setup["module"], setup["params"], setup["cfg"], setup["ctx"]
    if epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=int(epochs))
    (x, y), (xt, yt) = setup["train"], setup["test"]
    xs, ys = stack_federated(x, y, iid_contiguous(len(x), NUM_CLIENTS))
    cfg = dataclasses.replace(cfg, client_fusion=resolve_fusion_backend(
        cfg.client_fusion, model, device))
    fusion = fusion_report()        # before the comparisons pin other backends
    he_backend = he_backend_report(device)
    sk, pk = keygen(ctx, flagship_keygen_gen(), device=device)
    pack = PackSpec.for_params(params, ctx.n)
    xs_d, ys_d = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    xt_d = torch.from_numpy(xt).to(device)
    log(f"device {device_record(device)['kind']}: {type(model).__name__} {tuple(x.shape)}, "
        f"{NUM_CLIENTS} clients x {cfg.epochs} epochs, N={ctx.n} L={ctx.num_primes} "
        f"(n_ct {pack.n_ct}), client_fusion {cfg.client_fusion}")
    gen = lambda: flagship_round_gen(0, 0)  # noqa: E731
    n_tr, grp, steps_per_epoch = train_batch_geometry(cfg, int(xs.shape[1]))

    # Trace first, so the ablation's repetitions do not warm what it times
    # beyond one round (the traced region warms itself with one untraced pass).
    trace_rec = None
    if profile:
        trace_rec = traced_round(model, cfg, ctx, sk, pk, params, xs_d, ys_d, xt_d, yt, pack,
                                 profile, device)

    variants = {
        "full secure round (train+encrypt+aggregate)": lambda: secure_fedavg_round(
            model, cfg, ctx, pk, params, xs_d, ys_d, gen())[0].c0,
        "plain round (train+mean, no HE)": lambda: fedavg_round(
            model, cfg, params, xs_d, ys_d, gen())[0],
        "plain round, augment off": lambda: fedavg_round(
            model, dataclasses.replace(cfg, augment=False), params, xs_d, ys_d, gen())[0],
        # Matched geometry: n_tr + 1 samples at an epsilon fraction validate
        # on ONE image with the full round's batch and steps an epoch.
        "plain round, 1-image val": lambda: fedavg_round(
            model, dataclasses.replace(cfg, val_fraction=1e-9, es_patience=10**6,
                                       plateau_patience=10**6),
            params, xs_d[:, : n_tr + 1], ys_d[:, : n_tr + 1], gen())[0],
    }
    times = {}
    for name, fn in variants.items():
        times[name] = steady(fn)
        log(f"{name}: {times[name]:.3f}s")

    pspec = PackedSpec.for_params(params, ctx, PackingConfig(**PACKING), NUM_CLIENTS)
    t_full_packed = steady(lambda: secure_fedavg_round(
        model, cfg, ctx, pk, params, xs_d, ys_d, gen(), packing=pspec)[0].c0)
    log(f"full secure round [packed b={pspec.bits} k={pspec.k}]: {t_full_packed:.3f}s")

    fusion_times = {}
    for backend in ("vmap", "fused"):
        if backend == "fused" and not supports_fusion(model):
            continue
        cfg_b = dataclasses.replace(cfg, client_fusion=backend)
        fusion_times[backend] = steady(
            lambda c=cfg_b: fedavg_round(model, c, params, xs_d, ys_d, gen())[0])
        log(f"plain round [client_fusion={backend}]: {fusion_times[backend]:.3f}s")

    # Standalone HE phases: one client's encrypt, the sum of two, the decrypt
    # core (c0 + c1*s, iNTT) and the owner's whole decrypt, the evaluation.
    enc_gen = lambda: flagship_keygen_gen(device)  # noqa: E731
    ct0 = encrypt_params(ctx, pk, params, enc_gen())
    t_encrypt = steady(lambda: encrypt_params(ctx, pk, params, enc_gen()))
    two = ops.Ciphertext(c0=torch.stack([ct0.c0, ct0.c0]), c1=torch.stack([ct0.c1, ct0.c1]),
                         scale=ct0.scale)
    t_aggregate = steady(lambda: aggregate_encrypted(ctx, two))
    t_decrypt_core = steady(lambda: ops.decrypt(ctx, sk, ct0))
    t_decrypt = steady(lambda: decrypt_average(ctx, sk, ct0, 1, pack))
    t_evaluate = steady(lambda: evaluate(model, params, xt_d, yt))
    log(f"standalone encrypt(1 client): {t_encrypt:.6f}s, aggregate(2): {t_aggregate:.6f}s, "
        f"decrypt: {t_decrypt:.6f}s (core {t_decrypt_core:.6f}s), evaluate: {t_evaluate:.6f}s")

    ct_pk = encrypt_params_packed(ctx, pk, params, params, enc_gen(), pspec)
    t_encrypt_packed = steady(
        lambda: encrypt_params_packed(ctx, pk, params, params, enc_gen(), pspec))
    t_decrypt_core_packed = steady(lambda: ops.decrypt(ctx, sk, ct_pk))
    log(f"standalone packed encrypt: {t_encrypt_packed:.6f}s, packed decrypt core: "
        f"{t_decrypt_core_packed:.6f}s")

    cohort_rec = cohort_compare_smoke_record(device)
    log(f"cohort_compare (C=16, cohort=2, bucket {cohort_rec['bucket']}): full-C "
        f"{cohort_rec['full_c_train_s']:.3f}s vs cohort-only {cohort_rec['cohort_train_s']:.3f}s "
        f"= {cohort_rec['speedup']}x, bitwise_equal={cohort_rec['bitwise_equal']}")

    # The augment warp at the training batch of the flagship's 256x256x3.
    batch = torch.from_numpy(np.random.default_rng(3).random(
        (cfg.batch_size, 256, 256, 3), np.float32)).to(device)
    aff = draw_affine_params(torch.Generator(device=device).manual_seed(0), cfg.batch_size,
                             cfg.aug_shear, cfg.aug_zoom, cfg.aug_flip)
    t_aug = steady(lambda: apply_affine(batch, *aff), 10)
    log(f"apply_affine per batch-{cfg.batch_size}: {t_aug * 1e3:.3f} ms")

    full = times["full secure round (train+encrypt+aggregate)"]
    train_only = times["plain round (train+mean, no HE)"]
    raw = {
        "he_in_round_s": full - train_only,
        "augment_s": train_only - times["plain round, augment off"],
        "per_epoch_val_s": train_only - times["plain round, 1-image val"],
    }
    raw["sgd_core_s"] = times["plain round, augment off"] - raw["per_epoch_val_s"]
    clamped, unreliable = roofline.clamp_attribution(raw)

    fwd_flops = roofline.model_flops(model, (grp, *x.shape[1:]))
    train_flops = roofline.train_flops_per_round(fwd_flops, steps_per_epoch, cfg.epochs,
                                                 NUM_CLIENTS)
    train_images = NUM_CLIENTS * cfg.epochs * steps_per_epoch * grp
    he_rows = roofline.he_roofline(
        {"encrypt": t_encrypt, "aggregate": t_aggregate, "decrypt": t_decrypt_core},
        n=ctx.n, num_limbs=ctx.num_primes, n_ct=pack.n_ct, num_clients=NUM_CLIENTS,
        encrypt_clients=1, device=device)
    decrypt_phase = roofline.phase_stats(t_decrypt, device=device)
    decrypt_phase.update(flops=he_rows["decrypt"]["int_ops"],
                         mfu=he_rows["decrypt"]["util_vs_peak_int_ops"],
                         core_seconds=round(t_decrypt_core, 6), op_kind="int32",
                         peak_is_estimate=True)
    phase_roofline = {
        "fused_round": roofline.phase_stats(full, flops=train_flops, device=device,
                                            images=train_images),
        "train_only": roofline.phase_stats(train_only, flops=train_flops, device=device,
                                           images=train_images),
        "decrypt": decrypt_phase,
        "evaluate": roofline.phase_stats(
            t_evaluate, flops=roofline.model_flops(model, (len(xt), *x.shape[1:])),
            device=device, images=len(xt)),
    }
    he_in_round_packed_raw = t_full_packed - train_only
    bytes_on_wire = bytes_on_wire_record(pspec, ctx.num_primes)
    packing_rec = {
        **pspec.geometry_record(),
        "full_round_packed_s": round(t_full_packed, 6),
        "he_in_round_packed_s": round(max(he_in_round_packed_raw, 0.0), 6),
        "he_in_round_packed_s_raw": round(he_in_round_packed_raw, 6),
        "he_in_round_speedup": (round(raw["he_in_round_s"] / he_in_round_packed_raw, 3)
                                if he_in_round_packed_raw > 0 and raw["he_in_round_s"] > 0
                                else None),
        "standalone_encrypt_packed_s": round(t_encrypt_packed, 6),
        "encrypt_speedup": round(t_encrypt / t_encrypt_packed, 3),
        "decrypt_core_packed_s": round(t_decrypt_core_packed, 6),
        "decrypt_speedup": round(t_decrypt_core / t_decrypt_core_packed, 3),
        "he_roofline_packed": roofline.he_roofline(
            {"encrypt": t_encrypt_packed, "aggregate": None, "decrypt": t_decrypt_core_packed},
            n=ctx.n, num_limbs=ctx.num_primes, n_ct=pspec.n_ct, num_clients=NUM_CLIENTS,
            encrypt_clients=1, device=device),
    }
    obs_metrics.record_device_memory(device)
    return {
        "metric": "phase_attribution",
        **({"smoke": True} if smoke else {}),
        "epochs": cfg.epochs,
        "attribution_source": "trace" if trace_rec is not None else "ablation",
        **({"trace_attribution": trace_rec} if trace_rec is not None else {}),
        "full_round_s": round(full, 3),
        "train_s": round(train_only, 3),
        **{k: round(v, 3) for k, v in clamped.items()},
        **{f"{k}_raw": round(v, 3) for k, v in raw.items()},
        "attribution_unreliable": unreliable,
        "standalone_encrypt_s": round(t_encrypt, 6),
        "standalone_aggregate_s": round(t_aggregate, 6),
        "decrypt_s": round(t_decrypt, 6),
        "decrypt_core_s": round(t_decrypt_core, 6),
        "evaluate_s": round(t_evaluate, 6),
        "augment_gather_ms": round(t_aug * 1e3, 3),
        "augment_backend": augment_backend_record(),
        "client_fusion": fusion,
        "client_fusion_compare": roofline.backend_compare(
            fusion_times, flops=train_flops, device=device, images=train_images),
        "phase_roofline": phase_roofline,
        "he_backend": he_backend,
        "he_roofline": he_rows,
        "packing": packing_rec,
        "bytes_on_wire": bytes_on_wire,
        "cohort_compare": cohort_rec,
        "obs_metrics": obs_metrics.snapshot(),
        "device": device_record(device),
    }


def print_tables(att: dict) -> None:
    """The root harness's markdown tables of a phase_attribution record."""
    trace_rec = att.get("trace_attribution")
    if trace_rec is not None:
        total = trace_rec["attributed_sum_s"] or 1.0
        unit = "device s" if trace_rec["device_events"] == "kernel" else "host s (cpu_op)"
        print("Attribution method: TRACE — one warm round (+ decrypt + evaluate) under "
              "torch.profiler; rows are per-phase unions of the trace's "
              f"{trace_rec['device_events']} events, each attributed to the innermost "
              "obs.scopes range around its launch (hefl_tpu_torch.obs.trace). The ablation "
              "table below is retained as a cross-check.")
        print()
        print(f"| phase (trace) | {unit} | ops | share of traced time |")
        print("|---|---|---|---|")
        for ph, row in trace_rec["rows"].items():
            print(f"| {ph} | {row['device_seconds']:.6f} | {row['op_events']} "
                  f"| {row['device_seconds'] / total:.1%} |")
        print(f"| (unattributed) | {trace_rec['unattributed_s']:.6f} | "
              f"| {trace_rec['unattributed_s'] / total:.1%} |")
        print()
        wall = trace_rec["wall_s"]
        print(f"traced round wall {wall['round']:.3f}s vs round-phase device time "
              f"{trace_rec['modules'].get(trace_rec['round_module'], 0.0):.3f}s (agreement "
              f"{trace_rec['round_wall_agreement']}); decrypt wall {wall['decrypt']:.3f}s, "
              f"evaluate wall {wall['evaluate']:.3f}s; {trace_rec['op_events']} op events, "
              f"dropped launches {trace_rec['dropped_launches']}; attribution_source: trace")
        print()
    unreliable = att["attribution_unreliable"]
    print("Ablation cross-check"
          + ("" if trace_rec is not None else
             " (attribution_source: ablation — run with --profile for the trace table)")
          + ": each row below the total is the difference between two separately timed "
          "rounds. Raw deltas are clamped at 0 in this table; the JSON keeps the raw values "
          "(`*_raw`) and sets `attribution_unreliable: true` when any raw delta was negative"
          + (" — WHICH IS THE CASE FOR THIS RUN" if unreliable else "") + ".")
    print()
    full = att["full_round_s"] or 1.0
    print("| phase | seconds | share of the round |")
    print("|---|---|---|")
    print(f"| round total | {att['full_round_s']:.3f} | 100.0% |")
    for name, key in (("  local SGD (no augment, no val)", "sgd_core_s"),
                      ("  data augmentation (affine warp)", "augment_s"),
                      ("  per-epoch validation + callbacks", "per_epoch_val_s"),
                      ("  CKKS encrypt + sum (full - plain)", "he_in_round_s")):
        print(f"| {name} | {att[key]:.3f} | {att[key] / full:.1%} |")
    print(f"| decrypt (separate phase) | {att['decrypt_s']:.6f} | — |")
    print(f"| evaluate (separate phase) | {att['evaluate_s']:.6f} | — |")
    print()
    tr = att["phase_roofline"]["train_only"]
    print(f"train-phase roofline: MFU {tr['mfu']} | {tr['images_per_s']} images/s")
    print()
    print(f"| augment backend | ms / batch |\n|---|---|\n| gather (selected) | "
          f"{att['augment_gather_ms']} |")
    print()
    print("| client-fusion backend (plain round) | seconds | MFU |")
    print("|---|---|---|")
    for b in ("vmap", "fused"):
        row = att["client_fusion_compare"].get(b)
        if row is not None:
            print(f"| {b} | {row['seconds']:.3f} | {row['mfu']} |")
    print()
    print(f"| HE phase (backend={att['he_backend']['backend']}) | seconds | int-ops/s "
          "| bytes/s |")
    print("|---|---|---|---|")
    for ph in ("encrypt", "aggregate", "decrypt"):
        row = att["he_roofline"][ph]
        print(f"| {ph} | {row['seconds']} | {row['int_ops_per_s']:.3g} "
              f"| {row['bytes_per_s']:.3g} |")
    print()
    pk, bw = att["packing"], att["bytes_on_wire"]
    print(f"| packing (b={pk['bits']}, k={pk['interleave']}) | unpacked | packed | speedup/reduction |")
    print("|---|---|---|---|")
    print(f"| n_ct | {pk['n_ct_unpacked']} | {pk['n_ct']} | {pk['n_ct_unpacked'] / pk['n_ct']:.2f}x |")
    sp = pk["he_in_round_speedup"]
    print(f"| he_in_round (s) | {att['he_in_round_s']:.3f} | {pk['he_in_round_packed_s']:.3f} "
          f"| {f'{sp}x' if sp is not None else 'n/a (ablation noise)'} |")
    print(f"| standalone encrypt (s) | {att['standalone_encrypt_s']:.6f} "
          f"| {pk['standalone_encrypt_packed_s']:.6f} | {pk['encrypt_speedup']}x |")
    print(f"| decrypt core (s) | {att['decrypt_core_s']:.6f} | {pk['decrypt_core_packed_s']:.6f} "
          f"| {pk['decrypt_speedup']}x |")
    print(f"| uplink bytes/client | {bw['ciphertext_unpacked']} | {bw['ciphertext_packed']} "
          f"| {bw['packed_reduction']}x |")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="per-phase attribution of the encrypted round")
    ap.add_argument("--profile", nargs="?", const="profile_trace", default=None, metavar="DIR",
                    help="trace ONE warm round (+ decrypt + evaluate) with torch.profiler into "
                         "DIR and emit the trace_attribution table (per-phase device time "
                         "from one run; attribution_source becomes 'trace')")
    ap.add_argument("--smoke", action="store_true",
                    help="mnist, 32 train images, SmallCNN, 1 epoch, batch 8, N=256")
    ap.add_argument("--device", default=None, help="where the run runs (default: cuda)")
    args = ap.parse_args(argv)
    att = run(args.device, profile=args.profile, smoke=args.smoke)
    print_tables(att)
    print(json.dumps(att))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
