"""Command-line entry: `python -m hefl_tpu_torch.cli [flags]`.

The encrypted FedAvg paths of `hefl_tpu.cli` on one GPU:
`python -m hefl_tpu_torch.cli --model medcnn --dataset medical
--num-clients 2 [--epochs E --n-train N --n-test M --device cpu]`.
Each round trains every client, encrypts, sums the ciphertexts mod p, and
the owner decrypts the average, which is then evaluated on the test split.
`--pack-bits B` uploads b-bit quantized updates interleaved k to a slot;
`--stream` folds the uploads online (full cohort, quorum 1.0); `--hhe`
(with `--pack-bits`, implying `--stream`) has the clients encrypt their
packed update under a stream cipher and the server transcipher it into
CKKS before the fold.

The flags keep the JAX CLI's names and defaults. A flag of the JAX CLI that
this port does not have yet (DP, faults, cohorts, journal, ...) is refused
with an error naming it, never silently ignored; so is a value the port does
not run (`--quorum` other than 1.0). `--device` is the one flag the JAX CLI
lacks: the run is on CUDA unless it names another device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from hefl_tpu_torch import resolve_device
from hefl_tpu_torch.ckks.keys import CkksContext, keygen
from hefl_tpu_torch.ckks.packing import PackedSpec, PackSpec, bytes_on_wire_record
from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
from hefl_tpu_torch.data.synthetic import make_dataset
from hefl_tpu_torch.fl.config import HheConfig, PackingConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.fedavg import evaluate
from hefl_tpu_torch.fl.secure import decrypt_average, secure_fedavg_round
from hefl_tpu_torch.fl.stream import StreamEngine
from hefl_tpu_torch.hhe.cipher import hhe_bytes_on_wire_record
from hefl_tpu_torch.models import MODEL_REGISTRY, count_params, create_model

# Flags of `hefl_tpu.cli` that the port does not run yet.
UNPORTED_FLAGS = (
    "--preset", "--data-dir", "--image-size", "--plaintext", "--partition",
    "--skew-alpha", "--prox-mu", "--client-fusion", "--checkpoint", "--resume",
    "--save-model", "--no-save-model", "--centralized", "--profile", "--events",
    "--no-events", "--span-trace", "--dp-noise", "--dp-clip", "--dp-delta",
    "--on-overflow", "--max-update-norm", "--drop-fraction", "--nan-clients",
    "--huge-clients", "--straggler-delay", "--fail-rounds", "--arrival-delay",
    "--duplicate-clients", "--transient-clients", "--permanent-clients",
    "--outage-hosts", "--link-loss", "--link-dark", "--link-delay", "--link-dup",
    "--fault-seed", "--cohort-size", "--deadline",
    "--staleness", "--stream-retries", "--stream-backoff", "--stream-seed",
    "--full-cohort-train", "--num-hosts", "--host-quorum", "--ship-deadline",
    "--host-staleness", "--mesh-ct", "--serve",
    "--journal-path", "--fsync-policy", "--crash-round", "--crash-at",
    "--crash-after-folds", "--dp-min-surviving", "--max-round-retries",
    "--retry-backoff",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hefl_tpu_torch",
        description="Encrypted federated learning (CKKS FedAvg) on one GPU",
    )
    p.add_argument("--model", default="medcnn", choices=sorted(MODEL_REGISTRY))
    p.add_argument("--dataset", default="medical", choices=["medical", "mnist", "cifar10"])
    p.add_argument("--num-clients", type=int, default=2)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--epochs", type=int, default=10, help="local epochs per round")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear lr warmup steps (0 = reference behavior)")
    p.add_argument("--num-classes", type=int, default=None,
                   help="default: the model's registry default")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--he-n", type=int, default=4096, help="CKKS ring degree")
    p.add_argument("--he-primes", type=int, default=3, help="RNS limb count")
    p.add_argument("--pack-bits", type=int, default=0, metavar="B",
                   help="quantize client updates to B bits and bit-interleave them "
                        "k-to-a-CKKS-slot (0 = off, the float path)")
    p.add_argument("--pack-interleave", type=int, default=0, metavar="K",
                   help="coefficients per slot (0 = auto: the carry-free headroom "
                        "maximum for the ring and client count)")
    p.add_argument("--pack-clip", type=float, default=None, metavar="C",
                   help="symmetric clip bound on a client's update (default 0.5); "
                        "|update| > C saturates (counted in encode_overflow)")
    p.add_argument("--stream", action="store_true",
                   help="streaming aggregation: uploads fold online into a running "
                        "modular sum (full cohort, quorum 1.0)")
    p.add_argument("--quorum", type=float, default=1.0, metavar="Q",
                   help="fraction of the cohort whose arrivals commit the round "
                        "(the port runs 1.0 only)")
    p.add_argument("--hhe", action="store_true",
                   help="hybrid-HE uplink: clients encrypt their packed update under "
                        "a per-client stream cipher (~1x wire bytes, no client-side "
                        "NTTs) and the server transciphers into CKKS before the "
                        "fold; requires --pack-bits and implies --stream")
    p.add_argument("--hhe-key-seed", type=int, default=0, metavar="S",
                   help="enrollment seed of the per-client symmetric master keys")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-train", type=int, default=None)
    p.add_argument("--n-test", type=int, default=None)
    p.add_argument("--json", action="store_true", help="emit history as JSON lines")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: CUDA; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p


def check_args(args: argparse.Namespace) -> None:
    """Refuse flag combinations that would be silently ignored, and values
    the port does not run, naming the flag (`hefl_tpu.cli`'s checks)."""
    if args.pack_bits <= 0 and (args.pack_interleave or args.pack_clip is not None):
        raise ValueError("--pack-interleave/--pack-clip have no effect without "
                         "--pack-bits; add --pack-bits B to enable packing")
    if args.quorum != 1.0:
        raise ValueError(f"--quorum {args.quorum}: hefl_tpu_torch runs quorum 1.0 only "
                         "(partial quorums are not supported yet)")
    if args.hhe and args.pack_bits <= 0:
        raise ValueError("--hhe ships the PACKED quantized update under the stream "
                         "cipher; add --pack-bits B to enable packing")
    if args.hhe_key_seed and not args.hhe:
        raise ValueError("--hhe-key-seed has no effect without --hhe; add --hhe to "
                         "enable the hybrid-HE uplink")
    _packing_config(args)


def _packing_config(args: argparse.Namespace) -> PackingConfig | None:
    if args.pack_bits <= 0:
        return None
    return PackingConfig(
        bits=args.pack_bits, interleave=args.pack_interleave,
        clip=0.5 if args.pack_clip is None else args.pack_clip,
    )


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            parser.error(f"{flag} is a hefl_tpu flag that hefl_tpu_torch does not support yet")
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    try:
        check_args(args)
    except ValueError as exc:
        parser.error(str(exc))
    return args


def run(args: argparse.Namespace, say=print) -> list[dict]:
    """Run `args.rounds` encrypted FedAvg rounds -> one record per round."""
    check_args(args)
    device = resolve_device(args.device)
    num_classes = args.num_classes or MODEL_REGISTRY[args.model][1]
    cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        warmup_steps=args.warmup_steps, augment=not args.no_augment,
        num_classes=num_classes,
    )
    (x, y), (xt, yt), _ = make_dataset(
        args.dataset, seed=args.seed, n_train=args.n_train, n_test=args.n_test
    )
    xs, ys = stack_federated(x, y, iid_contiguous(len(y), args.num_clients))
    xs_d = torch.from_numpy(xs).to(device)
    ys_d = torch.from_numpy(ys).to(device)
    xt_d = torch.from_numpy(xt).to(device)
    gen = torch.Generator().manual_seed(args.seed)
    model = create_model(
        args.model, num_classes=num_classes, input_shape=tuple(x.shape[1:]),
        gen=gen, device=device,
    )
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = CkksContext.create(n=args.he_n, num_primes=args.he_primes)
    sk, pk = keygen(ctx, gen, device=device)
    spec = PackSpec.for_params(params, ctx.n)
    say(f"CKKS context: N={ctx.n} L={ctx.num_primes} -> {spec.n_ct} ciphertexts "
        f"for {count_params(params):,} params on {device}")
    packing = _packing_config(args)
    pspec = None
    if packing is not None:
        pspec = PackedSpec.for_params(params, ctx, packing, args.num_clients)
        say(f"packing: b={pspec.bits} k={pspec.k} (guard {pspec.guard}, clip {pspec.clip}) "
            f"-> {pspec.n_ct} packed ciphertexts, error budget {pspec.error_budget:.2e}")
    engine = hhe = None
    if args.stream or args.hhe:
        engine = StreamEngine(StreamConfig(quorum=args.quorum,
                                           upload_kind="hhe" if args.hhe else "ckks"))
        hhe = HheConfig(key_seed=args.hhe_key_seed) if args.hhe else None
    history = []
    for r in range(args.rounds):
        t0 = time.perf_counter()
        meta = smeta = None
        if engine is not None:
            ct_sum, metrics, overflow, smeta = engine.run_round(
                model, cfg, ctx, pk, params, xs_d, ys_d, gen, r, packing=pspec, hhe=hhe
            )
            meta = smeta.meta
        else:
            ct_sum, metrics, overflow = secure_fedavg_round(
                model, cfg, ctx, pk, params, xs_d, ys_d, gen, packing=pspec
            )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        params = decrypt_average(ctx, sk, ct_sum, args.num_clients, spec, meta=meta,
                                 packing=pspec, base_params=params, hhe=args.hhe)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        results = evaluate(model, params, xt_d, yt)
        t3 = time.perf_counter()
        mets = metrics.numpy()
        record = {
            "round": r,
            "phases": {"train+encrypt+aggregate": t1 - t0, "decrypt": t2 - t1,
                       "evaluate": t3 - t2},
            "val_loss": mets[:, -1, 0].tolist(),
            "val_acc": mets[:, -1, 1].tolist(),
            "encode_overflow": int(overflow.sum()),
            **{k: float(results[k]) for k in ("accuracy", "precision", "recall", "f1")},
        }
        if pspec is not None:
            record["packing"] = pspec.geometry_record()
            record["bytes_on_wire"] = bytes_on_wire_record(pspec, ctx.num_primes)
        if smeta is not None:
            record["stream"] = smeta.record()
        if args.hhe:
            record["hhe"] = {"key_seed": args.hhe_key_seed,
                             **hhe_bytes_on_wire_record(pspec, ctx.num_primes)}
        history.append(record)
        say(f"round {r}: acc {record['accuracy']:.4f} f1 {record['f1']:.4f} "
            f"(train+encrypt+aggregate {t1 - t0:.2f}s, decrypt {t2 - t1:.2f}s, "
            f"evaluate {t3 - t2:.2f}s)")
    return history


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    history = run(args, say=(lambda *_: None) if args.json else print)
    if args.json:
        for rec in history:
            print(json.dumps(rec, default=lambda o: np.asarray(o).tolist()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
