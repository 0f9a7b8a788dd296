"""Command-line entry: `python -m hefl_tpu_torch.cli [flags]`.

The experiment driver of `hefl_tpu.cli` on one GPU: the flags build an
`ExperimentConfig` and `experiment.run_experiment` runs it, e.g.
`python -m hefl_tpu_torch.cli --preset medical-8 [--device cpu]` or
`python -m hefl_tpu_torch.cli --model medcnn --dataset medical
--num-clients 2 [--epochs E --n-train N --n-test M --device cpu]`.
Each round trains every client, encrypts, sums the ciphertexts mod p, and
the owner decrypts the average, which is then evaluated on the test split;
`--plaintext` averages in the clear, `--centralized` trains one model on
the whole set; `--client-fusion fused|vmap|auto` picks how a round's
clients train (`fl.fusion`). `--pack-bits B` uploads b-bit quantized
updates interleaved k to a slot; `--stream` folds the uploads online
(`fl.stream`: `--cohort-size`, `--quorum`, `--deadline`, `--staleness`,
`--stream-retries`, `--stream-backoff`, `--stream-seed`,
`--full-cohort-train`); `--hhe` (with `--pack-bits`, implying `--stream`)
has the clients encrypt their packed update under a stream cipher and the
server transcipher it into CKKS before the fold. `--serve` /
`--journal-path` (with `--fsync-policy` and the `--crash-*` injection)
run the durable aggregation service (`fl.server`); `--events`,
`--no-events` and `--span-trace` route the run's event log and span
trees. `--dp-noise SIGMA` (with `--dp-clip`,
`--dp-delta`, `--dp-min-surviving`) runs DP-FedAvg; `--drop-fraction`,
`--nan-clients`, `--huge-clients`, `--straggler-delay`, `--fail-rounds`,
`--fault-seed` and the streaming engine's `--arrival-delay`,
`--duplicate-clients`, `--transient-clients` and `--permanent-clients`
inject a deterministic fault schedule, and `--on-overflow
exclude` / `--max-update-norm` sanitize the uploads (`fl.faults`, `fl.dp`).
`--num-hosts H` (>= 2, implying `--stream`) folds each host's client block
locally and ships one partial a host (`fl.hierarchy`), under
`--host-quorum`, `--ship-deadline` and `--host-staleness`; `--outage-hosts`
darkens whole host blocks and `--link-loss`, `--link-dark`, `--link-delay`
and `--link-dup` fault the tier->root uplinks.
`--preset NAME` runs a named configuration (`presets.PRESETS`) and ignores
the other flags but `--resume`, `--json` and `--device`.

The flags keep the JAX CLI's names, defaults and guards (the final model is
saved to agg_model.npz unless `--no-save-model`). A flag of the JAX CLI
that this port does not have yet (`--data-dir`, `--image-size`,
`--profile`, `--mesh-ct`; ROADMAP) is refused with an error naming it,
never silently ignored. `--device` is the one flag the JAX CLI lacks: the run is on CUDA
unless it names another device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from hefl_tpu_torch.experiment import ExperimentConfig, HEConfig, run_experiment
from hefl_tpu_torch.fl.config import HheConfig, PackingConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.dp import DpConfig
from hefl_tpu_torch.fl.faults import CRASH_POINTS, CrashConfig, FaultConfig
from hefl_tpu_torch.models import MODEL_REGISTRY
from hefl_tpu_torch.presets import PRESETS

# Flags of `hefl_tpu.cli` that the port does not run yet.
UNPORTED_FLAGS = ("--data-dir", "--image-size", "--profile", "--mesh-ct")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hefl_tpu_torch",
        description="Encrypted federated learning (CKKS FedAvg) on one GPU",
    )
    p.add_argument("--preset", default=None,
                   help="run a named BASELINE.json config (see "
                        "hefl_tpu_torch.presets.PRESETS); other flags are ignored")
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
    p.add_argument("--plaintext", action="store_true",
                   help="plain FedAvg (no HE) — the cell-6 comparison path")
    p.add_argument("--partition", default="iid", choices=["iid", "label_skew"])
    p.add_argument("--skew-alpha", type=float, default=0.5)
    p.add_argument("--prox-mu", type=float, default=0.0, help="FedProx strength")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--client-fusion", default="auto",
                   choices=["auto", "fused", "vmap"],
                   help="cross-client training backend: 'fused' folds the "
                        "client axis into every conv/dense GEMM batch "
                        "(fl.fusion), 'vmap' is the per-client reference, "
                        "'auto' micro-times both once per device (the "
                        "winner is not persisted across processes yet)")
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
                   help="streaming quorum aggregation: arriving encrypted "
                        "updates fold online into a running modular sum; "
                        "rounds commit at --quorum, stragglers carry under "
                        "--staleness instead of stalling the round")
    p.add_argument("--cohort-size", type=int, default=0, metavar="K",
                   help="clients sampled into each round's cohort "
                        "(0 = all; implies --stream semantics)")
    p.add_argument("--quorum", type=float, default=1.0, metavar="Q",
                   help="fraction of the cohort whose arrivals commit the "
                        "round; below it the round degrades gracefully "
                        "(model carried forward, loud event)")
    p.add_argument("--deadline", type=float, default=0.0, metavar="S",
                   help="per-client arrival deadline in simulated seconds "
                        "(0 = none)")
    p.add_argument("--staleness", type=int, default=0, metavar="T",
                   help="bounded-staleness budget: rounds a missed upload "
                        "may carry forward before exclusion as stale")
    p.add_argument("--stream-retries", type=int, default=0, metavar="N",
                   help="redelivery attempts for a lost upload "
                        "(exponential backoff + jitter)")
    p.add_argument("--stream-backoff", type=float, default=0.25, metavar="S",
                   help="base backoff between delivery retries")
    p.add_argument("--stream-seed", type=int, default=0,
                   help="PRNG seed of cohort sampling and retry jitter")
    p.add_argument("--full-cohort-train", action="store_true",
                   help="disable cohort-only training: every registered "
                        "client slot trains each round with unsampled "
                        "clients masked (the historical full-C producer; "
                        "the cohort-only default gathers just the sampled "
                        "cohort's slots, bitwise the same aggregate)")
    p.add_argument("--num-hosts", type=int, default=0, metavar="H",
                   help="hierarchical multi-host aggregation (>= 2): each "
                        "host folds its contiguous client block locally "
                        "and ships ONE partial ciphertext across the "
                        "simulated DCN per round — O(hosts) cross-host "
                        "bytes, bitwise the flat fold; 0 = flat "
                        "single-root aggregation; implies --stream")
    p.add_argument("--host-quorum", type=float, default=1.0, metavar="Q",
                   help="fraction of the round's nonempty host tiers "
                        "whose partials must land at the root to commit; "
                        "below it the round degrades like a missed client "
                        "quorum; requires --num-hosts H >= 2")
    p.add_argument("--ship-deadline", type=float, default=0.0, metavar="S",
                   help="per-round tier->root ship deadline in simulated "
                        "seconds from the client-quorum commit point "
                        "(0 = none; retried deliveries are exempt); "
                        "requires --num-hosts H >= 2")
    p.add_argument("--host-staleness", type=int, default=0, metavar="T",
                   help="tier staleness budget: rounds a host partial "
                        "that missed its ship may carry forward to fold "
                        "as a stale tier fold before its clients are "
                        "excluded as host_stale; requires --num-hosts")
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
    p.add_argument("--checkpoint", default=None, help="checkpoint path (.npz)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save-model", default="agg_model.npz", metavar="PATH",
                   dest="save_model",
                   help="persist the final aggregated model (the reference's "
                        "agg_model.hdf5, always written); --no-save-model "
                        "to disable")
    p.add_argument("--no-save-model", action="store_const", const=None,
                   dest="save_model")
    p.add_argument("--centralized", action="store_true",
                   help="centralized (non-federated) baseline: train one "
                        "model on the whole dataset (train_server analog)")
    p.add_argument("--events", default=None, metavar="PATH", dest="events",
                   help="structured run-event JSONL (obs.events). Default: "
                        "events.jsonl next to --checkpoint (else ./); "
                        "--no-events or HEFL_EVENTS=0 disables")
    p.add_argument("--no-events", action="store_const", const="",
                   dest="events")
    p.add_argument("--span-trace", default=None, metavar="PATH",
                   dest="span_trace",
                   help="write every streaming round's lifecycle span tree "
                        "(obs.spans: arrival/fold/ship/commit/recovery on "
                        "the engine's virtual clock) as Chrome trace-viewer "
                        "JSON (.gz honored); streaming runs only")
    p.add_argument("--json", action="store_true", help="emit history as JSON lines")
    p.add_argument("--dp-noise", type=float, default=0.0, metavar="SIGMA",
                   help="DP-FedAvg central noise multiplier (0 = off): clip "
                        "client deltas and add distributed Gaussian noise "
                        "inside the encrypted round (fl/dp.py); per-round "
                        "epsilon is reported in the history")
    p.add_argument("--dp-clip", type=float, default=1.0, metavar="C",
                   help="DP-FedAvg L2 clip bound on a client's model delta")
    p.add_argument("--dp-delta", type=float, default=1e-5,
                   help="target delta for the (epsilon, delta) accountant")
    p.add_argument("--on-overflow", default="warn", choices=["warn", "exclude", "raise"],
                   help="when a client's update saturates the CKKS encode "
                        "envelope: warn (reference behavior), exclude the "
                        "client from the round, or raise")
    p.add_argument("--max-update-norm", type=float, default=0.0, metavar="L2",
                   help="exclude clients whose update L2 norm (vs the "
                        "round's global weights) exceeds this bound "
                        "(0 = no bound)")
    p.add_argument("--drop-fraction", type=float, default=0.0,
                   help="fault injection: fraction of clients scheduled "
                        "out of each round (deterministic, --fault-seed)")
    p.add_argument("--nan-clients", type=int, default=0, metavar="K",
                   help="fault injection: clients per round whose update "
                        "is NaN-poisoned before aggregation")
    p.add_argument("--huge-clients", type=int, default=0, metavar="K",
                   help="fault injection: clients per round whose update "
                        "gets +1e15 on every weight")
    p.add_argument("--straggler-delay", type=float, default=0.0, metavar="S",
                   help="fault injection: max per-round straggler delay "
                        "in seconds (25%% of clients straggle)")
    p.add_argument("--fail-rounds", default="", metavar="R,R,...",
                   help="fault injection: comma-separated round indices "
                        "whose first attempt simulates a device loss "
                        "(exercises --max-round-retries)")
    p.add_argument("--arrival-delay", type=float, default=0.0, metavar="S",
                   help="fault injection: max base dispersion of upload "
                        "arrival times consumed by the streaming engine "
                        "(stragglers add their delay on top)")
    p.add_argument("--duplicate-clients", type=int, default=0, metavar="K",
                   help="fault injection: clients per round whose upload "
                        "is delivered twice (streaming dedups by nonce)")
    p.add_argument("--transient-clients", type=int, default=0, metavar="K",
                   help="fault injection: clients per round whose first "
                        "delivery is lost (recovered by streaming retries)")
    p.add_argument("--permanent-clients", type=int, default=0, metavar="K",
                   help="fault injection: clients per round for whom every "
                        "delivery fails (excluded as unreachable)")
    p.add_argument("--outage-hosts", type=int, default=0, metavar="K",
                   help="fault injection: host rows per round whose whole "
                        "contiguous client block is scheduled out (a "
                        "regional outage); requires --num-hosts H >= 2")
    p.add_argument("--link-loss", type=int, default=0, metavar="K",
                   help="fault injection: tier->root uplinks per round "
                        "whose first ship delivery is LOST (recovered by "
                        "ship retries); requires --num-hosts H >= 2")
    p.add_argument("--link-dark", type=int, default=0, metavar="K",
                   help="fault injection: tier->root uplinks per round "
                        "that lose EVERY ship delivery (the host misses "
                        "the round as host_unreachable); requires "
                        "--num-hosts H >= 2")
    p.add_argument("--link-delay", type=float, default=0.0, metavar="S",
                   help="fault injection: max per-uplink ship delivery "
                        "delay in simulated seconds (drawn per round; "
                        "gated by --ship-deadline); requires --num-hosts")
    p.add_argument("--link-dup", type=int, default=0, metavar="K",
                   help="fault injection: tier->root uplinks per round "
                        "whose ship is delivered TWICE (the root dedups "
                        "by (host, round, sha)); requires --num-hosts")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="PRNG seed of the fault schedule")
    p.add_argument("--serve", action="store_true",
                   help="recover-then-serve lifecycle: wrap the streaming "
                        "engine in a write-ahead round journal (default "
                        "path next to --checkpoint) and auto-resume from "
                        "an existing checkpoint — re-running the same "
                        "command after a crash recovers exactly")
    p.add_argument("--journal-path", default=None, metavar="PATH",
                   help="write-ahead round journal (fl.journal): every "
                        "engine transition is durable and a restarted "
                        "server replays it to the bitwise state of an "
                        "uninterrupted run; requires a streaming knob")
    p.add_argument("--fsync-policy", default=None,
                   choices=["always", "commit", "never"],
                   help="journal fsync policy: every append / transaction "
                        "boundaries (commit, degrade, round_close) / "
                        "OS-paced. Default: HEFL_JOURNAL_FSYNC, else "
                        "'commit'")
    p.add_argument("--crash-round", type=int, default=None, metavar="R",
                   help="crash injection: simulate a server process crash "
                        "during round R (requires the journal). Re-running "
                        "WITHOUT the crash flags always recovers; an armed "
                        "mid_append/pre_commit crash (whose record never "
                        "landed) fires again on every run")
    p.add_argument("--crash-at", default="post_fold", choices=list(CRASH_POINTS),
                   help="crash injection boundary: mid-journal-append "
                        "(leaves a REAL torn record), after the Nth fold, "
                        "before/after the commit record, or after the "
                        "round seals (before its checkpoint)")
    p.add_argument("--crash-after-folds", type=int, default=1, metavar="N",
                   help="which fold (1-based) triggers "
                        "mid_append/post_fold crashes")
    p.add_argument("--dp-min-surviving", type=int, default=0, metavar="K",
                   help="dp noise floor: calibrate each client's noise "
                        "share to K surviving clients (conservative "
                        "over-noising for partial participation; 0 = "
                        "full-participation calibration, auto-derived "
                        "from the schedule/quorum under faults/streaming)")
    p.add_argument("--max-round-retries", type=int, default=0,
                   help="retry a failed round this many times with "
                        "exponential backoff, auto-resuming from the "
                        "--checkpoint when one matches the round")
    p.add_argument("--retry-backoff", type=float, default=0.5, metavar="S",
                   help="base backoff between round retries (doubles per "
                        "attempt)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: CUDA; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p


def check_args(args: argparse.Namespace) -> None:
    """Refuse flag combinations that would be silently ignored, and values
    the port does not run, naming the flag (`hefl_tpu.cli`'s checks)."""
    if args.preset is not None and args.preset not in PRESETS:
        try:
            PRESETS[args.preset]
        except KeyError as exc:             # names the module an unported preset needs
            raise ValueError(f"--preset: {exc.args[0]}") from None
    if args.pack_bits <= 0 and (args.pack_interleave or args.pack_clip is not None):
        raise ValueError("--pack-interleave/--pack-clip have no effect without "
                         "--pack-bits; add --pack-bits B to enable packing")
    if args.hhe and args.pack_bits <= 0:
        raise ValueError("--hhe ships the PACKED quantized update under the stream "
                         "cipher; add --pack-bits B to enable packing")
    if args.hhe_key_seed and not args.hhe:
        raise ValueError("--hhe-key-seed has no effect without --hhe; add --hhe to "
                         "enable the hybrid-HE uplink")
    want_stream = _want_stream(args)
    if (args.arrival_delay > 0 or args.duplicate_clients > 0 or args.transient_clients > 0
            or args.permanent_clients > 0) and not want_stream:
        raise ValueError("--arrival-delay/--duplicate-clients/--transient-clients/"
                         "--permanent-clients are consumed by the streaming engine; "
                         "add --stream (or another streaming knob) to enable it")
    if (args.journal_path or args.serve) and not want_stream:
        raise ValueError("--journal-path/--serve wrap the streaming engine; add "
                         "--stream (or another streaming knob) to enable it")
    if args.crash_round is not None and not (args.journal_path or args.serve):
        raise ValueError("--crash-round without a write-ahead journal is just data "
                         "loss; add --journal-path PATH or --serve")
    if args.crash_round is None and (args.crash_at != "post_fold"
                                     or args.crash_after_folds != 1):
        raise ValueError("--crash-at/--crash-after-folds have no effect without "
                         "--crash-round R; add it to arm the crash injection")
    if args.dp_min_surviving > 0 and args.dp_noise <= 0:
        raise ValueError("--dp-min-surviving has no effect without --dp-noise; add "
                         "--dp-noise SIGMA to enable dp")
    if args.full_cohort_train and not want_stream:
        raise ValueError("--full-cohort-train has no effect without a streaming knob; "
                         "add --stream (or --cohort-size K) to enable the engine")
    if args.outage_hosts > 0 and args.num_hosts < 2:
        raise ValueError("--outage-hosts darkens host rows of the hierarchical "
                         "topology; add --num-hosts H (>= 2) to define the rows")
    if _link_faults(args) and args.num_hosts < 2:
        raise ValueError("--link-loss/--link-dark/--link-delay/--link-dup fault the "
                         "tier->root uplinks of the hierarchical topology; add "
                         "--num-hosts H (>= 2) to define the uplinks")
    if (args.host_quorum != 1.0 or args.ship_deadline > 0
            or args.host_staleness > 0) and args.num_hosts < 2:
        raise ValueError("--host-quorum/--ship-deadline/--host-staleness govern the "
                         "tier->root uplink of the hierarchical fold tree; add "
                         "--num-hosts H (>= 2) to define the tiers")
    if args.num_hosts == 1:
        raise ValueError("--num-hosts 1 is the flat single-root fold; use 0 (flat) or "
                         ">= 2 (hierarchical multi-host aggregation)")
    _packing_config(args)
    _fault_config(args)
    _stream_config(args)


def _want_stream(args: argparse.Namespace) -> bool:
    """Any streaming knob turns the streaming engine on (`hefl_tpu.cli`)."""
    return (args.stream or args.hhe or args.cohort_size > 0 or args.quorum < 1.0
            or args.deadline > 0 or args.staleness > 0 or args.stream_retries > 0
            or args.num_hosts > 0)


def _link_faults(args: argparse.Namespace) -> bool:
    return args.link_loss > 0 or args.link_dark > 0 or args.link_delay > 0 or args.link_dup > 0


def _stream_config(args: argparse.Namespace) -> StreamConfig | None:
    if not _want_stream(args):
        return None
    return StreamConfig(
        cohort_size=args.cohort_size,
        cohort_only=not args.full_cohort_train,
        quorum=args.quorum,
        deadline_s=args.deadline,
        max_retries=args.stream_retries,
        retry_backoff_s=args.stream_backoff,
        staleness_rounds=args.staleness,
        seed=args.stream_seed,
        num_hosts=args.num_hosts,
        host_quorum=args.host_quorum,
        ship_deadline_s=args.ship_deadline,
        host_staleness_rounds=args.host_staleness,
        upload_kind="hhe" if args.hhe else "ckks",
    )


def _fault_config(args: argparse.Namespace) -> FaultConfig | None:
    """The fault flags as a FaultConfig (None when no fault is set), as
    `hefl_tpu.cli` builds it: a straggler delay makes 25% of the clients
    straggle; the host rows are defined only for an outage or link fault."""
    fail_rounds = tuple(int(r) for r in args.fail_rounds.split(",") if r.strip())
    if not (args.drop_fraction > 0 or args.nan_clients > 0 or args.huge_clients > 0
            or args.straggler_delay > 0 or args.arrival_delay > 0
            or args.duplicate_clients > 0 or args.transient_clients > 0
            or args.permanent_clients > 0 or args.outage_hosts > 0 or _link_faults(args)
            or fail_rounds):
        return None
    return FaultConfig(
        seed=args.fault_seed,
        drop_fraction=args.drop_fraction,
        nan_clients=args.nan_clients,
        huge_clients=args.huge_clients,
        straggler_fraction=0.25 if args.straggler_delay > 0 else 0.0,
        straggler_delay_s=args.straggler_delay,
        fail_rounds=fail_rounds,
        arrival_delay_s=args.arrival_delay,
        duplicate_clients=args.duplicate_clients,
        transient_fail_clients=args.transient_clients,
        permanent_fail_clients=args.permanent_clients,
        outage_hosts=args.outage_hosts,
        link_loss_hosts=args.link_loss,
        link_dark_hosts=args.link_dark,
        link_delay_s=args.link_delay,
        link_dup_hosts=args.link_dup,
        num_hosts=args.num_hosts if (args.outage_hosts > 0 or _link_faults(args)) else 0,
    )


def _packing_config(args: argparse.Namespace) -> PackingConfig | None:
    if args.pack_bits <= 0:
        return None
    return PackingConfig(
        bits=args.pack_bits, interleave=args.pack_interleave,
        clip=0.5 if args.pack_clip is None else args.pack_clip,
    )


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    """The flags as an ExperimentConfig (`hefl_tpu.cli.config_from_args`
    over the ported flags); `--preset` yields PRESETS[name]."""
    if args.preset is not None:
        return PRESETS[args.preset]
    num_classes = (args.num_classes if args.num_classes is not None
                   else MODEL_REGISTRY[args.model][1])
    return ExperimentConfig(
        model=args.model,
        dataset=args.dataset,
        num_clients=args.num_clients,
        rounds=args.rounds,
        encrypted=not args.plaintext,
        partition=args.partition,
        skew_alpha=args.skew_alpha,
        train=TrainConfig(
            epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
            warmup_steps=args.warmup_steps, prox_mu=args.prox_mu,
            augment=not args.no_augment, num_classes=num_classes,
            client_fusion=args.client_fusion, on_overflow=args.on_overflow,
            max_update_norm=args.max_update_norm,
        ),
        he=HEConfig(n=args.he_n, num_primes=args.he_primes),
        packing=_packing_config(args),
        seed=args.seed,
        n_train=args.n_train,
        n_test=args.n_test,
        checkpoint_path=args.checkpoint,
        save_model_path=args.save_model,
        centralized=args.centralized,
        dp=(DpConfig(clip_norm=args.dp_clip, noise_multiplier=args.dp_noise,
                     delta=args.dp_delta, min_surviving=args.dp_min_surviving)
            if args.dp_noise > 0 else None),
        faults=_fault_config(args),
        stream=_stream_config(args),
        hhe=HheConfig(key_seed=args.hhe_key_seed) if args.hhe else None,
        journal_path=args.journal_path,
        fsync_policy=args.fsync_policy,
        serve=args.serve,
        crash=(CrashConfig(round=args.crash_round, at=args.crash_at,
                           after_folds=args.crash_after_folds)
               if args.crash_round is not None else None),
        max_round_retries=args.max_round_retries,
        retry_backoff_s=args.retry_backoff,
        events_path=args.events,
        span_trace_path=args.span_trace,
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


def run(args: argparse.Namespace, verbose: bool = True) -> list[dict]:
    """Run the configured experiment -> one record per round."""
    check_args(args)
    out = run_experiment(config_from_args(args), resume=args.resume, verbose=verbose,
                         device=args.device)
    return out["history"]


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    history = run(args, verbose=not args.json)
    if args.json:
        for rec in history:
            print(json.dumps(rec, default=lambda o: np.asarray(o).tolist()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
