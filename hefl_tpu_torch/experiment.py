"""Experiment orchestration: the multi-round federated training loop.

Counterpart of `hefl_tpu.experiment`: `ExperimentConfig` (the same fields
and defaults) and `run_experiment`, which runs R rounds with the same phase
structure and round record — keygen, train every client, encrypt, sum the
ciphertexts mod p, the owner's decrypt, evaluate — over an IID or
label-skew partition, with encrypted (float or packed) rounds, plaintext
FedAvg rounds, the centralized baseline, the streaming fold (full cohort,
quorum 1.0; CKKS or hybrid-HE uploads), a checkpoint after every round,
resume, retries with backoff, and the final model artifact.

Robust and private rounds: a fault schedule (`faults`, `fl.faults`) drops
clients, poisons others with NaN or +1e15 weights, delays stragglers and
loses the device on a round's first attempt; the sanitizing knobs
(`train.max_update_norm`, `train.on_overflow="exclude"`) exclude diverged
or poisoned uploads; `dp` (`fl.dp`) clips each client's delta and adds its
noise share before encryption, and every round records the epsilon spent.
Such rounds run on the masked engine and record `robust` (participation,
surviving, excluded by cause, retries, the injected faults).

Randomness: the model starts from the registry's seed-0 initialization
(as the JAX driver's `create_model` default), and one CPU `torch.Generator`
seeded with `cfg.seed` draws the keys, then one seed a round; a round's
generator is rebuilt from that seed on every attempt, so a retried round
draws what the first attempt drew. The round checkpoint stores the
generator's state, so a resumed run continues the uninterrupted one's
stream.

A field that needs a module the port does not have yet is refused by name,
with the ROADMAP item that ports it; so is a `TrainConfig` knob the port
does not run away from its default. One default differs without a field
to refuse: with `events_path=None` and a `checkpoint_path`, the JAX driver
writes `events.jsonl` next to the checkpoint, and the port, which has no
event log yet (ROADMAP M12), writes none and says so once a run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from hefl_tpu_torch import resolve_device
from hefl_tpu_torch.analysis import ranges
from hefl_tpu_torch.ckks import quantize
from hefl_tpu_torch.ckks.keys import CkksContext, keygen
from hefl_tpu_torch.ckks.packing import PackedSpec, PackSpec
from hefl_tpu_torch.data.partition import iid_contiguous, label_skew, stack_federated
from hefl_tpu_torch.data.synthetic import make_dataset
from hefl_tpu_torch.fl.client import train_batch_geometry, train_centralized
from hefl_tpu_torch.fl.config import HheConfig, PackingConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.dp import DpConfig, epsilon_spent
from hefl_tpu_torch.fl.faults import (
    POISON_HUGE,
    POISON_NAN,
    DeviceLost,
    FaultConfig,
    schedule_for_round,
)
from hefl_tpu_torch.fl.fedavg import evaluate, fedavg_round, masked_mode
from hefl_tpu_torch.fl.fusion import fusion_report, resolve_fusion_backend
from hefl_tpu_torch.fl.secure import decrypt_average, secure_fedavg_round
from hefl_tpu_torch.fl.stream import StreamEngine
from hefl_tpu_torch.hhe.cipher import hhe_bytes_on_wire_record
from hefl_tpu_torch.models import count_params, create_model
from hefl_tpu_torch.utils import PhaseTimer, load_checkpoint, save_checkpoint, save_params


@dataclasses.dataclass(frozen=True)
class HEConfig:
    """CKKS parameters (the reference's `gen_pk(s=128, m=1024)` knobs)."""

    n: int = 4096
    num_primes: int = 3
    prime_bits: int = 27
    scale: float = 2.0**30
    sigma: float = 3.2

    def build(self) -> CkksContext:
        return CkksContext.create(
            n=self.n, num_primes=self.num_primes, prime_bits=self.prime_bits,
            scale=self.scale, sigma=self.sigma,
        )


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Everything notebook cells 0-3 hard-code, as one declarative config:
    the JAX package's fields and defaults (see `hefl_tpu.experiment` for
    each field's meaning). The fields typed `Any` hold configs of modules
    the port does not have yet and must stay None (`run_experiment`).

    dp: DP-FedAvg (`fl.dp.DpConfig`) on the encrypted rounds. faults: the
    fault schedule (`fl.faults.FaultConfig`) of the synchronous rounds."""

    model: str = "medcnn"
    dataset: str = "medical"
    data_dir: str | None = None
    image_size: tuple[int, int] = (256, 256)
    num_clients: int = 2
    rounds: int = 1
    encrypted: bool = True
    partition: str = "iid"            # "iid" (reference) | "label_skew"
    skew_alpha: float = 0.5
    train: TrainConfig = TrainConfig()
    he: HEConfig = HEConfig()
    seed: int = 0
    n_train: int | None = None        # dataset-size overrides (None = spec default)
    n_test: int | None = None
    checkpoint_path: str | None = None
    exact_final_decode: bool = False
    profile_dir: str | None = None
    save_model_path: str | None = None
    centralized: bool = False
    dp: DpConfig | None = None
    faults: FaultConfig | None = None
    stream: StreamConfig | None = None
    max_round_retries: int = 0
    retry_backoff_s: float = 0.5
    packing: PackingConfig | None = None
    events_path: str | None = None
    span_trace_path: str | None = None
    journal_path: str | None = None
    fsync_policy: str | None = None
    serve: bool = False
    crash: Any = None
    hhe: HheConfig | None = None
    mesh_ct: int = 0


def _partition(cfg: ExperimentConfig, y: np.ndarray) -> list[np.ndarray]:
    if cfg.partition == "iid":
        return iid_contiguous(len(y), cfg.num_clients)
    if cfg.partition == "label_skew":
        return label_skew(y, cfg.num_clients, alpha=cfg.skew_alpha, seed=cfg.seed)
    raise ValueError(f"unknown partition {cfg.partition!r}")


def check_config(cfg: ExperimentConfig) -> None:
    """The JAX driver's configuration checks, then a refusal, by name, of
    every field whose module the port does not have yet."""
    packing_on = cfg.packing is not None and cfg.packing.enabled
    if cfg.dp is not None and (not cfg.encrypted or cfg.centralized):
        raise ValueError(
            "dp is only applied on the encrypted federated path; remove "
            "--plaintext/--centralized or drop the dp config"
        )
    if cfg.faults is not None and cfg.centralized:
        raise ValueError(
            "fault injection targets the federated round loop; remove "
            "--centralized or drop the faults config"
        )
    if packing_on and (not cfg.encrypted or cfg.centralized):
        raise ValueError(
            "packing quantizes the CKKS upload; remove "
            "--plaintext/--centralized or drop the packing config"
        )
    if cfg.stream is not None and (not cfg.encrypted or cfg.centralized):
        raise ValueError(
            "streaming quorum aggregation runs on the encrypted federated "
            "path; remove --plaintext/--centralized or drop the stream config"
        )
    if (cfg.journal_path or cfg.serve) and cfg.stream is None:
        raise ValueError(
            "the durable aggregation journal/--serve wraps the streaming "
            "engine; add a stream config (--stream) or drop journal_path/serve"
        )
    if cfg.crash is not None and not (cfg.journal_path or cfg.serve):
        raise ValueError(
            "crash injection without a write-ahead journal is just data "
            "loss; add journal_path (--journal-path) or serve (--serve)"
        )
    ef_on = packing_on and cfg.packing.error_feedback
    if ef_on and cfg.stream is None:
        raise ValueError(
            "PackingConfig.error_feedback requires the streaming engine's "
            "cross-round residual state; add a stream config (--stream) "
            "or drop error_feedback"
        )
    if ef_on and cfg.dp is not None:
        raise ValueError(
            "dp cannot be combined with error-feedback packing: the residual "
            "gives a client cross-round influence the per-round sensitivity "
            "accounting does not cover — drop error_feedback for dp runs"
        )
    hhe_on = cfg.stream is not None and cfg.stream.upload_kind == "hhe"
    if hhe_on and not packing_on:
        raise ValueError(
            "upload_kind=hhe ships the packed quantized update under the "
            "stream cipher; add a PackingConfig (--pack-bits) or use "
            "upload_kind=ckks"
        )
    if cfg.hhe is not None and not hhe_on:
        raise ValueError(
            "an HheConfig is set but the stream upload_kind is not 'hhe'; "
            "set StreamConfig(upload_kind='hhe') (--hhe) or drop the hhe config"
        )
    if cfg.dp is not None and cfg.stream is not None and (
            cfg.stream.staleness_rounds > 0 or cfg.stream.host_staleness_rounds > 0):
        raise ValueError(
            "dp cannot be combined with a staleness budget: set "
            "StreamConfig.staleness_rounds=0 and host_staleness_rounds=0 for dp runs"
        )
    unported = [
        ("dp with a stream config", cfg.dp is not None and cfg.stream is not None,
         "M12, the streaming engine's dp floor"),
        ("faults with a stream config", cfg.faults is not None and cfg.stream is not None,
         "M12, the streaming engine's arrival faults"),
        ("journal_path", cfg.journal_path is not None, "M12, fl/journal.py"),
        ("fsync_policy", cfg.fsync_policy is not None, "M12, fl/journal.py"),
        ("serve", cfg.serve, "M12, fl/server.py"),
        ("crash", cfg.crash is not None, "M12, fl/faults.py CrashConfig"),
        ("span_trace_path", cfg.span_trace_path is not None, "M12, obs/spans.py"),
        ("events_path", bool(cfg.events_path), "M12, obs/events.py"),
        ("data_dir", cfg.data_dir is not None, "Queue 1, data/folder.py"),
        ("exact_final_decode", cfg.exact_final_decode, "M14, native/crt.cpp"),
        ("profile_dir", cfg.profile_dir is not None, "M15, the profiler trace of a round"),
        ("mesh_ct", cfg.mesh_ct > 1, "one GPU runs no 2-D round mesh"),
    ]
    for name, is_set, where in unported:
        if is_set:
            raise ValueError(
                f"ExperimentConfig.{name} is not ported to hefl_tpu_torch yet "
                f"(ROADMAP: {where}); drop it"
            )


def _preflight(cfg: ExperimentConfig, ctx: CkksContext, say) -> None:
    """The packed and hybrid-HE certificates the JAX driver's pre-flight
    (`analysis.check_experiment`) runs before any training work."""
    packing = cfg.packing
    if packing is None or not packing.enabled:
        return
    modulus = int(ctx.modulus)
    k = packing.interleave or quantize.max_interleave(
        modulus, packing.bits, cfg.num_clients, packing.guard_bits)
    certs = [ranges.certify_packing(modulus, packing.bits, k, cfg.num_clients,
                                    packing.guard_bits)]
    if cfg.stream is not None and cfg.stream.upload_kind == "hhe":
        certs.append(ranges.certify_transciphering(modulus, packing.bits, k, cfg.num_clients,
                                                   packing.guard_bits))
    for cert in certs:
        if not cert.ok:
            raise ValueError(f"static analysis rejected this configuration — {cert.summary()}")
    say(f"analysis: {'; '.join(c.summary() for c in certs)}")


def _phase_stats(seconds: float, images: int | None = None) -> dict:
    """One phase's roofline record in the JAX schema; `flops` and `mfu` stay
    None until the roofline with the card's peaks is ported (M15)."""
    return {
        "seconds": round(seconds, 6),
        "flops": None,
        "mfu": None,
        "images_per_s": round(images / seconds, 2) if (images and seconds) else None,
    }


def _train_images(cfg: TrainConfig, n_samples: int, num_clients: int) -> int:
    """Images one round's training steps process (0 for a client too small
    to train)."""
    _, grp, steps = train_batch_geometry(cfg, int(n_samples))
    return num_clients * cfg.epochs * steps * grp


def _round_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (1,), generator=gen).item())


def run_experiment(
    cfg: ExperimentConfig, resume: bool = False, verbose: bool = True, device=None
) -> dict[str, Any]:
    """Run R federated rounds on `device` (CUDA unless given) ->
    {history, final_metrics, params, augment_backend, client_fusion,
    he_backend, packing, stream, mesh, hhe} (a centralized run: history,
    final_metrics, params and None for packing, stream and hhe).

    `history[r]` = {round, phases (seconds per phase), phase_roofline,
    val_loss and val_acc (per client), accuracy, precision, recall, f1,
    encode_overflow (per client, encrypted runs), packing / stream / robust
    / hhe where on} — the JAX record's keys.
    """
    say = print if verbose else (lambda *_: None)
    check_config(cfg)
    device = resolve_device(device)
    if cfg.checkpoint_path and cfg.events_path is None:
        say("note: no events.jsonl beside the checkpoint (the JAX driver's default); "
            "the event log is not ported yet (ROADMAP M12)")
    hhe_on = cfg.stream is not None and cfg.stream.upload_kind == "hhe"
    # DP under partial participation: each share is calibrated to the
    # surviving-cohort floor (`fl.dp`). With faults on and no floor
    # declared, derive the schedule's worst-case surviving count; the round
    # still fails loudly if it survives below it.
    dp_cfg = cfg.dp
    if dp_cfg is not None and dp_cfg.min_surviving <= 0 and cfg.faults is not None:
        floor = max(1, cfg.num_clients - cfg.faults.max_scheduled_exclusions(cfg.num_clients))
        dp_cfg = dataclasses.replace(dp_cfg, min_surviving=floor)
    if cfg.dp is not None and dp_cfg.min_surviving != cfg.dp.min_surviving:
        say(f"dp: noise shares recalibrated to a surviving-cohort floor of "
            f"{dp_cfg.min_surviving}/{cfg.num_clients} clients (conservative over-noising; "
            "effective noise never below the full-participation calibration)")
    train_cfg = cfg.train
    (x, y), (xt, yt), _ = make_dataset(
        cfg.dataset, seed=cfg.seed, n_train=cfg.n_train, n_test=cfg.n_test
    )
    xt_d = torch.from_numpy(xt).to(device)
    model = create_model(cfg.model, num_classes=train_cfg.num_classes,
                         input_shape=tuple(int(d) for d in x.shape[1:]), device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    gen = torch.Generator().manual_seed(cfg.seed)

    if cfg.centralized:
        timer = PhaseTimer(device)
        round_gen = torch.Generator().manual_seed(_round_seed(gen))
        with timer.phase("train"):
            params, metrics = train_centralized(
                model, train_cfg, params, torch.from_numpy(x).to(device),
                torch.from_numpy(y).to(device), gen=round_gen,
            )
        with timer.phase("evaluate"):
            results = evaluate(model, params, xt_d, yt)
        phases = timer.summary()
        record = {
            "round": 0,
            "phases": phases,
            "phase_roofline": {
                "train": _phase_stats(phases["train"], _train_images(train_cfg, len(x), 1)),
                "evaluate": _phase_stats(phases["evaluate"], len(xt)),
            },
            "val_loss": [float(metrics[-1, 0])],
            "val_acc": [float(metrics[-1, 1])],
            **{k: float(results[k]) for k in ("accuracy", "precision", "recall", "f1")},
        }
        say(f"centralized: acc {record['accuracy']:.4f} f1 {record['f1']:.4f} ({timer})")
        if cfg.save_model_path:
            save_params(cfg.save_model_path, params)
            say(f"saved model to {cfg.save_model_path}")
        return {"history": [record], "final_metrics": record, "params": params,
                "packing": None, "stream": None, "hhe": None}

    xs, ys = stack_federated(x, y, _partition(cfg, y))
    xs_d, ys_d = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    # The training backend, resolved once a run ("auto" times both on the
    # device here) and pinned for every round.
    train_cfg = dataclasses.replace(train_cfg, client_fusion=resolve_fusion_backend(
        train_cfg.client_fusion, model, device))

    ctx = sk = pk = spec = pspec = None
    if cfg.encrypted:
        ctx = cfg.he.build()
        _preflight(cfg, ctx, say)
        sk, pk = keygen(ctx, gen, device=device)
        spec = PackSpec.for_params(params, ctx.n)
        say(f"CKKS context: N={ctx.n} L={ctx.num_primes} -> {spec.n_ct} ciphertexts "
            f"for {count_params(params):,} params on {device}")
        if cfg.packing is not None and cfg.packing.enabled:
            pspec = PackedSpec.for_params(params, ctx, cfg.packing, cfg.num_clients)
            say(f"packing: b={pspec.bits} k={pspec.k} (guard {pspec.guard}, clip "
                f"{pspec.clip}) -> {pspec.n_ct} packed ciphertexts "
                f"({spec.n_ct / pspec.n_ct:.1f}x fewer), error budget {pspec.error_budget:.2e}")

    start_round = 0
    if resume:
        if not cfg.checkpoint_path:
            raise ValueError("resume=True requires checkpoint_path")
        params, start_round, state, _ = load_checkpoint(cfg.checkpoint_path, params)
        gen.set_state(state)
        say(f"resumed from {cfg.checkpoint_path} at round {start_round}")

    train_phase = "train+encrypt+aggregate" if cfg.encrypted else "train+aggregate"
    train_images = _train_images(train_cfg, int(xs.shape[1]), cfg.num_clients)
    engine = StreamEngine(cfg.stream) if cfg.stream is not None else None
    # The masked engine (fault schedule or sanitizing knobs) returns a
    # RoundMeta a round: the same predicate the round functions use for
    # their return arity.
    robust = masked_mode(train_cfg, cfg.num_clients, 1, explicit=cfg.faults is not None,
                         secure=cfg.encrypted)
    history: list[dict[str, Any]] = []
    for r in range(start_round, cfg.rounds):
        sched = (schedule_for_round(cfg.faults, r, cfg.num_clients)
                 if cfg.faults is not None else None)
        part = sched.participation() if sched is not None else None
        pois = sched.poison if sched is not None else None
        straggler_s = float(np.max(sched.straggler_s)) if sched is not None else 0.0
        k_round = _round_seed(gen)
        attempt = 0
        while True:
            # A round whose execution dies (a device or runtime error, or a
            # scheduled DeviceLost) is retried with exponential backoff, from
            # the round checkpoint's (params, generator) when it holds this
            # round's entry state, else as-is; a retried round redraws its
            # first attempt's randomness. Configuration errors
            # (ValueError/TypeError) are never retried.
            try:
                if sched is not None and sched.device_loss and attempt == 0:
                    raise DeviceLost(f"fault injection: scheduled device loss at round {r}")
                timer = PhaseTimer(device)
                round_gen = torch.Generator().manual_seed(k_round)
                meta = smeta = None
                if cfg.encrypted:
                    with timer.phase(train_phase):
                        if engine is not None:
                            ct_sum, metrics, overflow, smeta = engine.run_round(
                                model, train_cfg, ctx, pk, params, xs_d, ys_d, round_gen, r,
                                packing=pspec, hhe=cfg.hhe,
                            )
                            meta = smeta.meta
                        elif robust:
                            ct_sum, metrics, overflow, meta = secure_fedavg_round(
                                model, train_cfg, ctx, pk, params, xs_d, ys_d, round_gen,
                                packing=pspec, dp=dp_cfg, participation=part, poison=pois,
                            )
                        else:
                            ct_sum, metrics, overflow = secure_fedavg_round(
                                model, train_cfg, ctx, pk, params, xs_d, ys_d, round_gen,
                                packing=pspec, dp=dp_cfg,
                            )
                        _straggler_wait(straggler_s, device)
                    with timer.phase("decrypt"):
                        if meta is not None and meta.surviving == 0:
                            # Nobody made the round: the sum is an encryption
                            # of zero. Keep the global model, as the plaintext
                            # masked mean does.
                            say(f"round {r}: every client excluded ({meta.excluded}); "
                                "keeping previous global model")
                            new_params = params
                        else:
                            new_params = decrypt_average(
                                ctx, sk, ct_sum, cfg.num_clients, spec, meta=meta,
                                packing=pspec, base_params=params, hhe=hhe_on,
                            )
                else:
                    overflow = None
                    with timer.phase(train_phase):
                        if robust:
                            new_params, metrics, meta = fedavg_round(
                                model, train_cfg, params, xs_d, ys_d, round_gen,
                                participation=part, poison=pois)
                        else:
                            new_params, metrics = fedavg_round(
                                model, train_cfg, params, xs_d, ys_d, round_gen)
                        _straggler_wait(straggler_s, device)
                params = new_params
                break
            except RuntimeError as e:
                if attempt >= cfg.max_round_retries:
                    raise
                backoff = cfg.retry_backoff_s * (2**attempt)
                attempt += 1
                say(f"round {r} failed ({type(e).__name__}: {e}); "
                    f"retry {attempt}/{cfg.max_round_retries} in {backoff:.1f}s")
                time.sleep(backoff)
                ck = None
                if cfg.checkpoint_path:
                    with contextlib.suppress(FileNotFoundError):
                        ck = load_checkpoint(cfg.checkpoint_path, params)
                if ck is not None:
                    ck_params, ck_round, ck_state, _ = ck
                    if ck_round == r:
                        params = ck_params
                        gen.set_state(ck_state)
                        k_round = _round_seed(gen)
                        say(f"auto-resumed round-{r} state from {cfg.checkpoint_path}")
        with timer.phase("evaluate"):
            results = evaluate(model, params, xt_d, yt)
        phases = timer.summary()
        mets = metrics.numpy()
        record: dict[str, Any] = {
            "round": r,
            **({"dp_epsilon": epsilon_spent(r + 1, dp_cfg.noise_multiplier, dp_cfg.delta)}
               if cfg.dp is not None else {}),
            "phases": phases,
            "phase_roofline": {
                train_phase: _phase_stats(phases[train_phase], train_images),
                **({"decrypt": _phase_stats(phases["decrypt"])} if cfg.encrypted else {}),
                "evaluate": _phase_stats(phases["evaluate"], len(xt)),
            },
            "val_loss": mets[:, -1, 0].tolist(),
            "val_acc": mets[:, -1, 1].tolist(),
            **{k: float(results[k]) for k in ("accuracy", "precision", "recall", "f1")},
        }
        if cfg.encrypted:
            record["encode_overflow"] = overflow.cpu().tolist()
            overflow_total = int(overflow.sum())
            if overflow_total > 0:
                # Under packing the same slot counts quantizer saturation
                # (|update| > clip) instead of encoder saturation.
                envelope, remedy = (
                    ("quantizer clip", "raise packing.clip") if pspec is not None
                    else ("CKKS encode envelope", "lower he.scale")
                )
                if train_cfg.on_overflow == "raise":
                    raise RuntimeError(
                        f"round {r}: {overflow_total} weights saturated the {envelope} "
                        f"and on_overflow='raise' — {remedy} or switch to "
                        "on_overflow='exclude'"
                    )
                if meta is not None and meta.excluded.get("overflow", 0) > 0:
                    say(f"round {r}: excluded {meta.excluded['overflow']} client(s) whose "
                        f"updates saturated the {envelope}")
                else:
                    say(f"WARNING: round {r} clipped {overflow_total} weights at the "
                        f"{envelope}; {remedy}")
        if pspec is not None:
            record["packing"] = pspec.geometry_record()
        if smeta is not None:
            record["stream"] = smeta.record()
        if meta is not None:
            # The round's robustness record: the participation mask applied,
            # the surviving count (the decode denominator), exclusions by
            # cause, retries, and the injected faults.
            rob: dict[str, Any] = {**meta.record(), "round_retries": attempt}
            if sched is not None:
                rob["faults"] = {
                    "dropped": np.flatnonzero(sched.dropped).tolist(),
                    "nan": np.flatnonzero(sched.poison == POISON_NAN).tolist(),
                    "huge": np.flatnonzero(sched.poison == POISON_HUGE).tolist(),
                    "straggler_s": round(straggler_s, 4),
                    "device_loss": bool(sched.device_loss),
                }
            record["robust"] = rob
        if hhe_on:
            record["hhe"] = _hhe_record(cfg, pspec, ctx)
        history.append(record)
        say(f"round {r}: acc {record['accuracy']:.4f} f1 {record['f1']:.4f} "
            + (f"dp_eps {record['dp_epsilon']:.2f} " if "dp_epsilon" in record else "")
            + (f"surviving {meta.surviving}/{meta.num_clients} " if meta is not None else "")
            + f"({timer})")
        if cfg.checkpoint_path:
            save_checkpoint(cfg.checkpoint_path, params, r + 1, gen,
                            meta={"model": cfg.model, "dataset": cfg.dataset,
                                  "num_clients": cfg.num_clients})

    if cfg.save_model_path:
        save_params(cfg.save_model_path, params)
        say(f"saved aggregated model to {cfg.save_model_path}")
    return {
        "history": history,
        "final_metrics": history[-1] if history else None,
        "params": params,
        # The records of what this run ran, with the JAX driver's keys: the
        # augment warp, the client-training backend, the HE kernels (the
        # CUDA kernels on a card, their plain versions on the CPU) and the
        # round topology (one device).
        "augment_backend": {"requested": "gather", "backend": "gather",
                            "auto_timings_ms": None, "auto_persisted": False},
        "client_fusion": fusion_report(),
        "he_backend": {"requested": "auto", "backend": "cuda" if device.type == "cuda" else "plain",
                       "auto_timings_ms": None, "auto_persisted": False},
        "packing": pspec.geometry_record() if pspec is not None else None,
        "stream": dataclasses.asdict(cfg.stream) if cfg.stream is not None else None,
        "mesh": {"axes": ["clients"], "clients": 1, "ct": 1},
        "hhe": _hhe_record(cfg, pspec, ctx) if hhe_on else None,
    }


def _straggler_wait(seconds: float, device) -> None:
    """The synchronous round waits for its slowest scheduled straggler: the
    device's work first, then the scheduled delay, inside the timed phase
    (as a real straggler would show in the round's wall time)."""
    if seconds > 0:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        time.sleep(seconds)


def _hhe_record(cfg: ExperimentConfig, pspec: PackedSpec, ctx: CkksContext) -> dict:
    """Key seed and the hybrid-HE wire story (`expansion_hhe`, the <= 1.1x
    gate, and the packed CKKS ciphertext the upload replaces)."""
    return {"key_seed": (cfg.hhe or HheConfig()).key_seed,
            **hhe_bytes_on_wire_record(pspec, ctx.num_primes)}
