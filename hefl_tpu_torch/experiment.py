"""Experiment orchestration: the multi-round federated training loop.

Counterpart of `hefl_tpu.experiment`: `ExperimentConfig` (the same fields
and defaults) and `run_experiment`, which runs R rounds with the same phase
structure and round record — keygen, train every client, encrypt, sum the
ciphertexts mod p, the owner's decrypt, evaluate — over an IID or
label-skew partition, with encrypted (float or packed) rounds, plaintext
FedAvg rounds, the centralized baseline, the streaming quorum engine
(`fl.stream`: sampled cohorts, quorum and deadlines, retries, bounded
staleness, CKKS or hybrid-HE uploads, with faults and DP), the durable
aggregation service (`fl.server`: a write-ahead journal, crash injection
and recovery, `serve`), a checkpoint after every round, resume, retries
with backoff, and the final model artifact.

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

Observability (`obs`): the run's events go to `events.jsonl` beside the
checkpoint (`events_path=""` or HEFL_EVENTS=0 disables), the metrics
registry's per-run delta is returned under `obs`, and a streaming run can
export its rounds' span trees (`span_trace_path`).

A journaled run (`journal_path` or `serve`) trains under
`torch.use_deterministic_algorithms(True)` (cuDNN deterministic, no
benchmarking, CUBLAS_WORKSPACE_CONFIG set): journal replay re-derives every
upload and holds it to the journaled content hash, which needs training
that is bitwise repeatable on the card.

Input: the synthetic datasets (`dataset`), or a reference-layout image
folder (`data_dir`, decoded at `image_size` by `data.folder`), whose class
count replaces `train.num_classes`. Either is copied to the device once.

Round topology: with no process group the run is one client block on one
device (`mesh_ct` > 1 then runs the 1-D round, which the JAX package's 2-D
round equals bit for bit; the `mesh` record names the two axes, ct of size
1). In a process group (one rank a GPU, `parallel.init_mesh`, e.g. under
`torchrun`) the rounds run on the mesh of the world's ranks: the 1-D
client mesh (`parallel.make_mesh`), or with `mesh_ct` > 1 the 2-D
("clients", "ct") mesh (`parallel.make_mesh_2d`), whose ct ranks of a
client row train the row's block and split its encrypt rows. Every rank
builds the same dataset from the seed on the host and stages only the
rows it trains on its card (`data.RoundPrefetcher`: its block of the
padded registry, or of each streaming round's cohort bucket, the next
round's copied while the current one runs); rank 0, the model owner,
generates the keys (the public key and the generator's state are
broadcast), holds the secret key and the journal, decrypts and broadcasts
the new global parameters, and alone evaluates, prints, keeps the history
and writes files. A streaming run's engine runs on every rank
(`fl.stream`). Ranks past the mesh return at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from hefl_tpu_torch import resolve_device
from hefl_tpu_torch import analysis
from hefl_tpu_torch.ckks.backend import he_backend_report
from hefl_tpu_torch.ckks.keys import CkksContext, keygen
from hefl_tpu_torch.ckks.packing import PackedSpec, PackSpec
from hefl_tpu_torch.data.folder import load_folder_splits
from hefl_tpu_torch.data.partition import iid_contiguous, label_skew, stack_federated
from hefl_tpu_torch.data.synthetic import make_dataset
from hefl_tpu_torch.fl.client import train_batch_geometry, train_centralized
from hefl_tpu_torch.fl.config import HheConfig, PackingConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.dp import DpConfig, epsilon_spent
from hefl_tpu_torch.fl.faults import (
    POISON_HUGE,
    POISON_NAN,
    CrashConfig,
    DeviceLost,
    FaultConfig,
    SimulatedCrash,
    record_round_meta,
    schedule_for_round,
)
from hefl_tpu_torch.data.prefetch import RoundPrefetcher
from hefl_tpu_torch.fl.fedavg import (
    client_block,
    evaluate,
    fedavg_round,
    masked_mode,
    pad_index,
    replicate_on,
)
from hefl_tpu_torch.fl.fusion import fusion_report, resolve_fusion_backend
from hefl_tpu_torch.fl.secure import decrypt_average, secure_fedavg_round
from hefl_tpu_torch.fl.journal import JournalError
from hefl_tpu_torch.fl.server import AggregationServer
from hefl_tpu_torch.fl.stream import StreamEngine, quorum_count, round_rows, sample_cohort
from hefl_tpu_torch.hhe.cipher import hhe_bytes_on_wire_record
from hefl_tpu_torch.models import count_params, create_model
from hefl_tpu_torch.obs import events as obs_events
from hefl_tpu_torch.obs import metrics as obs_metrics
from hefl_tpu_torch.obs import scopes as obs_scopes
from hefl_tpu_torch.obs import spans as obs_spans
from hefl_tpu_torch.obs import trace as obs_trace
from hefl_tpu_torch.parallel import client_mesh_size, make_mesh, make_mesh_2d
from hefl_tpu_torch.utils import PhaseTimer, load_checkpoint, roofline, save_checkpoint, save_params
from hefl_tpu_torch.utils.checkpoint import npz_path


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
    each field's meaning).

    dp: DP-FedAvg (`fl.dp.DpConfig`) on the encrypted rounds. faults: the
    fault schedule (`fl.faults.FaultConfig`). stream: the streaming engine
    (`fl.config.StreamConfig`). journal_path / fsync_policy / serve /
    crash (`fl.faults.CrashConfig`): the durable aggregation service."""

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
    crash: CrashConfig | None = None
    hhe: HheConfig | None = None
    mesh_ct: int = 0


def _partition(cfg: ExperimentConfig, y: np.ndarray) -> list[np.ndarray]:
    if cfg.partition == "iid":
        return iid_contiguous(len(y), cfg.num_clients)
    if cfg.partition == "label_skew":
        return label_skew(y, cfg.num_clients, alpha=cfg.skew_alpha, seed=cfg.seed)
    raise ValueError(f"unknown partition {cfg.partition!r}")


def check_config(cfg: ExperimentConfig) -> None:
    """The JAX driver's configuration checks."""
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
    if cfg.dp is not None and cfg.stream is not None and cfg.stream.staleness_rounds > 0:
        raise ValueError(
            "dp cannot be combined with a staleness budget: set "
            "StreamConfig.staleness_rounds=0 for dp runs (a carried "
            "upload would double a client's accounted sensitivity)"
        )
    if cfg.dp is not None and cfg.stream is not None and cfg.stream.host_staleness_rounds > 0:
        raise ValueError(
            "dp cannot be combined with a tier staleness budget: set "
            "StreamConfig.host_staleness_rounds=0 for dp runs (a carried "
            "host partial would double its clients' accounted sensitivity)"
        )


def _train_images(cfg: TrainConfig, n_samples: int, num_clients: int) -> int:
    """Images one round's training steps process (0 for a client too small
    to train)."""
    _, grp, steps = train_batch_geometry(cfg, int(n_samples))
    return num_clients * cfg.epochs * steps * grp


def _train_flops(model, cfg: TrainConfig, sample_shape, n_samples: int,
                 num_clients: int) -> float | None:
    """One round's train FLOPs (the JAX driver's `_train_roofline_inputs`):
    one batch's forward (`roofline.model_flops`, FlopCounterMode's conv and
    matmul count) x 3 (forward + backward) x steps x epochs x clients, the
    batch geometry `train_batch_geometry`'s, as training runs it. None for
    a client too small to train."""
    _, grp, steps = train_batch_geometry(cfg, int(n_samples))
    if grp < 1:
        return None
    fwd = roofline.model_flops(model, (grp, *sample_shape))
    return roofline.train_flops_per_round(fwd, steps, cfg.epochs, num_clients)


def _round_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (1,), generator=gen).item())


def _record_round_obs(r: int, phases: dict, device) -> None:
    """Per-round observability: phase gauges + round_phase events, the
    rounds.completed counter, and the device-memory high-water mark."""
    for ph, sec in phases.items():
        if ph == "total":
            continue
        obs_metrics.gauge(f"phase_seconds.{ph}").set(sec)
        obs_events.emit("round_phase", round=r, phase=ph, seconds=sec)
    obs_metrics.counter("rounds.completed").inc()
    obs_metrics.record_device_memory(device)


def _finish_run_obs(metrics_base: dict, rounds: int) -> dict:
    """End-of-run observability: the experiment_end event and THIS RUN's
    metrics (counters as deltas against the run-start baseline: the
    registry is process-global). -> the result's `obs` record."""
    run_metrics = obs_metrics.snapshot_delta(metrics_base)
    obs_events.emit("experiment_end", rounds=rounds, metrics=run_metrics)
    return {"events_path": obs_events.current_path(), "metrics": run_metrics}


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True):
    """During the block, PyTorch runs only deterministic kernels
    (`torch.use_deterministic_algorithms`, cuDNN deterministic and not
    benchmarking; CUBLAS_WORKSPACE_CONFIG ":4096:8" where it is unset):
    what journal replay needs to re-derive bitwise the uploads it holds to
    the journaled content hashes. The previous settings, the variable's
    too, return after."""
    if not on:
        yield
        return
    prev_workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[1:]
        if prev_workspace is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def run_experiment(
    cfg: ExperimentConfig, resume: bool = False, verbose: bool = True, device=None
) -> dict[str, Any]:
    """Run R federated rounds on `device` (CUDA unless given) ->
    {history, final_metrics, params, augment_backend, client_fusion,
    he_backend, packing, stream, mesh, hhe, span_trace, journal, obs} (a
    centralized run: history, final_metrics, params, obs, and None for
    packing, stream and hhe).

    `history[r]` = {round, phases (seconds per phase), phase_roofline,
    val_loss and val_acc (per client), accuracy, precision, recall, f1,
    encode_overflow (per client, encrypted runs), packing / stream / robust
    / hhe / dp_epsilon where on} — the JAX record's keys.
    """
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if verbose and lead else (lambda *_: None)
    check_config(cfg)
    device = resolve_device(device)
    with deterministic_algorithms(bool(cfg.journal_path or cfg.serve)), \
            contextlib.ExitStack() as profiling:
        return _run(cfg, resume, say, device, profiling)


def _run(cfg: ExperimentConfig, resume: bool, say, device,
         profiling: contextlib.ExitStack) -> dict[str, Any]:
    hhe_on = cfg.stream is not None and cfg.stream.upload_kind == "hhe"
    # DP under partial participation: each share is calibrated to the
    # surviving-cohort floor (`fl.dp`). With faults or a stream on and no
    # floor declared, derive a conservative one: the quorum of the round's
    # cohort (a streaming commit holds at least that many uploads) or the
    # schedule's worst-case surviving count.
    dp_cfg = cfg.dp
    if dp_cfg is not None and dp_cfg.min_surviving <= 0 and (
            cfg.faults is not None or cfg.stream is not None):
        if cfg.stream is not None:
            floor = quorum_count(cfg.stream, len(sample_cohort(cfg.stream, 0, cfg.num_clients)))
        else:
            floor = max(1, cfg.num_clients
                        - cfg.faults.max_scheduled_exclusions(cfg.num_clients))
        dp_cfg = dataclasses.replace(dp_cfg, min_surviving=floor)
    # Observability: this run's events go to one JSONL file (events.jsonl
    # beside the checkpoint by default; events_path="" or HEFL_EVENTS=0
    # disables); metrics are reported as deltas against this baseline.
    metrics_base = obs_metrics.snapshot()
    ev_path = cfg.events_path
    if ev_path is None:
        ev_path = obs_events.default_events_path(cfg.checkpoint_path)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    obs_events.configure((ev_path or None) if lead else None)
    obs_events.emit(
        "experiment_start",
        model=cfg.model, dataset=cfg.dataset, num_clients=cfg.num_clients,
        rounds=cfg.rounds, encrypted=cfg.encrypted, centralized=cfg.centralized,
        faults=cfg.faults is not None, dp=cfg.dp is not None, seed=cfg.seed,
        stream=cfg.stream is not None, hhe=hhe_on,
        packing=({"bits": cfg.packing.bits, "interleave_configured": cfg.packing.interleave}
                 if cfg.packing is not None and cfg.packing.enabled else None),
    )
    if cfg.dp is not None and dp_cfg.min_surviving != cfg.dp.min_surviving:
        say(f"dp: noise shares recalibrated to a surviving-cohort floor of "
            f"{dp_cfg.min_surviving}/{cfg.num_clients} clients (conservative over-noising; "
            "effective noise never below the full-participation calibration)")
        obs_events.emit("dp_recalibrated", min_surviving=dp_cfg.min_surviving,
                        num_clients=cfg.num_clients)
    train_cfg = cfg.train
    if cfg.data_dir is not None:
        # The reference's own workflow: a folder of class-subdir images
        # (FLPyfhelin.py:38-55, the notebook's image/Train and image/Test).
        (x, y), (xt, yt), class_names = load_folder_splits(
            cfg.data_dir, image_size=cfg.image_size, seed=cfg.seed)
        say(f"data dir {cfg.data_dir}: classes {class_names}, train {x.shape}, test {xt.shape}")
        if train_cfg.num_classes != len(class_names):
            train_cfg = dataclasses.replace(train_cfg, num_classes=len(class_names))
    else:
        (x, y), (xt, yt), _ = make_dataset(
            cfg.dataset, seed=cfg.seed, n_train=cfg.n_train, n_test=cfg.n_test
        )
    xt_d = torch.from_numpy(xt).to(device)
    model = create_model(cfg.model, num_classes=train_cfg.num_classes,
                         input_shape=tuple(int(d) for d in x.shape[1:]), device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    gen = torch.Generator().manual_seed(cfg.seed)

    if cfg.centralized:
        if not lead:        # one model on one device: the lead rank's
            return {"history": [], "final_metrics": None, "params": params, "packing": None,
                    "stream": None, "hhe": None, "obs": _finish_run_obs(metrics_base, rounds=0)}
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
        train_flops = _train_flops(model, train_cfg, x.shape[1:], len(x), 1)
        train_images = _train_images(train_cfg, len(x), 1)
        record = {
            "round": 0,
            "phases": phases,
            # The JAX driver's per-phase {seconds, flops, mfu, images_per_s}
            # (utils.roofline; mfu against the card's bf16 peak).
            "phase_roofline": {
                "train": roofline.phase_stats(phases["train"], flops=train_flops, device=device,
                                              images=train_images),
                "evaluate": roofline.phase_stats(phases["evaluate"], device=device,
                                                 images=len(xt)),
            },
            "val_loss": [float(metrics[-1, 0])],
            "val_acc": [float(metrics[-1, 1])],
            **{k: float(results[k]) for k in ("accuracy", "precision", "recall", "f1")},
        }
        say(f"centralized: acc {record['accuracy']:.4f} f1 {record['f1']:.4f} ({timer})")
        if cfg.save_model_path:
            save_params(cfg.save_model_path, params)
            say(f"saved model to {cfg.save_model_path}")
        _record_round_obs(0, phases, device)
        return {"history": [record], "final_metrics": record, "params": params,
                "packing": None, "stream": None, "hhe": None,
                "obs": _finish_run_obs(metrics_base, rounds=1)}

    xs, ys = stack_federated(x, y, _partition(cfg, y))
    mesh = num_real = None
    if dist.is_initialized():
        mesh = (make_mesh_2d(cfg.num_clients, cfg.mesh_ct, device=device) if cfg.mesh_ct > 1
                else make_mesh(cfg.num_clients, device=device))
        if not mesh.member:
            say(f"rank {mesh.rank}: outside the {mesh.size}-rank mesh, idle")
            return {"history": [], "final_metrics": None, "params": params, "packing": None,
                    "stream": None, "hhe": None, "mesh": mesh_record(cfg, mesh),
                    "obs": _finish_run_obs(metrics_base, rounds=0)}
        # A rank holds only the rows it trains (resident_rows); the rounds
        # take the registry's size.
        num_real = int(xs.shape[0])
        params = replicate_on(mesh, params)
    several = mesh is not None and mesh.group is not None
    prefetcher = RoundPrefetcher(device)

    def rows_of(r: int):
        """The clients this rank trains in round r (None: every client)."""
        if mesh is None:
            return None
        if cfg.stream is not None:
            return round_rows(cfg.stream, mesh, r, num_real)[0]
        return client_block(mesh, num_real, pad_index(num_real, client_mesh_size(mesh)))[0]
    # The training backend, resolved once a run ("auto" times both on the
    # device here) and pinned for every round.
    train_cfg = dataclasses.replace(train_cfg, client_fusion=_lead_choice(
        mesh, resolve_fusion_backend(train_cfg.client_fusion, model, device)))

    ctx = cfg.he.build() if cfg.encrypted else None
    # A plaintext run has no HE phases: no pin to check, backend None.
    he_backend = he_backend_report(device if cfg.encrypted else None)
    sk = pk = spec = pspec = None
    if cfg.encrypted:
        # Pre-flight static analysis: the aggregation and fold no-wrap
        # bounds and the packed headroom of THIS config, before any
        # training work; publishes analysis.violations (0 here) into the
        # run's metrics snapshot.
        analysis.check_experiment(cfg, ctx=ctx, say=say)
        if lead:
            sk, pk = keygen(ctx, gen, device=device)
        pk = _share_keys(mesh, ctx, pk, gen)
        spec = PackSpec.for_params(params, ctx.n)
        say(f"CKKS context: N={ctx.n} L={ctx.num_primes} -> {spec.n_ct} ciphertexts "
            f"for {count_params(params):,} params on {device}")
        if cfg.packing is not None and cfg.packing.enabled:
            pspec = PackedSpec.for_params(params, ctx, cfg.packing, cfg.num_clients)
            say(f"packing: b={pspec.bits} k={pspec.k} (guard {pspec.guard}, clip "
                f"{pspec.clip}) -> {pspec.n_ct} packed ciphertexts "
                f"({spec.n_ct / pspec.n_ct:.1f}x fewer), error budget {pspec.error_budget:.2e}")

    if cfg.serve and not resume and cfg.checkpoint_path:
        # Recover-then-serve: re-running the same command after a crash picks
        # up where the journal left off, from the round checkpoint.
        if os.path.exists(npz_path(cfg.checkpoint_path)):
            resume = True
            say(f"serve: auto-resuming from {cfg.checkpoint_path}")

    start_round = 0
    resume = _lead_choice(mesh, resume)
    if resume:
        if not cfg.checkpoint_path:
            raise ValueError("resume=True requires checkpoint_path")
        # The owner reads its checkpoint; the other ranks take its state.
        state = None
        if lead:
            params, start_round, state, _ = load_checkpoint(cfg.checkpoint_path, params)
        start_round, state = _lead_choice(mesh, (start_round, state))
        params = replicate_on(mesh, params)
        gen.set_state(state)
        say(f"resumed from {cfg.checkpoint_path} at round {start_round}")
        obs_metrics.counter("checkpoint.resumes").inc()
        obs_events.emit("checkpoint_resume", round=start_round, path=cfg.checkpoint_path)

    train_phase = "train+encrypt+aggregate" if cfg.encrypted else "train+aggregate"
    train_images = _train_images(train_cfg, int(xs.shape[1]), cfg.num_clients)
    train_flops = _train_flops(model, train_cfg, x.shape[1:], int(xs.shape[1]), cfg.num_clients)
    # The masked engine (fault schedule or sanitizing knobs) returns a
    # RoundMeta a round: the same predicate the round functions use for
    # their return arity. Streaming rounds always carry one.
    n_dev = 1 if mesh is None else client_mesh_size(mesh)
    robust = masked_mode(train_cfg, cfg.num_clients, n_dev, explicit=cfg.faults is not None,
                         secure=cfg.encrypted)
    streaming = cfg.stream is not None
    engine = server = None
    if streaming:
        jp = cfg.journal_path
        if cfg.serve and not jp:
            # Serve mode puts the journal beside the checkpoint.
            jp = os.path.join(
                (os.path.dirname(cfg.checkpoint_path) or ".") if cfg.checkpoint_path else ".",
                "journal.wal",
            )
        if jp and lead:
            # Construction IS recovery: a journal a crashed process left is
            # replayed here, its torn tail truncated, the carried uploads and
            # the dedup window rebuilt (the other ranks' engines adopt the
            # rebuilt state at the next round's start).
            engine = server = AggregationServer(cfg.stream, cfg.faults, journal_path=jp,
                                                fsync_policy=cfg.fsync_policy, crash=cfg.crash)
            rec = server.recovered
            if not rec.fresh_journal:
                say(f"journal {jp}: recovered {rec.records} records (sealed rounds "
                    f"{list(rec.sealed_rounds)}, open round {rec.open_round}, "
                    f"{rec.carried_uploads} carried uploads"
                    + (f", torn tail of {rec.torn_bytes_truncated} bytes truncated"
                       if rec.torn_bytes_truncated else "") + ")")
        else:
            engine = StreamEngine(cfg.stream, cfg.faults)
        robust = True
    dp_sample_rate = 1.0
    if streaming and 0 < cfg.stream.cohort_size < cfg.num_clients:
        # Per-round uniform cohorts: the accountant applies amplification by
        # subsampling at this rate.
        dp_sample_rate = cfg.stream.cohort_size / cfg.num_clients
    history: list[dict[str, Any]] = []
    span_tracers: list = []
    for r in range(start_round, cfg.rounds):
        # The first executed round, from its start through evaluate, under
        # the profiler on request (`profiling` stops it should the round
        # raise).
        if cfg.profile_dir is not None and r == start_round and lead:
            profiling.enter_context(obs_trace.round_profiler(cfg.profile_dir, device))
        sched = (schedule_for_round(cfg.faults, r, cfg.num_clients)
                 if cfg.faults is not None else None)
        part = sched.participation() if sched is not None else None
        pois = sched.poison if sched is not None else None
        straggler_s = float(np.max(sched.straggler_s)) if sched is not None else 0.0
        k_round = _round_seed(gen)
        # This round's rows on the card (the staged copy when the previous
        # round prefetched it), then the next round's copy started.
        resident = rows_of(r)
        xs_d, ys_d = prefetcher.get(xs, ys, rows=resident)
        if r + 1 < cfg.rounds:
            prefetcher.prefetch(xs, ys, rows=rows_of(r + 1))
        attempt = 0
        while True:
            # A round whose execution dies (a device or runtime error, or a
            # scheduled DeviceLost) is retried with exponential backoff, from
            # the round checkpoint's (params, generator) when it holds this
            # round's entry state, else as-is; a retried round redraws its
            # first attempt's randomness. Configuration errors
            # (ValueError/TypeError), a SimulatedCrash (the process died; its
            # recovery is a fresh run's job) and a JournalError (the
            # fail-loud verdict on the journal) are never retried. Across
            # several ranks only the scheduled DeviceLost is: every rank
            # raises it alike, before the round's first collective. Any
            # other fault may be one rank's alone, whose peers wait inside
            # the round's collectives; a lone retry would pair its
            # collectives with theirs out of order, so the run fails (under
            # torchrun the failed rank's exit ends its peers).
            try:
                if sched is not None and sched.device_loss and attempt == 0:
                    raise DeviceLost(f"fault injection: scheduled device loss at round {r}")
                timer = PhaseTimer(device)
                round_gen = torch.Generator().manual_seed(k_round)
                meta = smeta = None
                if cfg.encrypted:
                    with timer.phase(train_phase):
                        if streaming:
                            # Straggler delays are ARRIVAL TIMES the engine
                            # consumes (no driver-side sleep).
                            ct_sum, metrics, overflow, smeta = engine.run_round(
                                model, train_cfg, ctx, pk, params, xs_d, ys_d, round_gen, r,
                                dp=dp_cfg, packing=pspec, hhe=cfg.hhe, mesh=mesh,
                                num_real_clients=num_real, resident_rows=resident,
                            )
                            meta = smeta.meta
                            if cfg.span_trace_path:
                                tr = (server.engine if server is not None else engine).last_spans
                                if tr is not None:
                                    span_tracers.append(tr)
                        elif robust:
                            ct_sum, metrics, overflow, meta = secure_fedavg_round(
                                model, train_cfg, ctx, pk, params, xs_d, ys_d, round_gen,
                                packing=pspec, dp=dp_cfg, participation=part, poison=pois,
                                mesh=mesh, num_real_clients=num_real, resident_rows=resident,
                            )
                        else:
                            ct_sum, metrics, overflow = secure_fedavg_round(
                                model, train_cfg, ctx, pk, params, xs_d, ys_d, round_gen,
                                packing=pspec, dp=dp_cfg, mesh=mesh, num_real_clients=num_real,
                                resident_rows=resident,
                            )
                        if not streaming:
                            _straggler_wait(straggler_s, device)
                    with timer.phase("decrypt"):
                        if meta is not None and meta.surviving == 0:
                            # Nobody made the round: the sum is an encryption
                            # of zero. Keep the global model, as the plaintext
                            # masked mean does.
                            if smeta is not None and not smeta.committed:
                                why = ("released sum below the dp noise floor"
                                       if smeta.degraded_reason == "dp_floor"
                                       else f"quorum not reached ({smeta.fresh}"
                                            f"/{smeta.quorum} fresh arrivals)")
                                say(f"round {r}: {why}; keeping previous global model")
                            else:
                                say(f"round {r}: every client excluded ({meta.excluded}); "
                                    "keeping previous global model")
                            new_params = params
                        elif not lead:      # the owner decrypts; replicate_on shares it
                            new_params = params
                        else:
                            new_params = decrypt_average(
                                ctx, sk, ct_sum, cfg.num_clients, spec, meta=meta,
                                packing=pspec, base_params=params, hhe=hhe_on,
                                exact=cfg.exact_final_decode and r == cfg.rounds - 1,
                            )
                        new_params = replicate_on(mesh, new_params)
                else:
                    overflow = None
                    with timer.phase(train_phase):
                        if robust:
                            new_params, metrics, meta = fedavg_round(
                                model, train_cfg, params, xs_d, ys_d, round_gen,
                                participation=part, poison=pois, mesh=mesh,
                                num_real_clients=num_real, resident_rows=resident)
                        else:
                            new_params, metrics = fedavg_round(
                                model, train_cfg, params, xs_d, ys_d, round_gen, mesh=mesh,
                                num_real_clients=num_real, resident_rows=resident)
                        _straggler_wait(straggler_s, device)
                params = new_params
                break
            except RuntimeError as e:
                if isinstance(e, (SimulatedCrash, JournalError)) or (
                        attempt >= cfg.max_round_retries) or (
                        several and not isinstance(e, DeviceLost)):
                    obs_events.emit("round_failed", round=r, error=type(e).__name__,
                                    attempts=attempt + 1)
                    raise
                backoff = cfg.retry_backoff_s * (2**attempt)
                attempt += 1
                obs_metrics.counter("round.retries").inc()
                obs_events.emit("round_retry", round=r, attempt=attempt,
                                error=type(e).__name__, backoff_s=round(backoff, 3))
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
                        obs_metrics.counter("checkpoint.resumes").inc()
                        obs_events.emit("checkpoint_resume", round=r, path=cfg.checkpoint_path)
                        say(f"auto-resumed round-{r} state from {cfg.checkpoint_path}")
        if not lead:
            # The lead rank evaluates, records and writes; a raise it makes
            # on overflow is made here too, so no rank waits on the next round.
            if cfg.encrypted and train_cfg.on_overflow == "raise" and int(overflow.sum()) > 0:
                raise RuntimeError(f"round {r}: weights saturated and on_overflow='raise'")
            continue
        with timer.phase("evaluate"):
            results = evaluate(model, params, xt_d, yt)
        if cfg.profile_dir is not None and r == start_round:
            profiling.close()
            say(f"profiler trace written to {cfg.profile_dir}")
            obs_events.emit("profiler_trace", round=r, dir=cfg.profile_dir)
        phases = timer.summary()
        mets = metrics.cpu().numpy()
        record: dict[str, Any] = {
            "round": r,
            **({"dp_epsilon": epsilon_spent(r + 1, dp_cfg.noise_multiplier, dp_cfg.delta,
                                            sample_rate=dp_sample_rate)}
               if cfg.dp is not None else {}),
            "phases": phases,
            # The JAX driver's roofline rows: the train numerator is train
            # math only (the phase also encrypts and sums), so its mfu is a
            # lower bound; decrypt and evaluate carry no FLOP count.
            "phase_roofline": {
                train_phase: roofline.phase_stats(phases[train_phase], flops=train_flops,
                                                  device=device, images=train_images),
                **({"decrypt": roofline.phase_stats(phases["decrypt"], device=device)}
                   if cfg.encrypted else {}),
                "evaluate": roofline.phase_stats(phases["evaluate"], device=device,
                                                 images=len(xt)),
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
        if robust and meta is not None:
            # The round's robustness record (published to obs too): the
            # participation mask applied, the surviving count (the decode
            # denominator), exclusions by cause, retries, the injected
            # faults; a streaming round adds its arrival story.
            record_round_meta(meta, r)
            rob: dict[str, Any] = {**meta.record(), "round_retries": attempt}
            if smeta is not None:
                record["stream"] = smeta.record()
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
        _record_round_obs(r, phases, device)
        obs_events.emit("round_end", round=r, accuracy=round(record["accuracy"], 6),
                        f1=round(record["f1"], 6),
                        **({"surviving": meta.surviving} if robust and meta is not None else {}))
        say(f"round {r}: acc {record['accuracy']:.4f} f1 {record['f1']:.4f} "
            + (f"dp_eps {record['dp_epsilon']:.2f} " if "dp_epsilon" in record else "")
            + (f"surviving {meta.surviving}/{meta.num_clients} "
               if robust and meta is not None else "")
            + f"({timer})")
        if cfg.checkpoint_path:
            save_checkpoint(cfg.checkpoint_path, params, r + 1, gen,
                            meta={"model": cfg.model, "dataset": cfg.dataset,
                                  "num_clients": cfg.num_clients})
            obs_events.emit("checkpoint_save", round=r, path=cfg.checkpoint_path)
            if server is not None:
                # The checkpoint now covers everything before round r + 1.
                server.compact_to(r + 1)

    if cfg.save_model_path and lead:
        save_params(cfg.save_model_path, params)
        say(f"saved aggregated model to {cfg.save_model_path}")
    if server is not None:
        server.close()
    span_trace = None
    if cfg.span_trace_path and span_tracers and lead:
        span_trace = obs_spans.export_chrome_trace(cfg.span_trace_path, span_tracers)
        say(f"span trace: {len(span_tracers)} round(s) -> {span_trace} (Chrome trace-viewer)")
        obs_events.emit("span_trace", path=span_trace, rounds=len(span_tracers))
    obs_record = _finish_run_obs(metrics_base, rounds=len(history))
    return {
        "history": history,
        "final_metrics": history[-1] if history else None,
        "params": params,
        "span_trace": span_trace,
        "journal": server.report() if server is not None else None,
        # The records of what this run ran, with the JAX driver's keys: the
        # augment warp, the client-training backend, the HE kernels (the
        # CUDA kernels on a card, their plain versions on the CPU) and the
        # round topology.
        "augment_backend": augment_backend_record(),
        "client_fusion": fusion_report(),
        "he_backend": he_backend,
        "packing": pspec.geometry_record() if pspec is not None else None,
        "stream": dataclasses.asdict(cfg.stream) if cfg.stream is not None else None,
        "mesh": mesh_record(cfg, mesh),
        "hhe": _hhe_record(cfg, pspec, ctx) if hhe_on else None,
        "obs": obs_record,
    }


def mesh_record(cfg: ExperimentConfig, mesh) -> dict:
    """The run's round topology: the axes and their sizes, and in a process
    group the world and backend. With no process group (`mesh` None) one
    device is one block: `mesh_ct` > 1 names the two axes, ct of size 1."""
    if mesh is None:
        axes = ["clients", "ct"] if cfg.mesh_ct > 1 else ["clients"]
        return {"axes": axes, "clients": 1, "ct": 1}
    return mesh.record()


def _lead_choice(mesh, choice):
    """Rank 0's `choice` on every member rank (a pickled broadcast), so a
    choice timed on each card ("auto" fusion) is the same on all."""
    if mesh is None or mesh.group is None:
        return choice
    box = [choice]
    dist.broadcast_object_list(box, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return box[0]


def _share_keys(mesh, ctx: CkksContext, pk, gen: torch.Generator):
    """The owner's public key and the run generator's state after keygen
    on every member rank (broadcasts from rank 0): each rank then draws the
    rounds' seeds as the owner does (on the mesh's device). -> the public key."""
    if mesh is None or mesh.group is None:
        return pk
    from hefl_tpu_torch.ckks.keys import PublicKey

    src = dist.get_global_rank(mesh.group, 0)
    device = mesh.device
    shape = (ctx.num_primes, ctx.n)
    if pk is None:
        pk = PublicKey(b_mont=torch.zeros(shape, dtype=torch.int32, device=device),
                       a_mont=torch.zeros(shape, dtype=torch.int32, device=device))
    for t in (pk.b_mont, pk.a_mont):
        dist.broadcast(t, src, group=mesh.group)
    state = gen.get_state().to(device)
    dist.broadcast(state, src, group=mesh.group)
    gen.set_state(state.cpu())
    return pk


def augment_backend_record() -> dict:
    """The JAX record of the augment warp's backend: the port's one warp,
    a gather."""
    return {"requested": "gather", "backend": "gather", "auto_timings_ms": None,
            "auto_persisted": False}


def _straggler_wait(seconds: float, device) -> None:
    """The synchronous round waits for its slowest scheduled straggler: the
    device's work first, then the scheduled delay, inside the timed phase
    (as a real straggler would show in the round's wall time)."""
    if seconds > 0:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with torch.profiler.record_function(obs_scopes.STRAGGLER_WAIT):
            time.sleep(seconds)


def _hhe_record(cfg: ExperimentConfig, pspec: PackedSpec, ctx: CkksContext) -> dict:
    """Key seed and the hybrid-HE wire story (`expansion_hhe`, the <= 1.1x
    gate, and the packed CKKS ciphertext the upload replaces)."""
    return {"key_seed": (cfg.hhe or HheConfig()).key_seed,
            **hhe_bytes_on_wire_record(pspec, ctx.num_primes)}
