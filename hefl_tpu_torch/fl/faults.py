"""Fault model of the participation-masked round: schedules, poison and
sanitizing predicates, and the round's public outcome.

Counterpart of `hefl_tpu.fl.faults`:

  * `FaultConfig` / `schedule_for_round` — the deterministic fault schedule
    (which clients drop, which upload NaN or +1e15 weights, which straggle
    and by how long, which rounds lose their device on the first attempt).
    Host numpy keyed by `np.random.default_rng([seed, round, ...])`, the
    JAX package's streams, so the port's schedules are the same arrays bit
    for bit; `schedule_arrivals` (consumed by the streaming engine,
    `fl.stream`) and `schedule_links` (the hierarchical engine's, not
    ported yet) likewise.
  * `poison_tree` / `exclusion_bits` — the in-round halves, as PyTorch on
    the port's parameter dicts: the poison applied to a client's trained
    weights (a pure `where` select, so POISON_NONE leaves every value
    bit-identical), and the sanitizing predicates (non-finite update,
    update norm above `max_update_norm`, encoder saturation under
    on_overflow="exclude") that give the round its exclusion bitmask.
  * `RoundMeta` — who made the round's released sum, and why the others
    did not; `surviving` is the decode denominator of
    `fl.secure.decrypt_average`. `record_round_meta` publishes it to the
    obs layer (exclusion counters by cause, one `round_robust` event).
  * `CrashConfig` / `SimulatedCrash` — deterministic process-crash
    injection for the durable aggregation server (`fl.journal`,
    `fl.server`), at one of `CRASH_POINTS`.

Exclusion causes are bits of one int32 per client (a client can be both
scheduled out and poisoned): bit 0 scheduled, 1 non-finite, 2 norm, 3
overflow; bits 4-10 are the streaming and hierarchical engines' arrival
and tier causes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hefl_tpu_torch.fl.dp import global_l2_norm
from hefl_tpu_torch.parallel import host_of_clients

# Exclusion-cause bits (the int32[C] bitmask of a masked round).
EXCLUDED_SCHEDULED = 1      # external mask: scheduled dropout
EXCLUDED_NONFINITE = 2      # NaN/Inf anywhere in the trained update
EXCLUDED_NORM = 4           # finite but ||update - global||_2 > max_update_norm
EXCLUDED_OVERFLOW = 8       # encode overflow > 0 under on_overflow="exclude"
EXCLUDED_STALE = 16         # late upload exceeded the staleness budget
EXCLUDED_TIMEOUT = 32       # upload missed this round's commit
EXCLUDED_UNREACHABLE = 64   # delivery failed, retries exhausted
EXCLUDED_UNSAMPLED = 128    # not in this round's cohort
EXCLUDED_HOST_TIMEOUT = 256
EXCLUDED_HOST_UNREACHABLE = 512
EXCLUDED_HOST_STALE = 1024

EXCLUSION_CAUSES = {
    "scheduled": EXCLUDED_SCHEDULED,
    "nonfinite": EXCLUDED_NONFINITE,
    "norm": EXCLUDED_NORM,
    "overflow": EXCLUDED_OVERFLOW,
    "stale": EXCLUDED_STALE,
    "timeout": EXCLUDED_TIMEOUT,
    "unreachable": EXCLUDED_UNREACHABLE,
    "unsampled": EXCLUDED_UNSAMPLED,
    "host_timeout": EXCLUDED_HOST_TIMEOUT,
    "host_unreachable": EXCLUDED_HOST_UNREACHABLE,
    "host_stale": EXCLUDED_HOST_STALE,
}

# Poison codes (one per client).
POISON_NONE = 0
POISON_NAN = 1    # every weight becomes NaN — a diverged client's upload
POISON_HUGE = 2   # +1e15 on every weight — a huge-norm (model-poisoning) upload
_HUGE = 1e15


class DeviceLost(RuntimeError):
    """Simulated device loss (FaultConfig.fail_rounds): raised by the driver
    before the round runs, exercising the retry/backoff path."""


class SimulatedCrash(RuntimeError):
    """Deterministic process-crash injection (CrashConfig): raised by the
    journal session (fl.journal.RoundSession) at the configured boundary,
    after any configured torn-frame prefix has been written — the
    in-memory server state is then abandoned exactly as a SIGKILL would
    abandon it, and only the write-ahead journal survives."""


# The injectable crash boundaries, in round-lifecycle order. "mid_append"
# kills the process MID-write of the Nth fold's journal frame, leaving a
# REAL torn record on disk (the recovery path must truncate it);
# "post_fold" kills after that frame landed; "pre_commit"/"post_commit"
# bracket the round's commit record; "post_close" lands between the
# sealed round and its checkpoint.
CRASH_POINTS = (
    "mid_append", "post_fold", "pre_commit", "post_commit", "post_close"
)


@dataclasses.dataclass(frozen=True)
class CrashConfig:
    """Deterministic process-crash injection for the durable aggregation
    server (fl.server / fl.journal). One crash per process: the journal
    session raises SimulatedCrash at the configured boundary of the
    configured round; a recovering process runs with crash=None and must
    reach the bitwise state of an uninterrupted run.

    round:        round index whose lifecycle hosts the crash.
    at:           one of CRASH_POINTS (see above).
    after_folds:  which fold (1-based) triggers mid_append/post_fold.
    torn_bytes:   prefix length of the torn frame mid_append leaves.
    """

    round: int = 0
    at: str = "post_fold"
    after_folds: int = 1
    torn_bytes: int = 24

    def __post_init__(self):
        if self.at not in CRASH_POINTS:
            raise ValueError(
                f"CrashConfig.at={self.at!r}: must be one of {CRASH_POINTS}"
            )
        if self.after_folds < 1:
            raise ValueError("CrashConfig.after_folds must be >= 1")
        if self.torn_bytes < 1:
            raise ValueError("CrashConfig.torn_bytes must be >= 1")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Deterministic fault-injection schedule (frozen, so it can ride in an
    ExperimentConfig); the JAX package's fields and defaults. All rates
    default to 0: an all-zeros FaultConfig schedules nothing.

    seed: PRNG seed of the schedule. drop_fraction: fraction of clients
    scheduled out each round (an exact count). nan_clients / huge_clients:
    clients a round whose trained weights become NaN / get +1e15.
    straggler_fraction, straggler_delay_s: the synchronous round waits for
    its slowest straggler. fail_rounds: rounds whose first attempt raises
    DeviceLost. The arrival knobs (arrival_delay_s, duplicate_clients,
    transient_fail_clients, permanent_fail_clients), the regional outage
    (outage_hosts, num_hosts) and the DCN link knobs (link_*) are drawn by
    `schedule_arrivals` / `schedule_for_round` / `schedule_links` as in the
    JAX package, and consumed by the streaming engine (`fl/stream.py`) and
    the fold tree (`fl/hierarchy.py`).
    """

    seed: int = 0
    drop_fraction: float = 0.0
    nan_clients: int = 0
    huge_clients: int = 0
    straggler_fraction: float = 0.0
    straggler_delay_s: float = 0.0
    fail_rounds: tuple[int, ...] = ()
    arrival_delay_s: float = 0.0
    duplicate_clients: int = 0
    transient_fail_clients: int = 0
    permanent_fail_clients: int = 0
    outage_hosts: int = 0
    num_hosts: int = 0
    link_loss_hosts: int = 0
    link_dark_hosts: int = 0
    link_delay_s: float = 0.0
    link_dup_hosts: int = 0

    def __post_init__(self):
        for name in (
            "drop_fraction", "nan_clients", "huge_clients",
            "straggler_fraction", "straggler_delay_s", "arrival_delay_s",
            "duplicate_clients", "transient_fail_clients",
            "permanent_fail_clients", "outage_hosts", "num_hosts",
            "link_loss_hosts", "link_dark_hosts", "link_delay_s",
            "link_dup_hosts",
        ):
            if getattr(self, name) < 0:
                raise ValueError(f"FaultConfig.{name} must be >= 0")
        if self.outage_hosts > 0 and self.num_hosts < 2:
            raise ValueError(
                f"FaultConfig.outage_hosts={self.outage_hosts} needs "
                "num_hosts >= 2: an outage darkens one host row of a "
                "multi-host topology"
            )
        if self.outage_hosts >= self.num_hosts > 0:
            raise ValueError(
                f"FaultConfig.outage_hosts={self.outage_hosts} with "
                f"num_hosts={self.num_hosts}: at least one host row must "
                "survive or no round can ever commit"
            )
        if self._any_link_fault() and self.num_hosts < 2:
            raise ValueError(
                "FaultConfig.link_loss_hosts/link_dark_hosts/link_delay_s/"
                "link_dup_hosts fault the tier->root uplinks of a "
                "multi-host topology; set num_hosts >= 2 to define the "
                "uplinks"
            )
        if self.link_dark_hosts >= self.num_hosts > 0:
            raise ValueError(
                f"FaultConfig.link_dark_hosts={self.link_dark_hosts} with "
                f"num_hosts={self.num_hosts}: at least one uplink must "
                "deliver or no hierarchical round can ever commit"
            )

    def _any_link_fault(self) -> bool:
        return bool(
            self.link_loss_hosts > 0
            or self.link_dark_hosts > 0
            or self.link_delay_s > 0
            or self.link_dup_hosts > 0
        )

    def max_scheduled_exclusions(self, num_clients: int) -> int:
        """Worst-case per-round exclusion count this schedule can cause
        (dropout, outage and link blocks, poison targets, arrival
        failures) — the bound the driver derives the DP noise floor from.
        Sanitizing causes outside the schedule are not modeled; a DP round
        that exceeds the bound fails loudly in `fl.secure`."""
        outage = 0
        if self.outage_hosts > 0:
            per_host = -(-int(num_clients) // int(self.num_hosts))
            outage = int(self.outage_hosts) * per_host
        linkx = 0
        if self.link_dark_hosts > 0 or self.link_loss_hosts > 0:
            per_host = -(-int(num_clients) // int(self.num_hosts))
            linkx = (int(self.link_dark_hosts) + int(self.link_loss_hosts)) * per_host
        return min(
            int(num_clients),
            int(round(self.drop_fraction * num_clients))
            + outage
            + linkx
            + int(self.nan_clients)
            + int(self.huge_clients)
            + int(self.permanent_fail_clients)
            + int(self.transient_fail_clients),
        )


@dataclasses.dataclass(frozen=True)
class RoundFaults:
    """One round's concrete fault assignment (host numpy)."""

    dropped: np.ndarray       # bool[C]  scheduled dropout
    poison: np.ndarray        # int32[C] POISON_* codes
    straggler_s: np.ndarray   # float64[C] per-client scheduled delay
    device_loss: bool         # raise DeviceLost on this round's first attempt

    def participation(self) -> np.ndarray:
        """int32[C] external mask: 1 = scheduled to participate."""
        return (~self.dropped).astype(np.int32)


def schedule_for_round(fc: FaultConfig, round_index: int, num_clients: int) -> RoundFaults:
    """The deterministic fault assignment for one round, keyed by
    (fc.seed, round_index): the exact dropout count, then the regional
    outage on stream (seed, round, 5), then NaN and huge targets among the
    clients that made the round, then stragglers among them — the JAX
    package's draws in its order."""
    rng = np.random.default_rng([int(fc.seed), int(round_index)])
    dropped = np.zeros(num_clients, dtype=bool)
    n_drop = min(int(round(fc.drop_fraction * num_clients)), num_clients)
    if n_drop:
        dropped[rng.choice(num_clients, n_drop, replace=False)] = True
    if fc.outage_hosts > 0:
        org = np.random.default_rng([int(fc.seed), int(round_index), 5])
        dark = org.choice(int(fc.num_hosts), int(fc.outage_hosts), replace=False)
        dropped |= np.isin(host_of_clients(num_clients, int(fc.num_hosts)), dark)
    poison = np.zeros(num_clients, dtype=np.int32)
    alive = np.flatnonzero(~dropped)
    n_nan = min(int(fc.nan_clients), len(alive))
    if n_nan:
        picks = rng.choice(alive, n_nan, replace=False)
        poison[picks] = POISON_NAN
        alive = np.setdiff1d(alive, picks)
    n_huge = min(int(fc.huge_clients), len(alive))
    if n_huge:
        poison[rng.choice(alive, n_huge, replace=False)] = POISON_HUGE
    straggler_s = np.zeros(num_clients)
    candidates = np.flatnonzero(~dropped)
    n_strag = min(int(round(fc.straggler_fraction * num_clients)), len(candidates))
    if n_strag and fc.straggler_delay_s > 0:
        idx = rng.choice(candidates, n_strag, replace=False)
        straggler_s[idx] = rng.uniform(0.25 * fc.straggler_delay_s, fc.straggler_delay_s,
                                       n_strag)
    return RoundFaults(
        dropped=dropped,
        poison=poison,
        straggler_s=straggler_s,
        device_loss=int(round_index) in fc.fail_rounds,
    )


@dataclasses.dataclass(frozen=True)
class ArrivalFaults:
    """One round's arrival-fault assignment (host numpy): when each upload
    lands (straggler delays folded in), and which deliveries are
    duplicated, lost once, or lost for good."""

    arrival_s: np.ndarray   # float64[C] first-delivery offsets
    duplicate: np.ndarray   # bool[C]  successful first delivery lands twice
    transient: np.ndarray   # bool[C]  first delivery lost; retries succeed
    permanent: np.ndarray   # bool[C]  every delivery attempt fails


def schedule_arrivals(fc: FaultConfig, round_index: int, num_clients: int) -> ArrivalFaults:
    """The deterministic arrival-fault assignment for one round, on stream
    (seed, round_index, 1), among the clients the dropout schedule left
    alive: permanent, then transient, then duplicates, disjoint."""
    rng = np.random.default_rng([int(fc.seed), int(round_index), 1])
    sched = schedule_for_round(fc, round_index, num_clients)
    base = (rng.uniform(0.0, fc.arrival_delay_s, num_clients) if fc.arrival_delay_s > 0
            else np.zeros(num_clients))
    arrival_s = base + sched.straggler_s
    duplicate = np.zeros(num_clients, dtype=bool)
    transient = np.zeros(num_clients, dtype=bool)
    permanent = np.zeros(num_clients, dtype=bool)
    alive = np.flatnonzero(~sched.dropped)
    n_perm = min(int(fc.permanent_fail_clients), len(alive))
    if n_perm:
        picks = rng.choice(alive, n_perm, replace=False)
        permanent[picks] = True
        alive = np.setdiff1d(alive, picks)
    n_tran = min(int(fc.transient_fail_clients), len(alive))
    if n_tran:
        picks = rng.choice(alive, n_tran, replace=False)
        transient[picks] = True
        alive = np.setdiff1d(alive, picks)
    n_dup = min(int(fc.duplicate_clients), len(alive))
    if n_dup:
        duplicate[rng.choice(alive, n_dup, replace=False)] = True
    return ArrivalFaults(arrival_s=arrival_s, duplicate=duplicate, transient=transient,
                         permanent=permanent)


@dataclasses.dataclass(frozen=True)
class LinkFaults:
    """One round's DCN-link fault assignment (host numpy), by host row."""

    delay_s: np.ndarray    # float64[H] added delivery delay per ship
    duplicate: np.ndarray  # bool[H]  successful ship is delivered twice
    transient: np.ndarray  # bool[H]  first delivery lost; retries succeed
    dark: np.ndarray       # bool[H]  every delivery attempt fails


def schedule_links(fc: FaultConfig, round_index: int) -> LinkFaults:
    """The deterministic DCN-link fault assignment for one round, on stream
    (seed, round_index, 7): dark, then transient, then duplicates among
    the clean remainder, disjoint; the delay composes with all of them."""
    num_hosts = int(fc.num_hosts)
    rng = np.random.default_rng([int(fc.seed), int(round_index), 7])
    delay_s = (rng.uniform(0.0, fc.link_delay_s, num_hosts) if fc.link_delay_s > 0
               else np.zeros(num_hosts))
    duplicate = np.zeros(num_hosts, dtype=bool)
    transient = np.zeros(num_hosts, dtype=bool)
    dark = np.zeros(num_hosts, dtype=bool)
    hosts = np.arange(num_hosts)
    n_dark = min(int(fc.link_dark_hosts), len(hosts))
    if n_dark:
        picks = rng.choice(hosts, n_dark, replace=False)
        dark[picks] = True
        hosts = np.setdiff1d(hosts, picks)
    n_loss = min(int(fc.link_loss_hosts), len(hosts))
    if n_loss:
        picks = rng.choice(hosts, n_loss, replace=False)
        transient[picks] = True
        hosts = np.setdiff1d(hosts, picks)
    n_dup = min(int(fc.link_dup_hosts), len(hosts))
    if n_dup:
        duplicate[rng.choice(hosts, n_dup, replace=False)] = True
    return LinkFaults(delay_s=delay_s, duplicate=duplicate, transient=transient, dark=dark)


# ---------------------------------------------------------------------------
# In-round halves: poison injection and the sanitizing predicates, on the
# port's parameter dicts. A POISON_NONE code leaves every value bit-identical
# (a `where` select, never arithmetic on the kept path).
# ---------------------------------------------------------------------------


def poison_tree(params: dict, code) -> dict:
    """One client's poison code applied to its trained weights: NaN
    everywhere (POISON_NAN), +1e15 on every weight (POISON_HUGE), or every
    leaf bit-identical (POISON_NONE)."""
    out = {}
    for k, t in params.items():
        c = torch.as_tensor(code, device=t.device)
        nan = torch.full((), float("nan"), dtype=t.dtype, device=t.device)
        sel = torch.where(c == POISON_NAN, nan, t)
        out[k] = torch.where(c == POISON_HUGE, t + torch.tensor(_HUGE, dtype=t.dtype,
                                                                 device=t.device), sel)
    return out


def exclusion_bits(cfg, global_params: dict, p_out: list[dict], participation,
                   overflow=None) -> torch.Tensor:
    """Per-client exclusion bitmask -> int32[C] on the weights' device, 0 =
    participates.

    p_out: the C clients' (poisoned, sanitized) weights; participation:
    int[C] external mask (0 = scheduled out); overflow: int[C] encode
    saturation counts (the encrypted round only). `cfg` is the TrainConfig:
    max_update_norm > 0 adds the norm bound, on_overflow="exclude" the
    overflow predicate."""
    dev = next(iter(global_params.values())).device
    finite = torch.stack([
        torch.stack([torch.isfinite(v).all() for v in prm.values()]).all() for prm in p_out
    ])
    mask = torch.as_tensor(np.asarray(participation), device=dev)
    bits = torch.where(mask > 0, 0, EXCLUDED_SCHEDULED).to(torch.int32)
    bits = bits | torch.where(finite, 0, EXCLUDED_NONFINITE).to(torch.int32)
    if cfg.max_update_norm > 0:
        norms = torch.stack([
            global_l2_norm({k: prm[k] - global_params[k] for k in prm}) for prm in p_out
        ])
        norm_bad = finite & (norms > cfg.max_update_norm)
        bits = bits | torch.where(norm_bad, EXCLUDED_NORM, 0).to(torch.int32)
    if overflow is not None and cfg.on_overflow == "exclude":
        bits = bits | torch.where(overflow.to(dev) > 0, EXCLUDED_OVERFLOW, 0).to(torch.int32)
    return bits


# ---------------------------------------------------------------------------
# Round metadata: the public record of who made the aggregate.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoundMeta:
    """Public outcome of one round: the participation mask applied, with
    cause attribution; `surviving` is the decode denominator. `sanitized`
    says whether the predicates ran (False on the all-clients fast path,
    where an all-zero bits row means "nothing was scheduled out", not
    "every update was checked")."""

    num_clients: int
    bits: tuple[int, ...]
    participation: tuple[int, ...]
    surviving: int
    excluded: dict
    sanitized: bool = True

    @classmethod
    def from_bits(cls, bits, sanitized: bool = True) -> "RoundMeta":
        b = np.asarray(bits.cpu() if isinstance(bits, torch.Tensor) else bits, dtype=np.int64)
        part = (b == 0).astype(np.int32)
        return cls(
            num_clients=int(b.size),
            bits=tuple(int(v) for v in b),
            participation=tuple(int(v) for v in part),
            surviving=int(part.sum()),
            excluded={name: int(np.count_nonzero(b & flag))
                      for name, flag in EXCLUSION_CAUSES.items()},
            sanitized=sanitized,
        )

    @classmethod
    def full_participation(cls, num_clients: int) -> "RoundMeta":
        """The all-clients-present record of the fast path (no predicates
        ran, hence sanitized=False)."""
        return cls.from_bits(np.zeros(num_clients, np.int64), sanitized=False)

    def record(self) -> dict:
        """JSON-ready summary for a round's history record."""
        return {
            "participation": list(self.participation),
            "surviving": self.surviving,
            "excluded": dict(self.excluded),
            "sanitized": self.sanitized,
        }


def record_round_meta(meta: RoundMeta, round_index: int | None = None) -> RoundMeta:
    """Publish one masked round's outcome to the observability layer
    (obs.events / obs.metrics): per-cause exclusion counters and one
    `round_robust` event line. The driver calls this once per masked round.
    Returns `meta` so call sites can thread it through."""
    from hefl_tpu_torch.obs import events, metrics

    for cause, n in meta.excluded.items():
        if n:
            metrics.counter(f"exclusions.{cause}").inc(n)
    metrics.counter("rounds.masked").inc()
    if meta.surviving < meta.num_clients:
        metrics.counter("clients.excluded").inc(meta.num_clients - meta.surviving)
    events.emit(
        "round_robust",
        **({"round": round_index} if round_index is not None else {}),
        **meta.record(),
    )
    return meta
