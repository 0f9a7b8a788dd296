"""Streaming quorum aggregation: deadline-driven cohorts, bounded staleness.

Counterpart of `hefl_tpu.fl.stream`'s engine. CKKS addition is
associative and commutative over exact residues mod p, so a round need not
wait for every client nor hold every ciphertext at once:

  * `sample_cohort` — per-round cohorts drawn by a deterministic PRNG; with
    `StreamConfig.cohort_only` (the default) only the cohort's client slots
    are trained and encrypted (`secure.client_uploads(cohort=)`, padded up
    the `fedavg.cohort_bucket` ladder), bitwise the full-C round's uploads.
  * `OnlineAccumulator` — each arriving encrypted upload folds into a
    running modular sum on the device: one [n_ct, L, N] residue pair
    however many clients fold, bitwise the batched sum in any arrival
    order.
  * `StreamEngine` — the round lifecycle on a virtual clock: every cohort
    client's upload arrives at the time the fault schedule
    (`fl.faults.schedule_arrivals`) gives it; a lost upload is retried with
    exponential backoff and deterministic jitter; duplicates are rejected
    by a bounded nonce window (`DedupWindow`); the sanitizer's verdict
    rejects poisoned arrivals; the round COMMITS as soon as a quorum of the
    cohort has folded, or degrades (the global model carried forward); an
    upload that misses the commit carries into the next round under the
    staleness budget tau, or is excluded. With a `fl.journal.RoundSession`
    every transition is journaled (live) or verified against the journal
    (replay) — the durable service of `fl.server`.

With `upload_kind="hhe"` the clients upload stream-cipher word pairs; the
server provisions the keystream pads (one K3 launch) and transciphers every
upload into CKKS (one K7 launch) before the fold; a journaled round keeps
the pads so replay can re-transcipher the persisted symmetric bodies
(`hhe.transcipher.retranscipher_decode`).

With `StreamConfig.num_hosts >= 2` the round folds through the two-tier
tree of `fl.hierarchy`: each host's tier folds its client block, and at the
client-quorum commit point every nonempty tier ships one partial over a
simulated uplink that the link-fault schedule (`fl.faults.schedule_links`)
may delay, lose, duplicate or darken. The round re-takes its verdict at the
tier level (`host_quorum`), and a missed tier's sealed partial carries into
the next round under `host_staleness_rounds` (`PendingTierPartial`), folded
at that round's root before any arrival.

With `PackedSpec.error_feedback` each client quantizes update + residual;
the engine keeps one float32 residual row per registered client
(`_ef_residual`), updated at production time for the round's trained rows
and committed with the rest of the cross-round state. As in the JAX
package, the residual is not journaled.

`num_real_clients` is refused: one device never pads its clients.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import time
from typing import Any

import numpy as np
import torch

from hefl_tpu_torch.analysis import ranges
from hefl_tpu_torch.ckks.ops import Ciphertext
from hefl_tpu_torch.fl.client import init_ef_residuals
from hefl_tpu_torch.fl.config import HheConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.dp import calibration_clients
from hefl_tpu_torch.fl.faults import (
    EXCLUDED_HOST_STALE,
    EXCLUDED_HOST_TIMEOUT,
    EXCLUDED_HOST_UNREACHABLE,
    EXCLUDED_NONFINITE,
    EXCLUDED_NORM,
    EXCLUDED_OVERFLOW,
    EXCLUDED_STALE,
    EXCLUDED_TIMEOUT,
    EXCLUDED_UNREACHABLE,
    EXCLUDED_UNSAMPLED,
    EXCLUSION_CAUSES,
    RoundMeta,
    schedule_arrivals,
    schedule_for_round,
    schedule_links,
)
from hefl_tpu_torch.fl.journal import host_u32
from hefl_tpu_torch.fl.secure import client_uploads
from hefl_tpu_torch.hhe import cipher, transcipher
from hefl_tpu_torch.obs import events as obs_events
from hefl_tpu_torch.obs import metrics as obs_metrics
from hefl_tpu_torch.obs import scopes as obs_scopes
from hefl_tpu_torch.obs.scopes import scoped
from hefl_tpu_torch.obs import spans as obs_spans
from hefl_tpu_torch.parallel import host_of_clients

# In-program sanitization causes: an upload whose bits carry any of these
# ARRIVES but is rejected at the accumulator (the sanitizer's verdict is
# part of the upload's validity, not of its delivery).
_REJECT_MASK = EXCLUDED_NONFINITE | EXCLUDED_NORM | EXCLUDED_OVERFLOW

# Commit latency (virtual seconds from round open to the quorum-th fresh
# fold) and arrival-to-fold (each folded upload's position on the same
# axis) histogram bounds, the JAX package's.
_COMMIT_LATENCY_BUCKETS = (0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
_ARRIVAL_TO_FOLD_BUCKETS = _COMMIT_LATENCY_BUCKETS


def sample_cohort(stream: StreamConfig, round_index: int, num_clients: int) -> np.ndarray:
    """The round's cohort: sorted client indices drawn without replacement
    by a PRNG keyed on (stream.seed, round_index, 2)."""
    size = int(stream.cohort_size)
    if size <= 0 or size >= num_clients:
        return np.arange(num_clients)
    rng = np.random.default_rng([int(stream.seed), int(round_index), 2])
    return np.sort(rng.choice(num_clients, size, replace=False))


def quorum_count(stream: StreamConfig, cohort_size: int) -> int:
    """Fresh arrivals needed to commit: ceil(quorum * cohort), floor 1."""
    return max(1, int(math.ceil(stream.quorum * cohort_size)))


def _residues(x, device) -> torch.Tensor:
    """Residues as int32 on `device`: a tensor moves, a host uint32 array
    (a journal body) is viewed as the int32 residues it holds."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x).astype(np.int32))
    return x.to(device=device, dtype=torch.int32)


class OnlineAccumulator:
    """Running modular sum of ciphertext uploads, folded one arrival (or one
    batch) at a time, on the device of the uploads.

    Each fold adds canonical residues in int64 and reduces mod p, so the
    running sum is canonical int32 and BITWISE equal to the batched sum over
    the same uploads in any arrival order. Duplicate deliveries are rejected
    idempotently by nonce. Memory is one [n_ct, L, N] residue pair.
    """

    def __init__(self, p):
        self._p_host = np.asarray(p, dtype=np.int64)     # [L, 1]
        self._p: torch.Tensor | None = None
        self._c0: torch.Tensor | None = None
        self._c1: torch.Tensor | None = None
        self._nonces: set = set()
        self.folded = 0
        self.duplicates = 0

    def _mod(self, s: torch.Tensor) -> torch.Tensor:
        if self._p is None or self._p.device != s.device:
            self._p = torch.from_numpy(self._p_host).to(s.device)
        return torch.remainder(s, self._p).to(torch.int32)

    def _add(self, s0: torch.Tensor, s1: torch.Tensor) -> None:
        """Fold int64 sums (already reduced or not) into the accumulator."""
        if self._c0 is not None:
            s0 = s0 + self._c0.to(torch.int64)
            s1 = s1 + self._c1.to(torch.int64)
        self._c0, self._c1 = self._mod(s0), self._mod(s1)

    def _device(self, c0):
        """The sum's device: a host array moves there, a tensor must be there
        already (a fold never carries the sum off the device it lives on)."""
        if self._c0 is None:
            return c0.device if isinstance(c0, torch.Tensor) else torch.device("cpu")
        if isinstance(c0, torch.Tensor) and c0.device != self._c0.device:
            raise ValueError(
                f"OnlineAccumulator: upload on {c0.device} but the running sum "
                f"lives on {self._c0.device}"
            )
        return self._c0.device

    @scoped(obs_scopes.PSUM_AGGREGATE)
    def fold(self, nonce, c0, c1) -> bool:
        """Fold one upload (tensors, or host uint32 arrays); False (and count
        a duplicate) if its nonce was already folded."""
        if nonce in self._nonces:
            self.duplicates += 1
            return False
        self._nonces.add(nonce)
        dev = self._device(c0)
        self._add(_residues(c0, dev).to(torch.int64), _residues(c1, dev).to(torch.int64))
        self.folded += 1
        return True

    @scoped(obs_scopes.PSUM_AGGREGATE)
    def fold_batch(self, nonces, c0_batch, c1_batch) -> int:
        """Fold a batch of arrivals with one int64 sum and one reduction;
        duplicate nonces (against the window and within the batch) are
        rejected like `fold`'s, first occurrence wins. -> uploads folded."""
        fresh = []
        for i, nonce in enumerate(nonces):
            if nonce in self._nonces:
                self.duplicates += 1
                continue
            self._nonces.add(nonce)
            fresh.append(i)
        if not fresh:
            return 0
        dev = self._device(c0_batch)
        b0, b1 = _residues(c0_batch, dev), _residues(c1_batch, dev)
        idx = torch.tensor(fresh, dtype=torch.int64, device=dev)
        self._add(b0.index_select(0, idx).to(torch.int64).sum(dim=0),
                  b1.index_select(0, idx).to(torch.int64).sum(dim=0))
        self.folded += len(fresh)
        return len(fresh)

    def value(self, like_shape=None, device=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The running sum (canonical int32 residues); zeros of `like_shape`
        on `device` when nothing folded (the encryption of zero an empty
        round yields)."""
        if self._c0 is None:
            if like_shape is None:
                raise ValueError("OnlineAccumulator.value: nothing folded and no shape")
            z = torch.zeros(tuple(like_shape), dtype=torch.int32, device=device)
            return z, z.clone()
        return self._c0, self._c1


def ct_hash(c0, c1) -> str:
    """sha256 over the uint32 bytes of c0 then c1 — the bitwise-equality
    currency of the streaming gates and the journal's content hashes (the
    JAX package's `ct_hash`, over the port's residues)."""
    h = hashlib.sha256()
    h.update(host_u32(c0))
    h.update(host_u32(c1))
    return h.hexdigest()


class DedupWindow:
    """Bounded dedup nonce window: the engine's idempotence memory.

    A (client, round) nonce stays live exactly as long as a duplicate of it
    could still arrive: its upload can trail at most tau rounds behind its
    origin plus the commit round itself, so `advanced(r, tau)` keeps a
    nonce iff `r - origin_round <= tau + 1`. Size is bounded by
    (tau + 2) x cohort uploads however long the service runs. `advanced`
    returns a NEW window (the engine's transactional cross-round state);
    `peak_entries` is the high-water mark over the window's lineage.
    """

    __slots__ = ("_nonces", "_peak")

    def __init__(self, nonces=(), peak: int = 0):
        self._nonces = {tuple(n) for n in nonces}
        self._peak = max(int(peak), len(self._nonces))

    def advanced(self, round_index: int, tau: int) -> "DedupWindow":
        """The window as round `round_index` sees it: nonces older than the
        duplicate-reachability horizon tau + 1 evicted, live ones kept; the
        lineage peak carries forward."""
        return DedupWindow(
            (n for n in self._nonces if int(round_index) - int(n[1]) <= int(tau) + 1),
            peak=self._peak,
        )

    @property
    def peak_entries(self) -> int:
        """High-water mark of live nonces over this window's lineage."""
        return self._peak

    def add(self, nonce) -> None:
        self._nonces.add(tuple(nonce))
        if len(self._nonces) > self._peak:
            self._peak = len(self._nonces)

    def __contains__(self, nonce) -> bool:
        return tuple(nonce) in self._nonces

    def __iter__(self):
        return iter(self._nonces)

    def __len__(self) -> int:
        return len(self._nonces)

    def __eq__(self, other) -> bool:
        if isinstance(other, DedupWindow):
            return self._nonces == other._nonces
        if isinstance(other, (set, frozenset)):
            return self._nonces == {tuple(n) for n in other}
        return NotImplemented


@dataclasses.dataclass
class PendingUpload:
    """An upload carried across rounds under the staleness budget."""

    client: int
    origin_round: int
    nonce: tuple
    c0: Any              # int32 residues [n_ct, L, N] (a tensor, or a journal body's array)
    c1: Any
    lands_at: float      # arrival offset within its landing round
    lateness: int        # rounds behind its origin when it lands


@dataclasses.dataclass
class PendingTierPartial:
    """A sealed HOST partial carried across rounds under the tier staleness
    budget: host `host`'s tier folded `clients`' uploads in `origin_round`
    but its ship missed that round's commit. It folds at a later round's
    root as a stale tier fold (`HierarchicalAggregator.fold_carried`,
    deduped by (host, origin_round)) or carries until `lateness` passes
    host_staleness_rounds, when its clients are excluded as "host_stale"."""

    host: int
    origin_round: int
    sha: str
    c0: Any                    # int32 residues [n_ct, L, N] (tensor, or a journal body's array)
    c1: Any
    clients: tuple[int, ...]   # the client folds the partial holds
    lateness: int              # rounds behind its origin when it folds


@dataclasses.dataclass
class _HheRound:
    """Server-side hybrid-HE state of one journaled round: the arrived
    symmetric words and the provisioned keystream pads (on the device), so
    journal replay can re-transcipher persisted symmetric bytes against the
    re-derived pads and land on bitwise the live fold's residues."""

    w_hi: torch.Tensor     # int32[rows, n_ct, N] symmetric ciphertext words
    w_lo: torch.Tensor
    pad_c0: torch.Tensor   # int32[rows, n_ct, L, N] provisioned pad residues
    pad_c1: torch.Tensor
    ctx: Any

    def retranscipher(self, row: int, w_hi, w_lo):
        """Transcipher one (journal-sourced) symmetric upload against upload
        row `row`'s pad — the replay half of the HHE fold."""
        return transcipher.retranscipher_decode(
            self.ctx, w_hi, w_lo, self.pad_c0[row], self.pad_c1[row])


@dataclasses.dataclass(frozen=True)
class StreamRoundMeta:
    """One streaming round's public outcome: the RoundMeta the decoder
    needs (surviving = uploads in the released sum) plus the arrival-level
    story — quorum, commit time, dedup/retry/staleness accounting."""

    meta: RoundMeta
    round_index: int
    cohort: tuple[int, ...]
    quorum: int
    committed: bool          # round released (False = degraded)
    degraded_reason: str | None  # None | "quorum" | "host_quorum" | "dp_floor"
    fresh: int               # this round's cohort arrivals folded
    stale_folded: int        # carried uploads folded this round
    carried: int             # uploads carried into the NEXT round
    stale_excluded: int      # late uploads dropped past the budget
    unreachable: int         # deliveries lost with retries exhausted
    arrivals: int            # deliveries received (incl. duplicates)
    duplicates: int          # deduped redeliveries
    rejected: int            # arrivals the sanitizer rejected
    retries: int             # redelivery attempts made
    commit_s: float          # simulated time at which the round closed
    hosts: dict | None = None  # the hierarchical engine's uplink story: landed and
                               # missed tiers, host quorum, ship retries and dedups,
                               # tier carries (None on the flat engine)

    def record(self) -> dict:
        """JSON-ready summary for history[r] / the stream_round event."""
        out = {
            "cohort": list(self.cohort),
            "quorum": self.quorum,
            "committed": self.committed,
            "degraded_reason": self.degraded_reason,
            "fresh": self.fresh,
            "stale_folded": self.stale_folded,
            "carried": self.carried,
            "stale_excluded": self.stale_excluded,
            "unreachable": self.unreachable,
            "arrivals": self.arrivals,
            "duplicates": self.duplicates,
            "rejected": self.rejected,
            "retries": self.retries,
            "commit_s": round(self.commit_s, 6),
        }
        if self.hosts is not None:
            out["hosts"] = dict(self.hosts)
        return out


@dataclasses.dataclass(frozen=True)
class _Delivery:
    """One simulated delivery event."""

    t: float
    seq: int
    kind: str            # "fresh" | "stale"
    client: int
    nonce: tuple
    retried: bool = False
    pending: Any = None  # PendingUpload for kind == "stale"


def seed_words(gen: torch.Generator) -> list[int]:
    """The round generator's seed as two uint32 words [hi, lo] — the journal's
    `round_open` key (the shape of JAX's threefry key data)."""
    seed = int(gen.initial_seed())
    return [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF]


class StreamEngine:
    """Round lifecycle driver for streaming quorum aggregation.

    One instance per experiment: it owns the cross-round state (uploads
    carried under the staleness budget, the dedup nonce window) and runs
    each round's arrival simulation against the deterministic fault
    schedule. All waiting is on a virtual clock unless
    StreamConfig.time_scale > 0 maps it onto real sleeping (under the
    hefl.quorum_wait profiler range).
    """

    def __init__(self, stream: StreamConfig, faults=None):
        self.stream = stream
        self.faults = faults
        self._pending: list[PendingUpload] = []   # land next round
        # Sealed host partials that missed their round's ship, carried
        # under host_staleness_rounds.
        self._pending_tiers: list[PendingTierPartial] = []
        self._seen: DedupWindow = DedupWindow()
        # Error-feedback residual rows float32[num_clients, total], lazily
        # zeroed on the first EF round; committed with _pending/_seen.
        self._ef_residual: torch.Tensor | None = None
        # The most recent round's span tree (purely observational).
        self.last_spans: obs_spans.SpanTracer | None = None

    def _retry_times(self, round_index: int, client: int, t0: float) -> list:
        """Redelivery times for a lost upload: exponential backoff with
        deterministic +/- jitter on the stream (seed, round, client, 3),
        starting from the server's miss point (the deadline when one is
        set, else the original send)."""
        s = self.stream
        rng = np.random.default_rng([int(s.seed), int(round_index), int(client), 3])
        t = max(s.deadline_s, t0) if s.deadline_s > 0 else t0
        out = []
        for i in range(s.max_retries):
            back = s.retry_backoff_s * (2.0**i)
            t += back * (1.0 + s.retry_jitter * float(rng.uniform(-1.0, 1.0)))
            out.append(t)
        return out

    def _transcipher_round(self, ctx, pk, packing, uploads, enc_gens, round_index,
                           num_clients, hhe, journaled: bool, client_ids=None):
        """Provision pads + transcipher the round's symmetric uploads (one
        K3 and one K7 launch on CUDA). The pads are encrypted with the
        per-client encryption generators the direct upload would have used
        (`client_uploads` draws them at the full registry count and gathers
        the cohort's), so a replayed round re-derives identical pads.
        -> (_HheRound when `journaled`, else None; Ciphertext [rows, ...])."""
        w_hi, w_lo = uploads
        keys = cipher.derive_client_keys(hhe.key_seed, num_clients)
        if client_ids is not None:
            keys = np.asarray(keys)[np.asarray(client_ids, dtype=np.int64)]
        tracer = obs_spans.current()
        with (tracer.measure("transcipher", uploads=int(w_hi.shape[0]))
              if tracer is not None else contextlib.nullcontext()):
            tc, pad = transcipher.transcipher_batch(
                ctx, packing, pk, w_hi, w_lo, keys, round_index, enc_gens)
        rd = None
        if journaled:
            rd = _HheRound(w_hi=w_hi, w_lo=w_lo, pad_c0=pad.c0, pad_c1=pad.c1, ctx=ctx)
        obs_metrics.counter("hhe.uploads_transciphered").inc(int(w_hi.shape[0]))
        obs_metrics.gauge("hhe.upload_bytes").set(cipher.sym_wire_bytes(packing))
        return rd, tc

    def run_round(self, model, cfg: TrainConfig, ctx, pk, global_params, xs, ys,
                  gen: torch.Generator, round_index: int, dp=None, packing=None,
                  num_real_clients=None, session=None, hhe: HheConfig | None = None):
        """Traced entry point: installs one `obs.spans.SpanTracer` for the
        round (kept as `self.last_spans`), then runs `_run_round_body`."""
        tracer = obs_spans.SpanTracer(int(round_index))
        self.last_spans = tracer
        with obs_spans.activate(tracer):
            return self._run_round_body(
                model, cfg, ctx, pk, global_params, xs, ys, gen, round_index, dp=dp,
                packing=packing, num_real_clients=num_real_clients, session=session, hhe=hhe,
            )

    def _run_round_body(self, model, cfg: TrainConfig, ctx, pk, global_params, xs, ys,
                        gen: torch.Generator, round_index: int, dp=None, packing=None,
                        num_real_clients=None, session=None, hhe=None):
        """-> (Ciphertext sum, metrics [C, E, 4], overflow [C],
        StreamRoundMeta). meta.meta.surviving is the decode denominator; 0
        (or committed=False) means nothing was released this round and the
        driver keeps the global model. Under cohort-only training the
        metrics/overflow rows of unsampled clients are zeros.

        `gen` is the round's generator (its seed is the journal's round key):
        it seeds the per-client training, encryption and DP generators as in
        `secure.client_uploads`. `session` (fl.journal.RoundSession) is the
        durability hook: every engine transition is journaled (live) or
        verified against the journal and — for folds — re-fed the persisted
        upload bytes (replay). With upload_kind "hhe" a journaled fresh fold
        persists the symmetric words and replay re-transciphers them."""
        tracer = obs_spans.current()
        s = self.stream
        if num_real_clients is not None:
            raise ValueError(
                "StreamEngine.run_round: num_real_clients= pads the client axis "
                "onto a multi-device mesh; one device never pads (drop it)"
            )
        hhe_mode = s.upload_kind == "hhe"
        if hhe_mode and packing is None:
            raise ValueError(
                "upload_kind=hhe ships the PACKED quantized update under "
                "the stream cipher; add a PackingConfig (the symmetric "
                "cipher lives in the packed integer domain)"
            )
        if hhe is not None and not hhe_mode:
            raise ValueError("an HheConfig is given but StreamConfig.upload_kind is not 'hhe'")
        if hhe_mode and hhe is None:
            hhe = HheConfig()
        if hhe_mode:
            # Round-setup range proof: the keystream subtract stays
            # carry-free inside the guard band, or the round refuses to run.
            guard_bits = packing.guard - max(packing.clients - 1, 0).bit_length()
            cert = ranges.certify_transciphering(
                int(ctx.modulus), packing.bits, packing.k, packing.clients, guard_bits)
            if not cert.ok:
                raise ValueError(
                    "upload_kind=hhe rejected by static range analysis — "
                    f"{cert.summary()}"
                )
        # The fold's invariant (closed form of the JAX package's inductive
        # certificate) and, on a packed round, its headroom-capped sum.
        max_prime = int(np.asarray(ctx.ntt.p).max())
        fold_cert = (ranges.certify_fold(max_prime, packing, int(ctx.modulus))
                     if packing is not None else ranges.certify_fold(max_prime))
        if not fold_cert.ok:
            raise ValueError(
                "streaming fold rejected by static range analysis — "
                f"{fold_cert.summary()}"
            )
        if dp is not None and s.staleness_rounds > 0:
            raise ValueError(
                "dp cannot be combined with a staleness budget "
                f"(staleness_rounds={s.staleness_rounds}): a carried "
                "upload gives one client 2x the accounted per-round "
                "sensitivity and breaks cohort-subsampling amplification "
                "— set staleness_rounds=0 for dp runs"
            )
        if dp is not None and s.host_staleness_rounds > 0:
            raise ValueError(
                "dp cannot be combined with a tier staleness budget "
                f"(host_staleness_rounds={s.host_staleness_rounds}): a "
                "carried host partial re-releases its client folds in a "
                "later round, giving each 2x the accounted per-round "
                "sensitivity and breaking cohort-subsampling amplification "
                "— set host_staleness_rounds=0 for dp runs"
            )
        ef_on = packing is not None and packing.error_feedback
        if dp is not None and ef_on:
            raise ValueError(
                "dp cannot be combined with error-feedback packing "
                "(PackedSpec.error_feedback): the residual carries round "
                "r's signal into round r+1's upload, giving a client "
                "cross-round influence the per-round sensitivity "
                "accounting does not cover and breaking cohort-subsampling "
                "amplification — drop error_feedback for dp runs"
            )
        num_clients = int(xs.shape[0])
        device = xs.device
        cohort = sample_cohort(s, round_index, num_clients)
        in_cohort = np.zeros(num_clients, dtype=bool)
        in_cohort[cohort] = True
        qcount = quorum_count(s, len(cohort))
        tau = int(s.staleness_rounds)
        if session is not None:
            # WAL discipline: the round's identity is durable before any work.
            session.round_open(
                round_index, seed_words(gen), cohort, qcount, tau, num_clients,
                int(packing.clients) if packing is not None else None,
            )

        if self.faults is not None:
            sched = schedule_for_round(self.faults, round_index, num_clients)
            arr = schedule_arrivals(self.faults, round_index, num_clients)
        else:
            sched = arr = None
        dropped = sched.dropped if sched is not None else np.zeros(num_clients, bool)
        part = (in_cohort & ~dropped).astype(np.int32)
        pois = (np.where(in_cohort, sched.poison, 0).astype(np.int32)
                if sched is not None else None)

        # Cohort-only training: only the cohort's slots train (cohort-rowed
        # outputs; `row_of` maps client -> upload row); a full cohort keeps
        # the full-C shapes bit for bit.
        use_cohort = bool(s.cohort_only) and len(cohort) < num_clients
        hhe_keys = cipher.derive_client_keys(hhe.key_seed, num_clients) if hhe_mode else None
        ef_full = None
        if ef_on:
            # Lazy zero-init of the residual rows: one a REGISTERED client.
            total = int(packing.total)
            if (self._ef_residual is None or tuple(self._ef_residual.shape) != (num_clients, total)
                    or self._ef_residual.device != device):
                self._ef_residual = init_ef_residuals(global_params, num_clients).to(device)
            ef_full = self._ef_residual
        cts, mets_rows, overflow_rows, _, enc_gens, bits_rows, *ef_tail = client_uploads(
            model, cfg, ctx, pk, global_params, xs, ys, gen, packing=packing,
            hhe_keys=hhe_keys, round_index=round_index, dp=dp, participation=part,
            poison=pois, want_bits=True, cohort=cohort if use_cohort else None,
            ef_residual=ef_full,
        )
        rows = cohort if use_cohort else np.arange(num_clients)
        row_of = np.full(num_clients, -1, dtype=np.int64)
        row_of[rows] = np.arange(len(rows))
        ef_next = None
        if ef_on:
            # The residual updates at PRODUCTION time: the client quantized
            # this upload through the old residual whatever becomes of the
            # upload. Staged here, committed with the cross-round state.
            ef_next = ef_full.clone()
            ef_next[torch.from_numpy(rows).to(device)] = ef_tail[0]
        hhe_rd = None
        if hhe_mode:
            hhe_rd, cts = self._transcipher_round(
                ctx, pk, packing, cts, enc_gens, round_index, num_clients, hhe,
                journaled=session is not None, client_ids=rows if use_cohort else None,
            )
        bits_host = bits_rows.cpu().numpy().astype(np.int64)
        if use_cohort:
            # Registry-indexed metadata: unsampled clients trained nothing.
            mets = torch.zeros((num_clients,) + tuple(mets_rows.shape[1:]),
                               dtype=mets_rows.dtype, device=mets_rows.device)
            mets[torch.from_numpy(rows).to(mets.device)] = mets_rows
            overflow = torch.zeros((num_clients,) + tuple(overflow_rows.shape[1:]),
                                   dtype=overflow_rows.dtype, device=overflow_rows.device)
            overflow[torch.from_numpy(rows).to(overflow.device)] = overflow_rows
            bits = np.zeros(num_clients, np.int64)
            bits[rows] = bits_host
        else:
            mets, overflow, bits = mets_rows, overflow_rows, bits_host.copy()
        # The program's sanitizer verdict, immutable: the arrival-time reject
        # predicate reads THIS, not the attribution copy below.
        prog_bits = bits.copy()
        # A client that simply was not sampled is attributed "unsampled".
        bits[~in_cohort] = EXCLUDED_UNSAMPLED
        c0, c1 = cts.c0, cts.c1            # cohort-rowed when use_cohort
        row_shape = tuple(c0.shape[1:])

        # Cross-round state is COMMITTED only at the end of a successful
        # round (transactional): a round that dies mid-execution leaves the
        # carried uploads and the dedup window untouched for the retry.
        seen = self._seen.advanced(round_index, tau)
        pending_next: list[PendingUpload] = []

        # ---- build this round's delivery timeline ------------------------
        events: list[_Delivery] = []
        seq = 0
        retries_made = 0
        unreachable = 0
        for up in self._pending:
            events.append(_Delivery(t=float(up.lands_at), seq=seq, kind="stale",
                                    client=up.client, nonce=up.nonce, pending=up))
            seq += 1
        for c in cohort:
            if part[c] == 0:
                continue   # scheduled out: never uploads
            nonce = (int(c), int(round_index))
            t0 = float(arr.arrival_s[c]) if arr is not None else 0.0
            permanent = bool(arr is not None and arr.permanent[c])
            transient = bool(arr is not None and arr.transient[c])
            if permanent:
                # Every delivery fails; the engine still pays the retries.
                times = self._retry_times(round_index, c, t0)
                retries_made += len(times)
                if session is not None:
                    for i, rt in enumerate(times):
                        session.retry(round_index, c, nonce, i + 1, rt)
                if tracer is not None:
                    for i, rt in enumerate(times):
                        tracer.add("retry", float(rt), client=int(c), attempt=i + 1,
                                   delivered=False)
                bits[c] |= EXCLUDED_UNREACHABLE
                unreachable += 1
                continue
            if transient:
                retry_at = self._retry_times(round_index, c, t0)
                if not retry_at:
                    bits[c] |= EXCLUDED_UNREACHABLE
                    unreachable += 1
                    continue
                retries_made += 1
                if session is not None:
                    session.retry(round_index, c, nonce, 1, retry_at[0])
                if tracer is not None:
                    tracer.add("retry", float(retry_at[0]), client=int(c), attempt=1,
                               delivered=True)
                events.append(_Delivery(t=float(retry_at[0]), seq=seq, kind="fresh",
                                        client=int(c), nonce=nonce, retried=True))
                seq += 1
                continue
            events.append(_Delivery(t=t0, seq=seq, kind="fresh", client=int(c), nonce=nonce))
            seq += 1
            if arr is not None and arr.duplicate[c]:
                events.append(_Delivery(t=t0 + max(s.retry_backoff_s * 0.5, 1e-6), seq=seq,
                                        kind="fresh", client=int(c), nonce=nonce))
                seq += 1

        # ---- process arrivals in time order ------------------------------
        deadline = s.deadline_s if s.deadline_s > 0 else float("inf")
        hier = s.num_hosts >= 2
        if hier:
            # The two-tier fold (lazy import: hierarchy imports this module);
            # the link-fault schedule and the ship policy ride into it.
            from hefl_tpu_torch.fl.hierarchy import HierarchicalAggregator, ShipPolicy

            link = None
            if self.faults is not None and self.faults._any_link_fault():
                if int(self.faults.num_hosts) != int(s.num_hosts):
                    raise ValueError(
                        f"FaultConfig.num_hosts={self.faults.num_hosts} does "
                        f"not match StreamConfig.num_hosts={s.num_hosts}: "
                        "the link-fault schedule would fault the uplinks of "
                        "a different fold-tree topology"
                    )
                link = schedule_links(self.faults, round_index)
            acc = HierarchicalAggregator(
                ctx.ntt.p, s.num_hosts, num_clients, round_index=round_index, link=link,
                ship=ShipPolicy(deadline_s=float(s.ship_deadline_s),
                                max_retries=int(s.max_retries),
                                backoff_s=float(s.retry_backoff_s),
                                jitter=float(s.retry_jitter), seed=int(s.seed)),
            )
            host_of = host_of_clients(num_clients, s.num_hosts)
        else:
            acc = OnlineAccumulator(ctx.ntt.p)
            host_of = None
        # ---- stale tier folds --------------------------------------------
        # Host partials that missed an earlier round's ship fold at THIS
        # round's root before any arrival; acc.folded counts their client
        # folds, so quorum, headroom and dp accounting see them.
        tier_stale_folded = 0
        tier_stale_clients: list[int] = []
        if hier:
            for tp in self._pending_tiers:
                if session is not None:
                    session.tier_fold(round_index, tp.host, tp.origin_round, tp.sha,
                                      len(tp.clients), tp.lateness)
                if acc.fold_carried(tp.host, tp.origin_round, _residues(tp.c0, device),
                                    _residues(tp.c1, device), tp.sha, len(tp.clients)):
                    tier_stale_folded += 1
                    tier_stale_clients.extend(int(c) for c in tp.clients)
                    for tc in tp.clients:
                        bits[int(tc)] &= ~EXCLUDED_UNSAMPLED
                    if tracer is not None:
                        tracer.add("tier_fold", 0.0, host=int(tp.host),
                                   origin_round=int(tp.origin_round),
                                   clients=len(tp.clients), lateness=int(tp.lateness))
        staleness_hist = obs_metrics.histogram("stream.staleness_rounds")
        committed_at: float | None = None
        fresh = stale_folded = arrivals = rejected = 0
        stale_excluded = 0
        headroom_blocked = 0
        folded_clients: list[int] = []
        fresh_used: list[tuple] = []   # (client, t) folded fresh this round
        stale_used: list[tuple] = []   # (PendingUpload, t) folded stale
        missed: list[tuple] = []       # (kind, client, t, lateness, c0, c1, nonce)
        # Packed uploads share carry-free headroom sized for `clients` field
        # summands; EVERY fold — fresh or stale — must respect it. A fresh
        # upload blocked by headroom takes the missed path.
        max_folds = int(packing.clients) if packing is not None else None
        last_t = 0.0
        for ev in sorted(events, key=lambda e: (e.t, e.seq)):
            last_t = max(last_t, ev.t)
            headroom_ok = max_folds is None or acc.folded < max_folds
            if ev.kind == "stale":
                up = ev.pending
                if committed_at is None and headroom_ok:
                    if session is not None:
                        # Content hash only: the bytes are already durable in
                        # the origin round's carry record.
                        session.fold(round_index, ev.seq, "stale", up.client, up.nonce,
                                     up.lateness, ev.t, up.c0, up.c1, persist=False)
                    acc.fold(("stale",) + up.nonce, _residues(up.c0, device),
                             _residues(up.c1, device))
                    stale_folded += 1
                    folded_clients.append(up.client)
                    stale_used.append((up, ev.t))
                    if tracer is not None:
                        tracer.add("fold", ev.t, client=int(up.client), src="stale",
                                   lateness=int(up.lateness))
                    obs_metrics.histogram(
                        "stream.arrival_to_fold_s", bounds=_ARRIVAL_TO_FOLD_BUCKETS,
                    ).observe(round(max(0.0, float(ev.t)), 9))
                    # The client participates via its late upload; clear ONLY
                    # the not-in-this-cohort attribution.
                    bits[up.client] &= ~EXCLUDED_UNSAMPLED
                    staleness_hist.observe(up.lateness)
                else:
                    if committed_at is None and not headroom_ok:
                        headroom_blocked += 1
                    if session is not None:
                        session.miss(round_index, ev.seq, "stale", up.client, up.nonce, ev.t,
                                     up.lateness)
                    missed.append(("stale", up.client, ev.t, up.lateness, up.c0, up.c1,
                                   up.nonce))
                continue
            arrivals += 1
            if ev.nonce in seen:
                if session is not None:
                    session.dedup(round_index, ev.seq, ev.client, ev.nonce)
                acc.duplicates += 1
                if tracer is not None:
                    tracer.add("arrival", ev.t, client=int(ev.client), outcome="duplicate",
                               retried=bool(ev.retried))
                continue
            seen.add(ev.nonce)
            c = ev.client
            if prog_bits[c] & _REJECT_MASK:
                if session is not None:
                    session.reject(round_index, ev.seq, c, ev.nonce)
                rejected += 1
                if tracer is not None:
                    tracer.add("arrival", ev.t, client=int(c), outcome="rejected",
                               retried=bool(ev.retried))
                continue
            row = int(row_of[c])    # upload row (== c on the full-C path)
            if committed_at is None and (ev.t <= deadline or ev.retried) and headroom_ok:
                fc0, fc1 = c0[row], c1[row]
                if session is not None:
                    # Persist the arrived upload; on replay the session hands
                    # back the JOURNAL's bytes (content-hash verified against
                    # this re-derived upload) and the fold re-folds them.
                    if hhe_rd is not None:
                        # HHE uploads persist the SYMMETRIC words (the wire
                        # artifact); replay re-transciphers the journal's.
                        wh, wl = hhe_rd.w_hi[row], hhe_rd.w_lo[row]
                        rh, rl = session.fold(round_index, ev.seq, "fresh", c, ev.nonce, 0,
                                              ev.t, wh, wl, persist=True)
                        if rh is not wh:
                            fc0, fc1 = hhe_rd.retranscipher(row, rh, rl)
                    else:
                        fc0, fc1 = session.fold(round_index, ev.seq, "fresh", c, ev.nonce, 0,
                                                ev.t, c0[row], c1[row], persist=True)
                acc.fold(ev.nonce, _residues(fc0, device), _residues(fc1, device))
                fresh += 1
                folded_clients.append(c)
                fresh_used.append((c, ev.t))
                staleness_hist.observe(0)
                if tracer is not None:
                    arr_sp = tracer.add("arrival", ev.t, client=int(c), outcome="folded",
                                        retried=bool(ev.retried))
                    tracer.add("fold", ev.t, parent=arr_sp, client=int(c), src="fresh")
                obs_metrics.histogram(
                    "stream.arrival_to_fold_s", bounds=_ARRIVAL_TO_FOLD_BUCKETS,
                ).observe(round(max(0.0, float(ev.t)), 9))
                if fresh >= qcount:
                    committed_at = ev.t
            else:
                if committed_at is None and not headroom_ok:
                    headroom_blocked += 1
                if session is not None:
                    session.miss(round_index, ev.seq, "fresh", c, ev.nonce, ev.t, 0)
                missed.append(("fresh", c, ev.t, 0, c0[row], c1[row], ev.nonce))
                if tracer is not None:
                    tracer.add("arrival", ev.t, client=int(c), outcome="missed",
                               retried=bool(ev.retried))
        committed = committed_at is not None
        commit_s = (committed_at if committed
                    else min(max(last_t, 0.0), deadline) if events else 0.0)
        degraded_reason = None if committed else "quorum"

        # ---- hierarchical ship phase -------------------------------------
        # The client-quorum commit point launches every nonempty tier's ship
        # onto its uplink; the round then re-takes its verdict at the tier
        # level: fewer than host_quorum landed tiers (or an empty released
        # sum) degrades it like a missed client quorum.
        host_tau = int(s.host_staleness_rounds)
        pending_tiers_next: list[PendingTierPartial] = []
        tier_carried = 0
        tier_stale_excluded = 0
        missed_hosts: set[int] = set()
        hq = 0
        released: int | None = None
        if hier and committed:
            acc.ship_all(t0=float(committed_at))
            if session is not None:
                for sh_h, sh_att, sh_t, sh_lost in acc.ship_log:
                    if sh_att > 1:
                        session.ship_retry(round_index, sh_h, sh_att, sh_t, sh_lost)
            nonempty = int(acc.nonempty_tiers)
            hq = max(1, math.ceil(s.host_quorum * nonempty)) if nonempty else 0
            missed_hosts = {h for h, _cz in acc.missed_ships}
            # Per-cause attribution of every client whose tier missed.
            for mh, cause in acc.missed_ships:
                cbit = EXCLUDED_HOST_TIMEOUT if cause == "timeout" else EXCLUDED_HOST_UNREACHABLE
                for c in folded_clients:
                    if int(host_of[c]) == int(mh):
                        bits[int(c)] |= cbit
            released = (sum(1 for c in folded_clients if int(host_of[c]) not in missed_hosts)
                        + len(tier_stale_clients))
            if len(acc.landed_hosts) < hq:
                committed = False
                degraded_reason = "host_quorum"
                obs_metrics.counter("stream.host_quorum_degraded").inc()
            elif released <= 0:
                committed = False
                degraded_reason = "quorum"
        # DP surviving-cohort floor: a release holding fewer uploads than the
        # declared noise-calibration floor degrades instead of releasing.
        if dp is not None and committed:
            n_rel = released if released is not None else acc.folded
            if n_rel < calibration_clients(dp, num_clients):
                committed = False
                degraded_reason = "dp_floor"
                obs_metrics.counter("stream.dp_floor_degraded").inc()
        if committed and missed_hosts:
            # The round commits WITHOUT the missed tiers: each sealed
            # partial carries under the tier staleness budget.
            for mh, _cause in acc.missed_ships:
                pc0, pc1, psha, _nf = acc.take_late_partial(mh)
                t_clients = tuple(int(c) for c in folded_clients if int(host_of[c]) == int(mh))
                if host_tau >= 1 and t_clients:
                    pending_tiers_next.append(PendingTierPartial(
                        host=int(mh), origin_round=int(round_index), sha=psha, c0=pc0, c1=pc1,
                        clients=t_clients, lateness=1,
                    ))
                    tier_carried += 1
        surviving = 0
        if committed:
            surviving = int(released if released is not None else acc.folded)
        if tracer is not None:
            tracer.add("commit", float(commit_s), committed=bool(committed),
                       degraded_reason=degraded_reason, surviving=int(surviving),
                       fresh=int(fresh), quorum=int(qcount))
        if committed:
            obs_metrics.histogram(
                "stream.commit_latency_s", bounds=_COMMIT_LATENCY_BUCKETS
            ).observe(round(float(commit_s), 9))
        if session is not None:
            # The transaction's verdict record. On replay the re-derived
            # canonical-sum sha256 must MATCH the journaled one.
            if committed:
                sc0, sc1 = acc.value(like_shape=row_shape, device=device)
                session.commit(round_index, ct_hash(sc0, sc1), surviving, fresh,
                               stale_folded, commit_s)
            else:
                session.degrade(round_index, degraded_reason, fresh, qcount)

        # ---- misses: carry under the staleness budget, or drop -----------
        carried = 0
        for kind, c, t, lateness, mc0, mc1, nonce in missed:
            next_late = lateness + 1
            if next_late <= tau:
                pending_next.append(PendingUpload(
                    client=int(c), origin_round=int(nonce[-1]), nonce=nonce,
                    c0=_residues(mc0, device).clone(), c1=_residues(mc1, device).clone(),
                    lands_at=max(0.0, float(t) - float(commit_s)), lateness=next_late,
                ))
                carried += 1
                if kind == "fresh":
                    bits[c] |= EXCLUDED_TIMEOUT
            else:
                if kind == "fresh":
                    bits[c] |= EXCLUDED_TIMEOUT
                else:
                    bits[c] |= EXCLUDED_STALE
                    stale_excluded += 1
        if not committed:
            # Degraded round: the accumulator is discarded, but an upload that
            # FOLDED into it was delivered in good faith — re-carry it under
            # the staleness budget, and attribute what cannot carry.
            for up, t in stale_used:
                next_late = up.lateness + 1
                if next_late <= tau:
                    pending_next.append(PendingUpload(
                        client=up.client, origin_round=up.origin_round, nonce=up.nonce,
                        c0=up.c0, c1=up.c1, lands_at=max(0.0, float(t) - float(commit_s)),
                        lateness=next_late,
                    ))
                    carried += 1
                    bits[up.client] |= EXCLUDED_TIMEOUT
                else:
                    bits[up.client] |= EXCLUDED_STALE
                    stale_excluded += 1
            for c, t in fresh_used:
                bits[c] |= EXCLUDED_TIMEOUT
                if tau >= 1:
                    r_c = int(row_of[c])
                    pending_next.append(PendingUpload(
                        client=int(c), origin_round=int(round_index),
                        nonce=(int(c), int(round_index)),
                        c0=c0[r_c].clone(), c1=c1[r_c].clone(),
                        lands_at=max(0.0, float(t) - float(commit_s)), lateness=1,
                    ))
                    carried += 1
            # Carried tier partials folded into the discarded accumulator
            # (or still pending) carry one round deeper under the tier
            # budget; past it their clients are excluded as host_stale.
            for tp in self._pending_tiers:
                next_late = tp.lateness + 1
                if next_late <= host_tau:
                    pending_tiers_next.append(dataclasses.replace(tp, lateness=next_late))
                    tier_carried += 1
                    for tc in tp.clients:
                        bits[int(tc)] |= EXCLUDED_HOST_TIMEOUT
                else:
                    for tc in tp.clients:
                        bits[int(tc)] |= EXCLUDED_HOST_STALE
                    tier_stale_excluded += 1

        # ---- public metadata + observability -----------------------------
        hosts_rec = None
        if hier:
            hosts_rec = {
                "nonempty": int(acc.nonempty_tiers),
                "landed": [int(h) for h in acc.landed_hosts],
                "missed": [[int(h), str(cz)] for h, cz in acc.missed_ships],
                "host_quorum": int(hq),
                "ship_retries": int(acc.ship_retries),
                "ship_lost": int(acc.ship_lost),
                "ship_deduped": int(acc.ship_deduped),
                "tier_carried": int(tier_carried),
                "tier_stale_folded": int(tier_stale_folded),
                "tier_stale_excluded": int(tier_stale_excluded),
                "ships_done_s": round(float(acc.ships_done_s), 6),
            }
            obs_metrics.counter("dcn.tier.carried").inc(tier_carried)
            obs_metrics.counter("dcn.tier.stale_folded").inc(tier_stale_folded)
            obs_metrics.counter("dcn.tier.stale_excluded").inc(tier_stale_excluded)
        participation = np.zeros(num_clients, np.int32)
        if committed:
            rel_clients = [c for c in folded_clients
                           if host_of is None or int(host_of[c]) not in missed_hosts]
            rel_clients += tier_stale_clients
            if rel_clients:
                participation[np.asarray(rel_clients, dtype=int)] = 1
        meta = RoundMeta(
            num_clients=num_clients,
            bits=tuple(int(v) for v in bits),
            participation=tuple(int(v) for v in participation),
            surviving=int(surviving),
            excluded={name: int(np.count_nonzero(bits & flag))
                      for name, flag in EXCLUSION_CAUSES.items()},
            sanitized=True,
        )
        smeta = StreamRoundMeta(
            meta=meta, round_index=int(round_index), cohort=tuple(int(c) for c in cohort),
            quorum=qcount, committed=committed, degraded_reason=degraded_reason, fresh=fresh,
            stale_folded=stale_folded, carried=carried, stale_excluded=stale_excluded,
            unreachable=unreachable, arrivals=arrivals, duplicates=acc.duplicates,
            rejected=rejected, retries=retries_made, commit_s=float(commit_s),
            hosts=hosts_rec,
        )
        obs_metrics.counter("stream.arrivals").inc(arrivals)
        obs_metrics.counter("stream.duplicates").inc(acc.duplicates)
        obs_metrics.counter("stream.rejected").inc(rejected)
        obs_metrics.counter("stream.folds").inc(fresh + stale_folded)
        obs_metrics.counter("stream.retries").inc(retries_made)
        obs_metrics.counter("stream.late_carried").inc(carried)
        obs_metrics.counter("stream.stale_excluded").inc(stale_excluded)
        obs_metrics.counter("stream.headroom_blocked").inc(headroom_blocked)
        if not committed:
            obs_metrics.counter("stream.degraded_rounds").inc()
        obs_events.emit("stream_round", round=round_index, **smeta.record())
        if hier and committed:
            # One cross-region traffic summary per committed round: the ship
            # phase sealed the tree, so the counters are final.
            obs_events.emit("dcn_round", round=round_index, **acc.report())
        obs_events.emit("quorum_wait", round=round_index, seconds=round(float(commit_s), 6),
                        quorum=qcount, fresh=fresh, committed=committed)
        if s.time_scale > 0 and commit_s > 0:
            # Map simulated waiting onto wall-clock as a named host range.
            with torch.profiler.record_function(obs_scopes.QUORUM_WAIT):
                time.sleep(float(commit_s) * s.time_scale)

        if session is not None:
            # Stale carries (payload-bearing) and the round_close seal — the
            # durable half of the transactional state commit below.
            for up in pending_next:
                session.carry(round_index, up.client, up.origin_round, up.nonce, up.lands_at,
                              up.lateness, up.c0, up.c1)
            for tp in pending_tiers_next:
                # Payload-bearing like carry: a carried partial survives a
                # crash without its origin round's tier journals.
                session.tier_carry(round_index, tp.host, tp.origin_round, tp.clients,
                                   tp.lateness, tp.c0, tp.c1)
            session.close(round_index, committed, surviving, meta.excluded, seen)

        # Commit the transactional cross-round state.
        self._pending = pending_next
        self._pending_tiers = pending_tiers_next
        self._seen = seen
        if ef_on:
            self._ef_residual = ef_next
        obs_metrics.gauge("stream.dedup_window_peak").set(seen.peak_entries)

        if committed:
            sum_c0, sum_c1 = acc.value(like_shape=row_shape, device=device)
        else:
            # Below quorum nothing is released: an encryption of zero, NOT
            # the partial sum.
            sum_c0 = torch.zeros(row_shape, dtype=torch.int32, device=device)
            sum_c1 = torch.zeros(row_shape, dtype=torch.int32, device=device)
        ct_sum = Ciphertext(c0=sum_c0, c1=sum_c1, scale=cts.scale)
        if tracer is not None:
            tracer.finish(max(float(commit_s), float(last_t),
                              float(getattr(acc, "ships_done_s", 0.0))))
        return ct_sum, mets, overflow, smeta


def cohort_compare_record(
    model, cfg: TrainConfig, ctx, pk, global_params: dict, xs: torch.Tensor, ys: torch.Tensor,
    key_seed: int, num_clients: int, cohort_size: int, seed: int = 0,
) -> dict:
    """Timed full-C-vs-cohort-only upload producers (the JAX package's
    `cohort_compare_record`): both produce the SAME sampled cohort's
    uploads through `secure.client_uploads`, the full-C run training every
    registered client (the unsampled ones scheduled out), the cohort run
    gathering the cohort bucket first. Each producer run draws from a fresh
    generator seeded `key_seed`, so both see the same streams. Speedup is
    warm wall clock (`roofline.steady_seconds`); `bitwise_equal` folds the
    cohort's uploads from both producers into `OnlineAccumulator`s and
    compares the sums' `ct_hash`, with both runs under deterministic
    algorithms (`experiment.deterministic_algorithms`)."""
    from hefl_tpu_torch.experiment import deterministic_algorithms
    from hefl_tpu_torch.fl.fedavg import cohort_bucket
    from hefl_tpu_torch.utils.roofline import steady_seconds

    cohort = sample_cohort(StreamConfig(cohort_size=cohort_size, seed=seed), 0, num_clients)
    part = np.zeros(num_clients, dtype=np.int32)
    part[cohort] = 1
    last: dict = {}   # each producer's final uploads, for the hash gate

    def run(tag, cohort_arg):
        last[tag] = client_uploads(model, cfg, ctx, pk, global_params, xs, ys,
                                   torch.Generator().manual_seed(int(key_seed)),
                                   participation=part, cohort=cohort_arg)[0]

    with deterministic_algorithms():
        t_full = steady_seconds(lambda: run("full", None))
        t_cohort = steady_seconds(lambda: run("cohort", cohort))
    acc_full, acc_coh = OnlineAccumulator(ctx.ntt.p), OnlineAccumulator(ctx.ntt.p)
    full, coh = last["full"], last["cohort"]
    for i, c in enumerate(cohort):
        acc_full.fold((int(c), 0), full.c0[c], full.c1[c])
        acc_coh.fold((int(c), 0), coh.c0[i], coh.c1[i])
    return {
        "num_clients": int(num_clients),
        "cohort_size": int(len(cohort)),
        "bucket": int(cohort_bucket(len(cohort), num_clients)),
        "full_c_train_s": round(t_full, 6),
        "cohort_train_s": round(t_cohort, 6),
        "speedup": round(t_full / t_cohort, 3),
        "devices_per_axis": {"clients": 1, "ct": 1},
        "bitwise_equal": ct_hash(*acc_full.value()) == ct_hash(*acc_coh.value()),
    }


def cohort_compare_smoke_record(device=None) -> dict:
    """`cohort_compare_record` at the JAX package's FIXED geometry: 16
    registered clients, a cohort of 2, SmallCNN on mnist (64 train images)
    at N = 256 — a record of training scaling, not of ring cost. Runs on
    `device` (CUDA unless given); the per-client loop trains each client
    alone ("vmap"), so both producers run the same kernels on the same
    shapes."""
    from hefl_tpu_torch import resolve_device
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen
    from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
    from hefl_tpu_torch.data.synthetic import make_dataset
    from hefl_tpu_torch.models import create_model

    device = resolve_device(device)
    model = create_model("smallcnn", gen=torch.Generator().manual_seed(7), device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    (x, y), _, _ = make_dataset("mnist", seed=0, n_train=64, n_test=8)
    xs, ys = stack_federated(x, y, iid_contiguous(len(x), 16))
    ctx = CkksContext.create(n=256)
    _, pk = keygen(ctx, torch.Generator().manual_seed(77), device=device)
    cfg = TrainConfig(epochs=1, batch_size=8, num_classes=10, augment=False, val_fraction=0.25,
                      client_fusion="vmap")
    return cohort_compare_record(
        model, cfg, ctx, pk, params, torch.from_numpy(xs).to(device),
        torch.from_numpy(ys).to(device), 78, num_clients=16, cohort_size=2)
