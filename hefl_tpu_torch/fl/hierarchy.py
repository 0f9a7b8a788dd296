"""Hierarchical aggregation: each host folds its own clients, then ships ONE
partial ciphertext to the root.

Counterpart of `hefl_tpu.fl.hierarchy`. The flat service folds every cohort
upload at one root, so the cross-region link carries one ciphertext per
client a round. Modular addition over canonical residues is associative and
commutative, so each host (a region) can fold its LOCAL block of the cohort
with the same `OnlineAccumulator` the flat service uses — on the device —
and ship one partial sum upward: cross-region traffic grows with the hosts,
not with the clients.

`HierarchicalAggregator` is that two-tier fold tree, with the engine's
accumulator contract (`fold(nonce, c0, c1)`, `folded`, `duplicates`,
`value(like_shape)`), so `StreamEngine.run_round` swaps it in when
`StreamConfig.num_hosts >= 2`:

  * **Placement**: `parallel.host_of_clients`, the contiguous-block layout
    the regional-outage schedule (`fl.faults`) shares.
  * **Certified equality**: construction refuses to run unless
    `analysis.ranges.certify_fold_tree` holds (the fold loop's invariant
    plus: tier partials canonical, tree == flat bitwise, carried partials
    one more instance of the loop).
  * **Per-tier journals**: with a `journal_dir`, each tier fold appends a
    `tier_fold` record (ciphertext body + sha) to that host's own
    `tier{h}.wal` BEFORE the fold, each ship attempt a `tier_ship` record
    there, and the root a `root_fold` record to `root.wal` — so a crashed
    tier recovers from ITS journal alone: construction re-folds the
    journaled bodies (nonce dedup makes replay idempotent), verifies a
    shipped partial's sha, and re-ships a partial whose `tier_ship` landed
    but whose `root_fold` did not. The framing is `fl.journal`'s, so the
    WALs are byte for byte the JAX package's on the same uploads.
  * **Simulated cross-region accounting**: each ship adds to
    `dcn.link.h{h}_root.bytes` and `dcn.hier.bytes`; each fold adds what
    the flat topology would have shipped to `dcn.flat.bytes`; `report()`
    is the round's traffic summary (`parallel.dcn_traffic_model`'s).

Faulty uplinks: `ship_all(t0)` runs each tier's ship as a delivery timeline
on the engine's virtual clock. The first delivery lands at t0 plus the
uplink's scheduled delay (`fl.faults.LinkFaults`); a LOST delivery is
redelivered with exponential backoff and deterministic per-(round, host,
attempt) jitter (`ShipPolicy`); every attempt journals a `tier_ship`
record; the root dedups deliveries by (host, round, sha), so a retried,
duplicated or re-shipped partial never folds twice. A first delivery past
the ship deadline misses the round ("timeout"; retried deliveries are
exempt), a dark uplink loses every delivery ("unreachable"). A missed
tier's sealed partial is kept (`take_late_partial`) for the engine to fold
at a later round's root (`fold_carried`).

`dcn_compare_record` folds the same uploads flat and hierarchically in
several arrival orders with a duplicate storm and hash-compares the
results; `dcn_compare_smoke_record` runs it at a fixed small geometry, and
`python -m hefl_tpu_torch.fl.hierarchy` writes that record as
BENCH_TORCH_DCN.json (on CUDA unless `--device` names another).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from hefl_tpu_torch import resolve_device
from hefl_tpu_torch.fl import journal as jr
from hefl_tpu_torch.fl.faults import SimulatedCrash
from hefl_tpu_torch.fl.stream import OnlineAccumulator, ct_hash
from hefl_tpu_torch.obs import events as obs_events
from hefl_tpu_torch.obs import metrics as obs_metrics
from hefl_tpu_torch.obs import spans as obs_spans
from hefl_tpu_torch.parallel import dcn_link_names, host_of_clients

# dcn.ship_rtt_s histogram bounds (virtual seconds): commit point -> the
# partial landing at the root, per landed tier (delay + retry backoff).
_SHIP_RTT_BUCKETS = (0.01, 0.1, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0)

# The injectable tier-crash boundaries, in tier-lifecycle order: "mid_fold"
# dies MID-write of the Nth tier_fold frame (a real torn record on that
# tier's journal); "post_fold" after that frame landed; "pre_ship" between
# the tier's last fold and its ship (no tier_ship record: recovery re-folds
# and ships fresh); "post_ship" after tier_ship landed but before the root
# saw the partial (recovery re-ships without double-folding).
TIER_CRASH_POINTS = ("mid_fold", "post_fold", "pre_ship", "post_ship")


def _nbytes(x) -> int:
    """Wire bytes of one residue array: 4 a word, as uint32."""
    return int(x.numel() if isinstance(x, torch.Tensor) else np.asarray(x).size) * 4


def _copy(x):
    return x.clone() if isinstance(x, torch.Tensor) else np.array(x)


@dataclasses.dataclass(frozen=True)
class TierCrash:
    """Deterministic crash injection for one host tier: raise SimulatedCrash
    at the configured boundary of host `host`'s tier lifecycle, after
    writing any torn prefix. A recovering process builds the aggregator
    over the same journal_dir with crash=None and must reach the bitwise
    state of an uninterrupted run."""

    host: int = 0
    at: str = "pre_ship"
    after_folds: int = 1
    torn_bytes: int = 24

    def __post_init__(self):
        if self.at not in TIER_CRASH_POINTS:
            raise ValueError(
                f"TierCrash.at={self.at!r}: must be one of {TIER_CRASH_POINTS}"
            )
        if self.host < 0:
            raise ValueError("TierCrash.host must be >= 0")
        if self.after_folds < 1:
            raise ValueError("TierCrash.after_folds must be >= 1")
        if self.torn_bytes < 1:
            raise ValueError("TierCrash.torn_bytes must be >= 1")


@dataclasses.dataclass(frozen=True)
class ShipPolicy:
    """Retry and deadline policy of the tier->root ship timeline. The engine
    builds one from StreamConfig (ship_deadline_s and the shared retry
    knobs) a round; the defaults (no deadline, no retries) ship at once on
    a clean link.

    deadline_s:   ship deadline measured from `ship_all`'s t0 (the round's
                  client-quorum commit point); 0 = none.
    max_retries:  redelivery attempts for a LOST delivery.
    backoff_s:    base backoff between redeliveries (doubles an attempt).
    jitter:       +/- fraction of each backoff, drawn from the
                  deterministic PRNG stream (seed, round, host, 9).
    seed:         that stream's seed (StreamConfig.seed).
    """

    deadline_s: float = 0.0
    max_retries: int = 0
    backoff_s: float = 0.25
    jitter: float = 0.25
    seed: int = 0

    def __post_init__(self):
        for name in ("deadline_s", "max_retries", "backoff_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"ShipPolicy.{name} must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"ShipPolicy.jitter={self.jitter}: must be in [0, 1]")


class HierarchicalAggregator:
    """Two-tier fold tree: one `OnlineAccumulator` a host plus a root fold.

    `fold` routes each upload to its client's host tier (nonce[-2] is the
    client for both fresh `(client, round)` and stale `("stale", client,
    round)` nonces); `folded` counts uploads across the tiers; `value()`
    ships each nonempty tier's partial upward (sealing the tree) and
    returns the root sum, bitwise the flat fold of the same uploads.
    With `journal_dir`, `device` places the bodies a recovery reads back
    from the tier journals (CUDA unless given), so a recovered tier sums on
    the device its live uploads arrive on.
    """

    def __init__(self, p, num_hosts: int, num_clients: int, journal_dir: str | None = None,
                 fsync_policy: str | None = None, crash: TierCrash | None = None,
                 round_index: int = 0, link=None, ship: ShipPolicy | None = None,
                 device=None):
        if num_hosts < 2:
            raise ValueError(
                f"HierarchicalAggregator: num_hosts={num_hosts} — a "
                "hierarchy needs >= 2 hosts (use OnlineAccumulator flat)"
            )
        from hefl_tpu_torch.analysis.ranges import certify_fold_tree

        cert = certify_fold_tree(int(np.asarray(p).max()))
        if not cert.ok:
            raise ValueError(
                "hierarchical fold tree rejected by static range analysis "
                f"— {cert.summary()}"
            )
        self.num_hosts = int(num_hosts)
        self.num_clients = int(num_clients)
        self.device = resolve_device(device) if journal_dir is not None else device
        self._host_map = host_of_clients(num_clients, num_hosts)
        self._tiers = [OnlineAccumulator(p) for _ in range(self.num_hosts)]
        self._root = OnlineAccumulator(p)
        self.duplicates = 0        # engine dedup hits plus tier nonce rejections
        self._shipped = [False] * self.num_hosts
        self._sealed = False
        self._link_bytes = [0] * self.num_hosts
        self._flat_bytes = 0       # what the flat topology would have shipped
        self.crash = crash
        self.round_index = int(round_index)
        self.link = link           # fl.faults.LinkFaults | None
        self.ship = ship if ship is not None else ShipPolicy()
        # Root-side ship dedup: (host, round) -> partial sha. Carried stale
        # partials key by their ORIGIN round, so they never collide with
        # this round's ships.
        self._root_seen: dict[tuple[int, int], str] = {}
        self._ship_attempts = [0] * self.num_hosts
        self.ship_log: list[tuple[int, int, float, bool]] = []
        self.ship_retries = 0      # redelivery attempts beyond the first
        self.ship_lost = 0         # deliveries lost in flight
        self.ship_deduped = 0      # deliveries the root deduped
        self.missed_ships: list[tuple[int, str]] = []   # (host, cause)
        self._missed_partials: dict[int, tuple] = {}
        self.ships_done_s = 0.0    # virtual time the last partial landed
        self.stale_tier_folds = 0      # carried partials folded at the root
        self.stale_tier_clients = 0    # client uploads those partials held
        self._writers: list[jr.JournalWriter | None] = [None] * self.num_hosts
        self._root_writer: jr.JournalWriter | None = None
        self.refolded = 0          # uploads recovered from tier journals
        if journal_dir is not None:
            self._recover(journal_dir, fsync_policy)

    # -- the engine's accumulator contract -----------------------------------

    @property
    def folded(self) -> int:
        """Uploads folded across every tier plus the client uploads held by
        carried stale partials folded at the root."""
        return sum(t.folded for t in self._tiers) + self.stale_tier_clients

    @property
    def nonempty_tiers(self) -> int:
        """Tiers that folded at least one upload this round (the host
        quorum's denominator)."""
        return sum(1 for t in self._tiers if t.folded > 0)

    @property
    def landed_hosts(self) -> list[int]:
        """Hosts whose partial folded at the root this round."""
        return [h for h in range(self.num_hosts) if self._shipped[h]]

    @property
    def released(self) -> int:
        """Client uploads IN the root sum: folds of the tiers whose partial
        landed, plus the carried partials' clients."""
        return (sum(t.folded for h, t in enumerate(self._tiers) if self._shipped[h])
                + self.stale_tier_clients)

    def fold(self, nonce, c0, c1) -> bool:
        """Fold one upload into its client's host tier; False (counting a
        duplicate) if that tier already folded the nonce."""
        if self._sealed:
            raise RuntimeError(
                "HierarchicalAggregator: fold after the tree was sealed "
                "(value()/ship_all() already committed the partials)"
            )
        nonce = tuple(nonce)
        client = int(nonce[-2])
        h = int(self._host_map[client])
        if self._shipped[h]:
            raise RuntimeError(
                f"HierarchicalAggregator: tier {h} already shipped its "
                "partial; a later upload must carry to the next round"
            )
        tier = self._tiers[h]
        if nonce in tier._nonces:
            self.duplicates += 1
            return False
        w = self._writers[h]
        if w is not None:
            body = jr.ct_body(c0, c1)
            fields = dict(
                host=h, client=client,
                nonce=[x if isinstance(x, str) else int(x) for x in nonce],
                shape=[int(d) for d in c0.shape],
                sha=hashlib.sha256(body).hexdigest(),
            )
            c = self.crash
            if c is not None and c.host == h and tier.folded + 1 == c.after_folds:
                if c.at == "mid_fold":
                    w.append_torn("tier_fold", fields, body, c.torn_bytes)
                    raise SimulatedCrash(
                        f"tier crash injection: torn tier_fold append "
                        f"{c.after_folds} on host {h}"
                    )
                if c.at == "post_fold":
                    w.append("tier_fold", fields, body)
                    raise SimulatedCrash(
                        f"tier crash injection: after tier_fold "
                        f"{c.after_folds} landed on host {h}"
                    )
            w.append("tier_fold", fields, body)
        tier.fold(nonce, c0, c1)
        # Flat-topology model: this upload would have crossed whole.
        nbytes = _nbytes(c0) + _nbytes(c1)
        self._flat_bytes += nbytes
        obs_metrics.counter("dcn.flat.bytes").inc(nbytes)
        return True

    def _ship_retry_times(self, host: int, t_send: float) -> list[float]:
        """Virtual-clock redelivery times of host `host`'s lost ship:
        exponential backoff from the send time, deterministic jitter on the
        PRNG stream (seed, round, host, 9)."""
        ship = self.ship
        rng = np.random.default_rng([int(ship.seed), int(self.round_index), int(host), 9])
        t = float(t_send)
        out = []
        for i in range(int(ship.max_retries)):
            back = ship.backoff_s * (2.0 ** i)
            t += back * (1.0 + ship.jitter * float(rng.uniform(-1.0, 1.0)))
            out.append(t)
        return out

    def ship_all(self, t0: float = 0.0) -> None:
        """Ship each nonempty tier's ONE partial ciphertext to the root and
        seal the tree. Idempotent; crash-safe through the tier_ship /
        root_fold WAL order (`_recover`).

        Each ship is a delivery timeline from `t0` (the round's client-quorum
        commit point): first delivery at t0 + the uplink's delay; a LOST
        delivery (LinkFaults.transient / .dark) redelivered at
        `_ship_retry_times`; a duplicated one (LinkFaults.duplicate) lands
        twice and the root dedups it. Every attempt journals a `tier_ship`
        record (attempt, t, lost) before its delivery. A first delivery past
        the deadline misses the round ("timeout"; retried deliveries are
        exempt); an uplink that loses every delivery misses as
        "unreachable". A missed tier is not marked shipped: its sealed
        partial stays retrievable through `take_late_partial`."""
        if self._sealed:
            return
        links = dcn_link_names(self.num_hosts)
        ship = self.ship
        deadline = float(t0) + ship.deadline_s if ship.deadline_s > 0 else float("inf")
        lf = self.link
        for h, tier in enumerate(self._tiers):
            if self._shipped[h] or tier.folded == 0:
                continue
            c = self.crash
            if c is not None and c.host == h and c.at == "pre_ship":
                raise SimulatedCrash(
                    f"tier crash injection: host {h} died between its "
                    "local folds and the upward ship"
                )
            pc0, pc1 = tier.value()
            sha = ct_hash(pc0, pc1)
            delay = float(lf.delay_s[h]) if lf is not None else 0.0
            dark = bool(lf.dark[h]) if lf is not None else False
            trans = bool(lf.transient[h]) if lf is not None else False
            dup = bool(lf.duplicate[h]) if lf is not None else False
            send = float(t0) + delay
            # The delivery plan: (t, lost, retried) in virtual-clock order.
            plan: list[tuple[float, bool, bool]] = [(send, dark or trans, False)]
            if dark:
                plan += [(rt, True, True) for rt in self._ship_retry_times(h, send)]
            elif trans:
                rts = self._ship_retry_times(h, send)
                if rts:
                    plan.append((rts[0], False, True))
            elif dup:
                plan.append((send + 1e-6, False, False))
            w = self._writers[h]
            tracer = obs_spans.current()
            landed_t = None
            cause = None
            for t, lost, retried in plan:
                self._ship_attempts[h] += 1
                att = self._ship_attempts[h]
                if retried:
                    self.ship_retries += 1
                    obs_metrics.counter("dcn.retry.attempts").inc()
                    if tracer is not None:
                        tracer.add("ship_retry", float(t), host=int(h), attempt=int(att),
                                   lost=bool(lost))
                self.ship_log.append((h, att, float(t), bool(lost)))
                if w is not None:
                    w.append("tier_ship", dict(
                        host=h, sha=sha, folded=tier.folded, round=self.round_index,
                        attempt=att, t=float(t), lost=bool(lost),
                    ))
                if c is not None and c.host == h and c.at == "post_ship" and att == 1:
                    raise SimulatedCrash(
                        f"tier crash injection: host {h} died after "
                        "tier_ship landed, before the root saw the partial"
                    )
                if lost:
                    self.ship_lost += 1
                    obs_metrics.counter("dcn.retry.lost").inc()
                    continue
                if not retried and t > deadline:
                    cause = "timeout"
                    continue
                if self._ship_partial(h, pc0, pc1, sha, links[h]) and landed_t is None:
                    landed_t = float(t)
            if landed_t is None:
                self.missed_ships.append((h, cause or "unreachable"))
                self._missed_partials[h] = (pc0, pc1, sha, tier.folded)
                obs_metrics.counter("dcn.ship.missed").inc()
            else:
                self.ships_done_s = max(self.ships_done_s, landed_t)
                obs_metrics.counter("dcn.ship.landed").inc()
                obs_metrics.histogram("dcn.ship_rtt_s", bounds=_SHIP_RTT_BUCKETS).observe(
                    round(max(0.0, landed_t - float(t0)), 9))
            if tracer is not None:
                # One tier_ship span per shipping tier, landed or missed.
                last_t = max((pt for pt, _l, _r in plan), default=send)
                tracer.add(
                    "tier_ship", send, landed_t if landed_t is not None else last_t,
                    host=int(h), folded=int(tier.folded),
                    attempts=int(self._ship_attempts[h]), landed=landed_t is not None,
                    cause=(cause or "unreachable") if landed_t is None else None,
                )
        self._sealed = True

    def take_late_partial(self, host: int):
        """The sealed partial of a host whose ship missed the round ->
        (c0, c1, sha, folded), for the engine to carry as a stale tier fold
        under host_staleness_rounds."""
        pc0, pc1, sha, nfold = self._missed_partials[int(host)]
        return _copy(pc0), _copy(pc1), sha, int(nfold)

    def fold_carried(self, host, origin_round, c0, c1, sha, nclients) -> bool:
        """Fold a CARRIED tier partial (sealed in `origin_round`, missed that
        round's ship) into the root: one more instance of the certified fold
        loop. Dedups by (host, origin_round), so a replayed or redelivered
        carry never double-folds; its bytes count against this round's
        traffic, when it crosses. False = deduped."""
        got = ct_hash(c0, c1)
        if got != sha:
            raise jr.JournalError(
                f"carried tier partial from host {host} round "
                f"{origin_round} hashes to {got} but its carry recorded "
                f"{sha} — refusing to fold a diverged partial"
            )
        key = (int(host), int(origin_round))
        seen = self._root_seen.get(key)
        if seen is not None:
            if seen != sha:
                raise jr.JournalError(
                    f"carried tier partial {key} diverged: root folded "
                    f"{seen}, redelivery carries {sha}"
                )
            self.ship_deduped += 1
            obs_metrics.counter("dcn.retry.deduped").inc()
            return False
        self._root_seen[key] = sha
        self._root.fold(("tier", int(host), int(origin_round)), c0, c1)
        self.stale_tier_folds += 1
        self.stale_tier_clients += int(nclients)
        links = dcn_link_names(self.num_hosts)
        nbytes = _nbytes(c0) + _nbytes(c1)
        self._link_bytes[int(host)] += nbytes
        obs_metrics.counter(f"dcn.link.{links[int(host)]}.bytes").inc(nbytes)
        obs_metrics.counter("dcn.hier.bytes").inc(nbytes)
        obs_events.emit("dcn_ship", host=int(host), bytes=nbytes, sha=sha, stale=True,
                        origin_round=int(origin_round))
        return True

    def _ship_partial(self, h, pc0, pc1, sha, link) -> bool:
        """Deliver one tier partial to the root. Root-side dedup by (host,
        round, sha): a second delivery of the same partial counts
        `ship_deduped` and folds nothing; a colliding delivery with a
        DIFFERENT sha fails loudly. -> True iff the partial folded."""
        key = (int(h), int(self.round_index))
        seen = self._root_seen.get(key)
        if seen is not None:
            if seen != sha:
                raise jr.JournalError(
                    f"tier {h} re-shipped a DIVERGED partial for round "
                    f"{self.round_index}: root folded {seen}, redelivery "
                    f"carries {sha}"
                )
            self.ship_deduped += 1
            obs_metrics.counter("dcn.retry.deduped").inc()
            return False
        if self._root_writer is not None:
            self._root_writer.append("root_fold", dict(host=h, round=self.round_index, sha=sha))
        self._root.fold(("host", h), pc0, pc1)
        self._root_seen[key] = sha
        nbytes = _nbytes(pc0) + _nbytes(pc1)
        self._link_bytes[h] += nbytes
        obs_metrics.counter(f"dcn.link.{link}.bytes").inc(nbytes)
        obs_metrics.counter("dcn.hier.bytes").inc(nbytes)
        obs_events.emit("dcn_ship", host=h, bytes=nbytes, sha=sha)
        self._shipped[h] = True
        return True

    def value(self, like_shape=None, device=None):
        """The committed aggregate: ships any unshipped tier first, then
        returns the root sum, bitwise the flat fold of the same uploads
        (zeros of `like_shape` on `device` when nothing folded)."""
        self.ship_all()
        return self._root.value(like_shape=like_shape, device=device)

    # -- per-tier journals ----------------------------------------------------

    def _meta(self) -> dict:
        return {"num_hosts": self.num_hosts, "num_clients": self.num_clients}

    def _body_residues(self, body: bytes, shape):
        c0, c1 = jr.ct_from_body(body, shape)
        return (torch.from_numpy(c0.astype(np.int32)).to(self.device),
                torch.from_numpy(c1.astype(np.int32)).to(self.device))

    def _recover(self, journal_dir: str, fsync_policy: str | None) -> None:
        """Construction is recovery: open every tier journal (repairing torn
        tails), re-fold the journaled bodies (nonce dedup: a replayed record
        never double-counts) and verify shipped partials against their
        journaled sha. A partial whose tier_ship landed but whose root_fold
        did not is re-shipped by the next `ship_all`, through the same
        delivery timeline, where the root's (host, round, sha) dedup folds
        it exactly once."""
        os.makedirs(journal_dir, exist_ok=True)
        pending_ship: list[int] = []
        for h in range(self.num_hosts):
            path = os.path.join(journal_dir, f"tier{h}.wal")
            w, records, _torn = jr.open_journal(path, fsync_policy,
                                                meta=dict(self._meta(), tier=h))
            self._writers[h] = w
            tier = self._tiers[h]
            for rec in records:
                kind = rec.get("kind")
                if kind == "journal_open":
                    meta = rec.get("meta", {})
                    if (meta.get("num_hosts") != self.num_hosts
                            or meta.get("num_clients") != self.num_clients
                            or meta.get("tier") != h):
                        raise jr.JournalError(
                            f"{path}: journal belongs to a different "
                            f"topology ({meta!r}) than this aggregator "
                            f"({self._meta()!r}, tier {h})"
                        )
                    continue
                if kind == "tier_fold":
                    body = rec["body"]
                    got = hashlib.sha256(body).hexdigest()
                    if got != rec.get("sha"):
                        raise jr.JournalCorruptError(
                            f"{path}: tier_fold body sha256 {got} does "
                            f"not match its record ({rec.get('sha')})"
                        )
                    c0, c1 = self._body_residues(body, rec["shape"])
                    if tier.fold(tuple(rec["nonce"]), c0, c1):
                        self.refolded += 1
                        self._flat_bytes += _nbytes(c0) + _nbytes(c1)
                elif kind == "tier_ship":
                    if tier.folded == 0:
                        raise jr.JournalError(
                            f"{path}: tier_ship with no folded uploads — "
                            "the fold records this ship summarized are "
                            "missing"
                        )
                    sha = ct_hash(*tier.value())
                    if sha != rec.get("sha"):
                        raise jr.JournalError(
                            f"{path}: recovered tier {h} partial hashes "
                            f"to {sha} but the journaled ship recorded "
                            f"{rec.get('sha')} — refusing to re-ship a "
                            "diverged partial"
                        )
                    # One tier may hold several attempt records; re-ships
                    # continue their numbering.
                    self._ship_attempts[h] = max(
                        self._ship_attempts[h],
                        int(rec.get("attempt", self._ship_attempts[h] + 1)),
                    )
                    if h not in pending_ship:
                        pending_ship.append(h)
        root_path = os.path.join(journal_dir, "root.wal")
        rw, root_records, _ = jr.open_journal(root_path, fsync_policy,
                                              meta=dict(self._meta(), tier="root"))
        self._root_writer = rw
        root_seen: dict[int, str] = {}
        for rec in root_records:
            if rec.get("kind") != "root_fold":
                continue
            r = int(rec.get("round", self.round_index))
            if r != self.round_index:
                raise jr.JournalError(
                    f"{root_path}: root_fold for round {r} in an "
                    f"aggregator recovering round {self.round_index} — "
                    "the journal belongs to a different round"
                )
            root_seen[int(rec["host"])] = rec.get("sha")
        for h in root_seen:
            if h not in pending_ship:
                raise jr.JournalError(
                    f"{root_path}: root_fold for host {h} has no "
                    f"tier_ship in tier{h}.wal — the tiers and root "
                    "disagree about history"
                )
        for h in pending_ship:
            pc0, pc1 = self._tiers[h].value()
            sha = ct_hash(pc0, pc1)
            want = root_seen.get(h)
            if want is not None and want != sha:
                raise jr.JournalError(
                    f"{root_path}: root_fold sha for host {h} ({want}) "
                    f"does not match the recovered partial ({sha})"
                )
            if want is not None:
                # Already at the root: fold in memory without re-logging.
                self._root.fold(("host", h), pc0, pc1)
                self._root_seen[(h, self.round_index)] = sha
                self._link_bytes[h] += _nbytes(pc0) + _nbytes(pc1)
                self._shipped[h] = True
        if self.refolded:
            obs_metrics.counter("recovery.tier_refolded_uploads").inc(self.refolded)
            obs_events.emit("tier_recovered", journal_dir=journal_dir,
                            refolded=self.refolded, shipped=sum(self._shipped))

    def close(self) -> None:
        for w in self._writers:
            if w is not None:
                w.close()
        if self._root_writer is not None:
            self._root_writer.close()
        self._writers = [None] * self.num_hosts
        self._root_writer = None

    # -- cross-region accounting ------------------------------------------------

    def report(self) -> dict:
        """The round's simulated cross-region traffic summary: per-uplink
        bytes, the hierarchical total, the flat-topology model for the same
        folds and their ratio, and the faulty-uplink outcome."""
        links = dcn_link_names(self.num_hosts)
        hier = sum(self._link_bytes)
        return {
            "num_hosts": self.num_hosts,
            "num_clients": self.num_clients,
            "folded": self.folded,
            "released": self.released,
            "duplicates": int(self.duplicates),
            "shipping_hosts": int(sum(self._shipped)),
            "per_link": {links[h]: int(b) for h, b in enumerate(self._link_bytes)},
            "flat_dcn_bytes": int(self._flat_bytes),
            "hier_dcn_bytes": int(hier),
            "bytes_ratio": round(self._flat_bytes / hier, 3) if hier else float("inf"),
            "ship_retries": int(self.ship_retries),
            "ship_lost": int(self.ship_lost),
            "ship_deduped": int(self.ship_deduped),
            "missed_hosts": [[int(h), str(cause)] for h, cause in self.missed_ships],
            "stale_tier_folds": int(self.stale_tier_folds),
            "stale_tier_clients": int(self.stale_tier_clients),
            "ships_done_s": round(float(self.ships_done_s), 6),
        }


def dcn_compare_record(p, c0_rows, c1_rows, clients, num_clients: int, num_hosts: int,
                       round_index: int = 0, seed: int = 0) -> dict:
    """Fold the SAME cohort uploads flat and hierarchically in several
    arrival orders (identity, reversed, PRNG-shuffled; each with every other
    upload redelivered, a duplicate storm) and hash-compare the committed
    aggregates.

    `c0_rows`/`c1_rows` are cohort-rowed residues (tensors on any device,
    or host arrays) aligned with `clients`. The gate: `bitwise_equal` (every
    order, both topologies, one hash) and `bytes_ratio >= ratio_floor`,
    the floor cohort/hosts * 0.8 — the hierarchy ships at most one partial
    per nonempty host."""
    clients = np.asarray(clients, dtype=np.int64)
    k = len(clients)
    orders = {
        "identity": np.arange(k),
        "reversed": np.arange(k)[::-1],
        "shuffled": np.random.default_rng([int(seed), 3]).permutation(k),
    }
    hashes = set()
    reports = {}
    for name, order in orders.items():
        flat = OnlineAccumulator(p)
        hier = HierarchicalAggregator(p, num_hosts, num_clients)
        for i in order:
            nonce = (int(clients[i]), int(round_index))
            flat.fold(nonce, c0_rows[i], c1_rows[i])
            hier.fold(nonce, c0_rows[i], c1_rows[i])
            if i % 2 == 0:   # duplicate storm: redeliver half the uploads
                flat.fold(nonce, c0_rows[i], c1_rows[i])
                hier.fold(nonce, c0_rows[i], c1_rows[i])
        hashes.add(ct_hash(*flat.value()))
        hashes.add(ct_hash(*hier.value()))
        reports[name] = hier.report()
    rep = reports["identity"]
    ratio_floor = round((k / num_hosts) * 0.8, 3)
    return {
        "num_clients": int(num_clients),
        "cohort_size": int(k),
        "num_hosts": int(num_hosts),
        "ct_bytes": _nbytes(c0_rows[0]) + _nbytes(c1_rows[0]),
        "flat_dcn_bytes": rep["flat_dcn_bytes"],
        "hier_dcn_bytes": rep["hier_dcn_bytes"],
        "per_link": rep["per_link"],
        "shipping_hosts": rep["shipping_hosts"],
        "bytes_ratio": rep["bytes_ratio"],
        "ratio_floor": ratio_floor,
        "ratio_ok": bool(rep["bytes_ratio"] >= ratio_floor),
        "arrival_orders": list(orders),
        "bitwise_equal": len(hashes) == 1,
        "ship_retries": rep["ship_retries"],
        "ship_lost": rep["ship_lost"],
        "ship_deduped": rep["ship_deduped"],
        "missed_hosts": rep["missed_hosts"],
        "released": rep["released"],
    }


def dcn_compare_smoke_record(device=None) -> dict:
    """`dcn_compare_record` at one FIXED small geometry: 16 registered
    clients, a cohort of 8, 4 hosts (4 clients a host block), SmallCNN on
    mnist at N = 256 — a record of the fold topology, not of ring cost.
    The uploads are produced on `make_mesh(16)` (`fl.stream.produce_uploads`):
    the ranks of the process group, every rank calling this alike, or one
    device without one. Runs on `device` (CUDA unless given)."""
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen
    from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
    from hefl_tpu_torch.data.synthetic import make_dataset
    from hefl_tpu_torch.fl.config import StreamConfig, TrainConfig
    from hefl_tpu_torch.fl.stream import produce_uploads, sample_cohort
    from hefl_tpu_torch.models import create_model
    from hefl_tpu_torch.parallel import make_mesh

    device = resolve_device(device)
    model = create_model("smallcnn", gen=torch.Generator().manual_seed(7), device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    (x, y), _, _ = make_dataset("mnist", seed=0, n_train=64, n_test=8)
    xs, ys = stack_federated(x, y, iid_contiguous(len(x), 16))
    ctx = CkksContext.create(n=256)
    _, pk = keygen(ctx, torch.Generator().manual_seed(77), device=device)
    cfg = TrainConfig(epochs=1, batch_size=8, num_classes=10, augment=False, val_fraction=0.25)
    cohort = sample_cohort(StreamConfig(cohort_size=8, num_hosts=4), 0, 16)
    part = np.zeros(16, np.int32)
    part[cohort] = 1
    cts = produce_uploads(model, cfg, make_mesh(16, device=device), ctx, pk, params,
                          torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device),
                          torch.Generator().manual_seed(78), participation=part,
                          cohort=cohort)[0]
    return dcn_compare_record(ctx.ntt.p, cts.c0, cts.c1, cohort, num_clients=16, num_hosts=4)


def _main(argv: list[str] | None = None) -> int:
    """The BENCH_DCN writer: `python -m hefl_tpu_torch.fl.hierarchy [--out
    BENCH_TORCH_DCN.json] [--device D]`; exit 1 unless the tree is bitwise
    the flat fold and the cross-region bytes ratio meets its floor. Under
    `torchrun` every rank produces its block of the uploads
    (`parallel.init_mesh` joins the group) and rank 0 alone writes."""
    import argparse
    import json

    from hefl_tpu_torch import device_record
    from hefl_tpu_torch.obs import metrics as obs_metrics

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--out", default="BENCH_TORCH_DCN.json")
    ap.add_argument("--device", default=None, help="where the uploads and folds run "
                                                   "(default: cuda)")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    from hefl_tpu_torch.parallel import init_mesh

    device = init_mesh(args.device)
    rec = dcn_compare_smoke_record(device=device)
    ok = rec["bitwise_equal"] and rec["ratio_ok"]
    if dist.is_initialized() and dist.get_rank() != 0:
        return 0 if ok else 1
    dev = device_record(device)
    artifact = {
        "platform": dev["platform"],
        "device_count": dev["count"],
        "device": dev,
        "dcn_compare": rec,
        "metrics": obs_metrics.snapshot(),
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2, sort_keys=True)
    print(f"dcn_compare: cohort={rec['cohort_size']} hosts={rec['num_hosts']} "
          f"ratio={rec['bytes_ratio']} (floor {rec['ratio_floor']}) "
          f"bitwise_equal={rec['bitwise_equal']} on {dev['kind']} ({dev['power_limit']}) "
          f"-> {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(_main())


__all__ = [
    "TIER_CRASH_POINTS",
    "TierCrash",
    "ShipPolicy",
    "HierarchicalAggregator",
    "dcn_compare_record",
    "dcn_compare_smoke_record",
]
