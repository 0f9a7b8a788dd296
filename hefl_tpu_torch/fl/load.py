"""Server hot-path load trace: the journal, the dedup window, the fold and
the cohort gather at registry scale, on synthetic ciphertext bodies.

Counterpart of `hefl_tpu.fl.load`: `LoadConfig` (the trace's registry scale
and fault schedule), `synthetic_rows`, `drive_trace` (the real
`fl.journal.JournalWriter` / `RoundSession` record stream,
`fl.stream.DedupWindow` and `OnlineAccumulator` over one deterministic
trace), `recovery_record` (scan seconds against journal length),
`commit_latency_sweep` (virtual commit-latency percentiles over (cohort,
quorum) points), `gather_record` (cohort-gather seconds against registry
size), `fold_throughput_record`, `ef_packing_record`, and the BENCH_LOAD
writer `bench_load_record` / `_main`. No training, no encryption: random
canonical residues at a toy (n_ct, L, N) geometry ride the real code.

The record stream, and so the journal's bytes, is a pure function of the
trace, so `drive_trace(LoadConfig(), path, policy)` reproduces the JAX
package's `journal_bytes_sha` and `sum_sha` in BENCH_LOAD.json under every
fsync policy, group-committed or not, folded one at a time or batched, and
`commit_latency_sweep(LoadConfig())` its `commit_latency_sweep` block. Every
fold runs on the device given (CUDA unless the caller passes another), the
rows moved there before the clock starts.

    python -m hefl_tpu_torch.fl.load [--out BENCH_TORCH_LOAD.json] [--smoke]
        [--clients N] [--sweep] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import time

import numpy as np
import torch

from hefl_tpu_torch.fl import journal as jr
from hefl_tpu_torch.fl.config import StreamConfig
from hefl_tpu_torch.fl.faults import FaultConfig, schedule_arrivals
from hefl_tpu_torch.fl.stream import (
    _COMMIT_LATENCY_BUCKETS,
    DedupWindow,
    OnlineAccumulator,
    ct_hash,
    quorum_count,
    sample_cohort,
)
from hefl_tpu_torch.obs import metrics as obs_metrics

# Toy residue geometry of the synthetic bodies: big enough that the fold
# and the journal write are real array/IO work, small enough that a
# 10**5-client trace runs inside the CI smoke budget.
_ROW_SHAPE = (2, 2, 64)      # (n_ct, L, N)
_PRIMES = (2**27 - 39, 2**26 - 5)   # one canonical prime per L row


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """One load trace: registry scale + the fault schedule knobs.

    The defaults are the full BENCH_LOAD trace (10**5 clients);
    `smoke()` is the smaller variant."""

    num_clients: int = 100_000
    rounds: int = 3
    cohort_size: int = 512
    staleness_rounds: int = 2     # tau: dedup window depth under test
    duplicate_clients: int = 128  # duplicate storm, per round
    stale_replays: int = 64       # adversarial staleness: old nonces
                                  # redelivered up to tau+1 rounds late
    arrival_delay_s: float = 4.0  # dispersed arrivals
    straggler_fraction: float = 0.05   # heavy tail
    straggler_delay_s: float = 60.0
    drop_fraction: float = 0.02
    seed: int = 0

    @classmethod
    def smoke(cls) -> "LoadConfig":
        return cls(num_clients=10_000, rounds=2, cohort_size=256,
                   duplicate_clients=64, stale_replays=32)

    def fault_config(self) -> FaultConfig:
        return FaultConfig(
            seed=self.seed,
            drop_fraction=self.drop_fraction,
            arrival_delay_s=self.arrival_delay_s,
            straggler_fraction=self.straggler_fraction,
            straggler_delay_s=self.straggler_delay_s,
            duplicate_clients=self.duplicate_clients,
        )


def synthetic_rows(n_rows: int, seed: int, shape=_ROW_SHAPE) -> np.ndarray:
    """Random CANONICAL residue rows uint32[n_rows, *shape] (< p per L
    row) — the accumulator invariant every real producer upholds."""
    rng = np.random.default_rng([int(seed), 11])
    p = np.asarray(_PRIMES, np.uint32).reshape(1, 1, len(_PRIMES), 1)
    out = rng.integers(
        0, 2**32, size=(n_rows,) + tuple(shape), dtype=np.uint32
    )
    return (out % p).astype(np.uint32)


def _pctl(xs, q: float) -> float:
    """Delegates to the one shared percentile implementation
    (`obs.metrics.exact_percentile`, the math of `Histogram.quantile`'s
    small-N reservoir path)."""
    return obs_metrics.exact_percentile(xs, q)


def _p_broadcast() -> np.ndarray:
    """_PRIMES shaped to broadcast over (n_ct, L, N) rows — the same
    layout ctx.ntt.p has in the real engine."""
    return np.asarray(_PRIMES, np.int64).reshape(len(_PRIMES), 1)


# ---------------------------------------------------------------------------
# The trace driver: one deterministic record stream per (cfg, seed).
# ---------------------------------------------------------------------------


def _round_trace(cfg: LoadConfig, r: int):
    """The round's arrival-ordered delivery list.

    -> (cohort, deliveries) where deliveries is a list of
    (t, client, nonce, stale_replay: bool); duplicates appear twice and
    `stale_replays` old nonces (rounds r-1 .. r-tau-1) are re-delivered —
    the adversarial-staleness storm the dedup window must absorb."""
    s = StreamConfig(
        cohort_size=cfg.cohort_size, seed=cfg.seed,
        staleness_rounds=cfg.staleness_rounds,
    )
    fc = cfg.fault_config()
    cohort = sample_cohort(s, r, cfg.num_clients)
    arr = schedule_arrivals(fc, r, cfg.num_clients)
    deliveries = []
    for c in cohort:
        c = int(c)
        if arr.permanent[c]:
            continue
        t = float(arr.arrival_s[c])
        deliveries.append((t, c, (c, r), False))
        if arr.duplicate[c]:
            deliveries.append((t + 1e-3, c, (c, r), False))
    # Adversarial staleness: replay nonces from earlier rounds' cohorts.
    rng = np.random.default_rng([int(cfg.seed), int(r), 7])
    for i in range(cfg.stale_replays if r > 0 else 0):
        back = 1 + int(rng.integers(0, cfg.staleness_rounds + 1))
        r_old = r - back
        if r_old < 0:
            continue
        old_cohort = sample_cohort(s, r_old, cfg.num_clients)
        c = int(old_cohort[int(rng.integers(0, len(old_cohort)))])
        deliveries.append((float(rng.uniform(0, cfg.arrival_delay_s)),
                           c, (c, r_old), True))
    deliveries.sort(key=lambda d: (d[0], d[1]))
    return cohort, deliveries


def drive_trace(
    cfg: LoadConfig,
    path: str,
    fsync_policy: str,
    group_commit: bool = True,
    fold_batched: bool = False,
    device=None,
) -> dict:
    """Run the full trace against a real journal + window + accumulator.

    One fold body per fresh delivery (synthetic rows, cohort-sized pool
    re-indexed by client so a replayed nonce re-presents ITS bytes); the
    record stream (and therefore the journal's hash chain) is a pure
    function of (cfg, fsync-independent) — the property the group-commit
    sha-equality gate rests on. The journal records the host rows; the
    folds take the same rows moved to `device` (CUDA unless given) before
    the clock starts. -> per-trace stats dict.
    """
    from hefl_tpu_torch import resolve_device

    device = resolve_device(device)
    base = obs_metrics.snapshot()
    w = jr.JournalWriter(path, fsync_policy, group_commit=group_commit)
    w._open(jr._CHAIN_SEED)
    w.append("journal_open", {"version": 1, "meta": {"load": True}})
    seen = DedupWindow()
    tau = cfg.staleness_rounds
    commit_lat = []
    fold_seconds = 0.0
    folds = dedups = appends = 0
    final_sha = None
    for r in range(cfg.rounds):
        cohort, deliveries = _round_trace(cfg, r)
        rows = synthetic_rows(len(cohort), cfg.seed + r)
        rows_d = _on(rows, device)
        row_of = {int(c): i for i, c in enumerate(cohort)}
        acc = OnlineAccumulator(_p_broadcast())
        session = jr.RoundSession(w)
        session.round_open(r, [0, 0], cohort, len(cohort), tau,
                           cfg.num_clients, None)
        seen = seen.advanced(r, tau)
        t0 = time.perf_counter()
        if fold_batched:
            # Vectorized ingest: journal every arrival first (the WAL
            # order is unchanged — bytes durable before the fold), then
            # one fold_batch dispatch over the fresh bodies.
            batch_nonces, batch_idx = [], []
            for seq, (t, c, nonce, stale) in enumerate(deliveries):
                if nonce in seen:
                    session.dedup(r, seq, c, nonce)
                    dedups += 1
                    continue
                seen.add(nonce)
                i = row_of.get(c, 0)
                session.fold(r, seq, "fresh", c, nonce, 0, t,
                             rows[i], rows[i], persist=True)
                batch_nonces.append(nonce)
                batch_idx.append(i)
                folds += 1
            if batch_idx:
                b = rows_d.index_select(0, torch.tensor(batch_idx, device=device))
                acc.fold_batch(batch_nonces, b, b)
        else:
            for seq, (t, c, nonce, stale) in enumerate(deliveries):
                if nonce in seen:
                    session.dedup(r, seq, c, nonce)
                    dedups += 1
                    continue
                seen.add(nonce)
                i = row_of.get(c, 0)
                session.fold(r, seq, "fresh", c, nonce, 0, t, rows[i], rows[i], persist=True)
                acc.fold(nonce, rows_d[i], rows_d[i])
                folds += 1
        _sync(device)
        fold_seconds += time.perf_counter() - t0
        s0, s1 = acc.value(like_shape=_ROW_SHAPE)
        final_sha = ct_hash(s0, s1)
        tc = time.perf_counter()
        session.commit(r, final_sha, acc.folded, acc.folded, 0,
                       float(max((d[0] for d in deliveries), default=0.0)))
        session.close(r, True, acc.folded, {}, seen)
        commit_lat.append(time.perf_counter() - tc)
        appends += len(deliveries) + 3
    w.close()
    delta = obs_metrics.snapshot_delta(base)
    return {
        "fsync_policy": fsync_policy,
        "group_commit": bool(group_commit and fsync_policy == "commit"),
        "fold_batched": bool(fold_batched),
        "rounds": cfg.rounds,
        "folds": folds,
        "dedup_hits": dedups,
        "appends": int(delta.get("journal.appends", 0)),
        "fsyncs": int(delta.get("journal.fsyncs", 0)),
        "fsyncs_per_round": float(delta.get("journal.fsyncs", 0))
        / max(cfg.rounds, 1),
        "bytes_written": int(delta.get("journal.bytes_written", 0)),
        "appends_per_s": round(
            float(delta.get("journal.appends", 0)) / max(fold_seconds, 1e-9),
            1,
        ),
        "folds_per_s": round(folds / max(fold_seconds, 1e-9), 1),
        "commit_latency_s": {
            "p50": round(_pctl(commit_lat, 50), 6),
            "p95": round(_pctl(commit_lat, 95), 6),
            "p99": round(_pctl(commit_lat, 99), 6),
        },
        "dedup_window_peak": int(seen.peak_entries),
        "dedup_window_bound": (tau + 2) * cfg.cohort_size,
        "dedup_bound_ok": seen.peak_entries <= (tau + 2) * cfg.cohort_size,
        "sum_sha": final_sha,
        "journal_bytes_sha": _file_sha(path),
    }


def _file_sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def recovery_record(cfg: LoadConfig, path: str) -> list[dict]:
    """Recovery (scan+verify) seconds vs journal length: scan the trace's
    journal whole, then its first half (via a truncated copy) — the
    linear-replay-cost curve operators size checkpoints against."""
    out = []
    scan = jr.scan_journal(path)
    for frac in (0.5, 1.0):
        p = path
        if frac < 1.0:
            # Truncate a COPY at a frame boundary (prefix of good bytes
            # re-scanned to the nearest whole frame).
            p = path + f".part{int(frac * 100)}"
            with open(path, "rb") as f:
                data = f.read(scan.good_bytes // 2)
            with open(p, "wb") as f:
                f.write(data)
            part = jr.scan_journal(p)
            with open(p, "r+b") as f:
                f.truncate(part.good_bytes)
        t0 = time.perf_counter()
        s = jr.scan_journal(p)
        dt = time.perf_counter() - t0
        out.append({
            "records": len(s.records),
            "bytes": int(s.good_bytes),
            "seconds": round(dt, 6),
        })
        if p != path:
            os.unlink(p)
    return out


# The default sweep grid: two cohort sizes x two quorum fractions.
_SWEEP_POINTS = ((256, 0.5), (256, 0.9), (512, 0.5), (512, 0.9))


def commit_latency_sweep(cfg: LoadConfig | None = None, points=_SWEEP_POINTS,
                         rounds: int = 4) -> dict:
    """Commit-latency percentiles as a family over (cohort, quorum) points.

    Per point: `rounds` deterministic `_round_trace` rounds at that cohort
    size; a round's commit latency is the VIRTUAL arrival time of the
    quorum-th fresh (non-stale, deduped) delivery, what the engine's
    `stream.commit_latency_s` histogram observes; a round that never
    reaches quorum contributes nothing. Percentiles through
    `obs.metrics.Histogram.quantile`. Gates: >= 3 points, every point
    committed at least once, p50 <= p95 <= p99 at each."""
    cfg = cfg or LoadConfig.smoke()
    out = []
    for cohort_size, q_frac in points:
        pt_cfg = dataclasses.replace(cfg, cohort_size=int(cohort_size), rounds=int(rounds))
        s = StreamConfig(cohort_size=int(cohort_size), seed=pt_cfg.seed,
                         staleness_rounds=pt_cfg.staleness_rounds, quorum=float(q_frac))
        hist = obs_metrics.Histogram(bounds=_COMMIT_LATENCY_BUCKETS)
        committed = 0
        for r in range(int(rounds)):
            cohort, deliveries = _round_trace(pt_cfg, r)
            qcount = quorum_count(s, len(cohort))
            seen: set = set()
            nth = 0
            for t, _c, nonce, stale in deliveries:      # already time-sorted
                if stale or nonce in seen:
                    continue
                seen.add(nonce)
                nth += 1
                if nth >= qcount:
                    hist.observe(float(t))
                    committed += 1
                    break
        p50, p95, p99 = (hist.quantile(q) for q in (0.50, 0.95, 0.99))
        out.append({
            "cohort_size": int(cohort_size),
            "quorum": float(q_frac),
            "rounds": int(rounds),
            "committed_rounds": int(committed),
            "commit_latency_s": {"p50": round(p50, 6), "p95": round(p95, 6),
                                 "p99": round(p99, 6)},
        })
    ok = (len(out) >= 3 and all(p["committed_rounds"] >= 1 for p in out)
          and all(p["commit_latency_s"]["p50"] <= p["commit_latency_s"]["p95"]
                  <= p["commit_latency_s"]["p99"] for p in out))
    return {"points": out, "num_points": len(out), "ok": bool(ok)}


def gather_record(registry_sizes=(10_000, 100_000), cohort_size: int = 512,
                  seed: int = 0) -> list[dict]:
    """Cohort-gather seconds against registry size: `cohort_gather_index`
    is O(cohort), so the rows stay flat as the registry grows."""
    from hefl_tpu_torch.fl.fedavg import cohort_bucket, cohort_gather_index

    out = []
    for n in registry_sizes:
        s = StreamConfig(cohort_size=min(cohort_size, n), seed=seed)
        cohort = sample_cohort(s, 0, n)
        bucket = cohort_bucket(len(cohort), n, 1)
        best = None
        for _ in range(5):
            t0 = time.perf_counter()
            gidx = cohort_gather_index(cohort, bucket)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        if len(gidx) != bucket:
            raise AssertionError(f"gather index of {len(gidx)} slots for a bucket of {bucket}")
        out.append({"registry": int(n), "cohort": int(len(cohort)), "bucket": int(bucket),
                    "gather_seconds": round(best, 6)})
    return out


def _on(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Rows as int32 residues on `device`."""
    return torch.from_numpy(rows.astype(np.int32)).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fold_throughput_record(n_rows: int = 512, repeats: int = 3, shape=_ROW_SHAPE,
                           seed: int = 0, device=None) -> dict:
    """folds/s sequential vs `fold_batch` vs the hierarchical tree (4 hosts)
    over the SAME rows, sha-gated equal: the batched speedup, and what the
    tree costs on top of the flat fold. The rows are moved to `device`
    (CUDA unless given) before the clock starts; the clock stops after the
    device finished."""
    from hefl_tpu_torch import resolve_device
    from hefl_tpu_torch.fl.hierarchy import HierarchicalAggregator

    device = resolve_device(device)
    rows = _on(synthetic_rows(n_rows, seed, shape), device)
    nonces = [(i, 0) for i in range(n_rows)]
    p = _p_broadcast()

    def time_seq():
        acc = OnlineAccumulator(p)
        t0 = time.perf_counter()
        for i in range(n_rows):
            acc.fold(nonces[i], rows[i], rows[i])
        _sync(device)
        return time.perf_counter() - t0, acc.value()

    def time_batch():
        acc = OnlineAccumulator(p)
        t0 = time.perf_counter()
        acc.fold_batch(nonces, rows, rows)
        _sync(device)
        return time.perf_counter() - t0, acc.value()

    def time_hier():
        acc = HierarchicalAggregator(p, 4, n_rows)
        t0 = time.perf_counter()
        for i in range(n_rows):
            acc.fold(nonces[i], rows[i], rows[i])
        out = acc.value()
        _sync(device)
        return time.perf_counter() - t0, out

    best = {"sequential": None, "batched": None, "hier": None}
    shas = {}
    for _ in range(repeats):
        for name, fn in (("sequential", time_seq), ("batched", time_batch), ("hier", time_hier)):
            dt, (s0, s1) = fn()
            shas[name] = ct_hash(s0, s1)
            if best[name] is None or dt < best[name]:
                best[name] = dt
    return {
        "rows": n_rows,
        "row_shape": list(shape),
        "folds_per_s": {k: round(n_rows / max(v, 1e-9), 1) for k, v in best.items()},
        "batched_speedup": round(best["sequential"] / max(best["batched"], 1e-9), 2),
        "sha_equal": len(set(shas.values())) == 1,
    }


def ef_packing_record(clients: int = 8, guard_bits: int = 16, total_params: int = 225_034,
                      n: int = 256, cohort: int = 256, device=None) -> dict:
    """The error-feedback geometry as a record: at (C = 8, guard 16), b = 4
    packs k twice as deep as b = 8, so the bytes on the wire fall to <= 0.55
    of b = 8's and the fold ingests more client updates a second (fewer
    ciphertext rows an update). Every (b, k) point is re-certified
    carry-free (`certify_packing`, what `PackedSpec.for_params` enforces).
    The fold runs on `device` (CUDA unless given; the rows moved there
    before the clock) over the JAX record's geometry on every device:
    `cohort` uploads of [n_ct, L, 64] rows. Its ratio is a host-clock
    reading, reported beside its 1.5 floor: on a card a fold of these rows
    is bound by its fixed cost, not its bytes, so `bench_load_record` does
    not gate on it."""
    from hefl_tpu_torch import resolve_device
    from hefl_tpu_torch.analysis.ranges import certify_packing
    from hefl_tpu_torch.ckks.keys import CkksContext
    from hefl_tpu_torch.ckks.quantize import max_interleave

    device = resolve_device(device)
    q = int(CkksContext.create(n=n).modulus)
    grid = {}
    for b in (2, 4, 8):
        k = max_interleave(q, b, clients, guard_bits)
        grid[b] = {"k": int(k), "certified": bool(certify_packing(q, b, k, clients,
                                                                  guard_bits).ok)}
    n_ct = {b: -(-total_params // (grid[b]["k"] * n)) for b in grid}
    bytes_ratio = n_ct[4] / n_ct[8]
    # Fold throughput at each geometry: the same cohort, rows sized by the
    # geometry's ciphertext count.
    num_l = len(_PRIMES)
    tput = {}
    for b in (4, 8):
        rows = _on(synthetic_rows(cohort, b, (n_ct[b], num_l, 64)), device)
        nonces = [(i, 0) for i in range(cohort)]
        best = None
        for _ in range(3):
            acc = OnlineAccumulator(_p_broadcast())
            t0 = time.perf_counter()
            acc.fold_batch(nonces, rows, rows)
            _sync(device)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        tput[b] = cohort / max(best, 1e-9)
    fold_ratio = tput[4] / tput[8]
    return {
        "clients": clients,
        "guard_bits": guard_bits,
        "total_params": total_params,
        "grid": {str(b): grid[b] for b in grid},
        "n_ct": {str(b): int(n_ct[b]) for b in n_ct},
        "bytes_ratio_b4_vs_b8": round(bytes_ratio, 4),
        "bytes_ratio_budget": 0.55,
        "bytes_ratio_ok": bytes_ratio <= 0.55,
        "fold_throughput_ratio_b4_vs_b8": round(fold_ratio, 3),
        "fold_ratio_floor": 1.5,
        "fold_ratio_ok": fold_ratio >= 1.5,
        "certified": all(g["certified"] for g in grid.values()),
    }


# --- The BENCH_LOAD record ----------------------------------------------------


def bench_load_record(cfg: LoadConfig | None = None, workdir: str | None = None,
                      device=None) -> dict:
    """The whole artifact family on one deterministic trace, the folds on
    `device` (CUDA unless given). The trace is driven four times: fsync
    always (the fsync ceiling), fsync commit group-committed (the default),
    fsync commit unbatched (the sha-equality twin), and group-committed with
    `fold_batch` ingest (its released sum sha-equal to the sequential
    run's). `ok` is every gate but the error-feedback fold ratio, which
    the record reports (`ef_packing_record`)."""
    from hefl_tpu_torch import device_record, resolve_device

    device = resolve_device(device)
    cfg = cfg or LoadConfig()
    tmp = None
    if workdir is None:
        tmp = tempfile.TemporaryDirectory(prefix="hefl_load_")
        workdir = tmp.name
    try:
        runs, paths = {}, {}
        for name, pol, grp, batched in (
            ("always", "always", False, False),
            ("commit_grouped", "commit", True, False),
            ("commit_unbatched", "commit", False, False),
            ("commit_grouped_batchfold", "commit", True, True),
        ):
            paths[name] = os.path.join(workdir, f"journal_{name}.jl")
            runs[name] = drive_trace(cfg, paths[name], pol, group_commit=grp,
                                     fold_batched=batched, device=device)
        g, u, a = runs["commit_grouped"], runs["commit_unbatched"], runs["always"]
        b = runs["commit_grouped_batchfold"]
        fsync_ratio = g["fsyncs_per_round"] / max(a["fsyncs_per_round"], 1e-9)
        rec = {
            "config": dataclasses.asdict(cfg),
            "row_shape": list(_ROW_SHAPE),
            "device": device_record(device),
            "runs": runs,
            "group_commit": {
                "sha_equal": g["journal_bytes_sha"] == u["journal_bytes_sha"],
                "fsyncs_per_round_grouped": g["fsyncs_per_round"],
                "fsyncs_per_round_always": a["fsyncs_per_round"],
                "fsync_ratio": round(fsync_ratio, 4),
                "fsync_ratio_budget": 0.1,
                "fsync_ratio_ok": fsync_ratio <= 0.1,
            },
            "batched_fold": {
                "sha_equal": b["sum_sha"] == g["sum_sha"],
                "folds_per_s_sequential": g["folds_per_s"],
                "folds_per_s_batched": b["folds_per_s"],
            },
            "dedup": {"peak": g["dedup_window_peak"], "bound": g["dedup_window_bound"],
                      "ok": g["dedup_bound_ok"]},
            "fold_throughput": fold_throughput_record(device=device),
            "recovery": recovery_record(cfg, paths["commit_grouped"]),
            "gather": gather_record(registry_sizes=sorted({10_000, cfg.num_clients}),
                                    cohort_size=cfg.cohort_size, seed=cfg.seed),
            "ef_packing": ef_packing_record(device=device),
        }
        rec["ok"] = bool(
            rec["group_commit"]["sha_equal"]
            and rec["group_commit"]["fsync_ratio_ok"]
            and rec["batched_fold"]["sha_equal"]
            and rec["dedup"]["ok"]
            and rec["fold_throughput"]["sha_equal"]
            and rec["ef_packing"]["bytes_ratio_ok"]
            and rec["ef_packing"]["certified"]
        )
        return rec
    finally:
        if tmp is not None:
            tmp.cleanup()


def bench_load_smoke_record(device=None) -> dict:
    """The smaller trace (10**4 clients), the same artifact family."""
    return bench_load_record(LoadConfig.smoke(), device=device)


def _main(argv: list[str] | None = None) -> int:
    """The BENCH_LOAD writer: `python -m hefl_tpu_torch.fl.load [--out
    BENCH_TORCH_LOAD.json] [--smoke] [--clients N] [--sweep] [--device D]`;
    exit 1 unless every gate of the record's `ok` holds."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--out", default="BENCH_TORCH_LOAD.json")
    ap.add_argument("--smoke", action="store_true", help="the 10**4-client trace")
    ap.add_argument("--clients", type=int, default=0, help="override the registry size")
    ap.add_argument("--sweep", action="store_true",
                    help="add the commit-latency percentiles over (cohort, quorum) points")
    ap.add_argument("--device", default=None, help="where the folds run (default: cuda)")
    args = ap.parse_args(argv)
    cfg = LoadConfig.smoke() if args.smoke else LoadConfig()
    if args.clients:
        cfg = dataclasses.replace(cfg, num_clients=int(args.clients))
    t0 = time.perf_counter()
    rec = bench_load_record(cfg, device=args.device)
    if args.sweep:
        rec["commit_latency_sweep"] = commit_latency_sweep(cfg)
        rec["ok"] = bool(rec["ok"] and rec["commit_latency_sweep"]["ok"])
    rec["wall_seconds"] = round(time.perf_counter() - t0, 3)
    with open(args.out, "w") as f:
        json.dump({"bench_load": rec, "metrics": obs_metrics.snapshot()}, f, indent=2,
                  sort_keys=True)
    g = rec["group_commit"]
    print(f"bench_load: clients={rec['config']['num_clients']} rounds={rec['config']['rounds']} "
          f"device={rec['device']['kind']} ({rec['device']['power_limit']}) "
          f"folds/s={rec['runs']['commit_grouped']['folds_per_s']} "
          f"fsync_ratio={g['fsync_ratio']} sha_equal={g['sha_equal']} "
          f"ef_bytes={rec['ef_packing']['bytes_ratio_b4_vs_b8']} "
          f"ef_fold={rec['ef_packing']['fold_throughput_ratio_b4_vs_b8']} "
          f"ok={rec['ok']} -> {args.out}")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(_main())
