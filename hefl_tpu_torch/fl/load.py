"""Server hot-path load trace: the journal, the dedup window and the fold
at registry scale, on synthetic ciphertext bodies.

Counterpart of `hefl_tpu.fl.load`, as far as the journal's bitwise gate
needs it: `LoadConfig` (the trace's registry scale and fault schedule),
`synthetic_rows`, `drive_trace` (the real `fl.journal.JournalWriter` /
`RoundSession` record stream, `fl.stream.DedupWindow` and
`OnlineAccumulator` over one deterministic trace) and `recovery_record`
(scan seconds against journal length). No training, no encryption: random
canonical residues at a toy (n_ct, L, N) geometry ride the real code.

The record stream — and so the journal's bytes — is a pure function of the
trace, so `drive_trace(LoadConfig(), path, policy)` reproduces the JAX
package's `journal_bytes_sha` and `sum_sha` in BENCH_LOAD.json under every
fsync policy, group-committed or not, folded one at a time or batched.
`fold_throughput_record` times the fold sequential, batched and through the
hierarchical tree over the same rows (sha-gated equal), and
`ef_packing_record` the b = 4 error-feedback grid against b = 8; both fold
on the device given (CUDA unless the caller passes another). The rest of the JAX module (the
commit-latency sweep, the cohort-gather record, `bench_load_record` and
`_main`) is not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from hefl_tpu_torch.fl import journal as jr
from hefl_tpu_torch.fl.config import StreamConfig
from hefl_tpu_torch.fl.faults import FaultConfig, schedule_arrivals
from hefl_tpu_torch.fl.stream import (
    DedupWindow,
    OnlineAccumulator,
    ct_hash,
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
) -> dict:
    """Run the full trace against a real journal + window + accumulator.

    One fold body per fresh delivery (synthetic rows, cohort-sized pool
    re-indexed by client so a replayed nonce re-presents ITS bytes); the
    record stream (and therefore the journal's hash chain) is a pure
    function of (cfg, fsync-independent) — the property the group-commit
    sha-equality gate rests on. -> per-trace stats dict.
    """
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
            batch_nonces, batch_rows = [], []
            for seq, (t, c, nonce, stale) in enumerate(deliveries):
                if nonce in seen:
                    session.dedup(r, seq, c, nonce)
                    dedups += 1
                    continue
                seen.add(nonce)
                row = rows[row_of[c]] if c in row_of else rows[0]
                session.fold(r, seq, "fresh", c, nonce, 0, t,
                             row, row, persist=True)
                batch_nonces.append(nonce)
                batch_rows.append(row)
                folds += 1
            if batch_rows:
                b = np.stack(batch_rows)
                acc.fold_batch(batch_nonces, b, b)
        else:
            for seq, (t, c, nonce, stale) in enumerate(deliveries):
                if nonce in seen:
                    session.dedup(r, seq, c, nonce)
                    dedups += 1
                    continue
                seen.add(nonce)
                row = rows[row_of[c]] if c in row_of else rows[0]
                fc0, fc1 = session.fold(r, seq, "fresh", c, nonce, 0, t,
                                        row, row, persist=True)
                acc.fold(nonce, fc0, fc1)
                folds += 1
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
    before the clock)."""
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
