"""Write-ahead round journal: the durable half of the aggregation service.

Counterpart of `hefl_tpu.fl.journal`, byte-identical on disk: the same
frame, the same hash chain, the same JSON, the same bodies. Every piece of
the streaming engine's mid-round state — the `OnlineAccumulator`'s running
ciphertext fold, the dedup nonce window, carried stale uploads — lives in
process memory; without this journal a server crash between round
checkpoints silently destroys arrived (and DP-accounted) client uploads.

This module is the journal itself; `fl.server.AggregationServer` is the
recover-then-serve lifecycle built on it. Design:

  * **Append-only, CRC-framed, hash-chained.** One record = one frame:

        MAGIC(4) | u32 payload_len | u32 crc32(payload) | chain(32) | payload

    `chain_i = sha256(chain_{i-1} || payload_i)` with a fixed seed, so a
    record cannot be altered, dropped, or reordered without breaking every
    digest after it. `payload = json_line [\\x00 body]`; ciphertext bodies
    (client uploads, stale carries) ride as raw uint32 bytes — the uint32
    view of the port's int32 residues, as `utils/serialization.py` writes
    them — with their sha256 in the json line: the same digest
    `fl.stream.ct_hash` computes, so journal evidence and the streaming
    bitwise gates speak one currency.

  * **Crash-anywhere recovery.** `read_journal(repair=True)` classifies
    damage by its only two honest causes: an INCOMPLETE frame at EOF is a
    torn append (the tail a killed `write(2)` leaves) and is truncated
    with a counted `journal.torn_tail_truncated`; a COMPLETE frame whose
    CRC or chain digest fails cannot come from a torn append — the file
    was edited or the disk lied — and recovery fails LOUDLY
    (`JournalCorruptError` / `JournalChainError`), never silently
    shrinking the record.

  * **Replay = re-execution with verification.** The engine journals every
    transition (round_open, retry, fold with the upload's content hash,
    dedup hit, reject, miss, commit with the canonical-sum sha256, stale
    carry, round_close). On recovery the same deterministic round runs
    again with the journal as its script (`RoundSession(replay=...)`):
    each transition the engine re-derives must MATCH the journaled record
    (kind + fields + content sha) or recovery raises
    `JournalReplayError`; folds re-fold the journal's persisted bytes
    through the same `OnlineAccumulator`. The recovered round therefore
    ends in a state whose canonical-sum sha256 is bitwise-equal to an
    uninterrupted run — the property the kill-at-every-boundary tests
    pin.

  * **Fsync policy** (`always` | `commit` | `never`, default `commit`):
    `always` fsyncs every append (maximum durability, slowest), `commit`
    fsyncs the transaction boundaries (commit / degrade / round_close /
    journal_open) — a crash can cost at most the open round's tail, which
    replay re-derives — `never` leaves flushing to the OS (CI/smoke).
    `HEFL_JOURNAL_FSYNC` overrides the default when no explicit policy is
    passed.

  * **Compaction** (`compact`): once a round checkpoint persists the
    global model, records older than the checkpoint round are dead weight;
    compaction rewrites the journal keeping only the records recovery can
    still need — everything from the checkpoint round on, plus the
    previous round's `carry`/`round_close` records (the pending uploads
    and dedup window the next round starts from). The rewritten file
    re-seeds the hash chain and stamps `base_round` in its header.

Two fields differ from the JAX package's in content, not in form:

  * `round_open`'s `key` holds the port's round seed (a 64-bit integer
    drawn from the run's `torch.Generator`) as two uint32 words
    `[hi, lo]` — the shape of JAX's threefry key data. Either package
    READS the other's journal (scan, verify, compact, recover its sealed
    state), but neither REPLAYS the other's rounds: replay re-derives
    every upload from the package's own randomness, and the content
    hashes would not match.
  * `sha` / `sum_sha` are sha256 of the uint32 bytes of the port's
    residues — the JAX package's currency, over the port's ciphertexts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import zlib
from typing import Any

import numpy as np
import torch

from hefl_tpu_torch.fl.faults import SimulatedCrash

MAGIC = b"HJL1"
_LEN_CRC = struct.Struct("<II")
_PREFIX = len(MAGIC) + _LEN_CRC.size + 32  # magic + len + crc + chain
_CHAIN_SEED = hashlib.sha256(b"hefl-journal-chain-v1").digest()
# A frame length beyond this is a corrupt length field, not a real record
# (the largest real body is one flagship ciphertext pair, ~5 MB).
_MAX_PAYLOAD = 1 << 30

FSYNC_POLICIES = ("always", "commit", "never")
# Records that close a transaction: under the default "commit" policy these
# are the appends that hit the platter before append() returns.
_COMMIT_KINDS = frozenset(
    {"journal_open", "commit", "degrade", "round_close"}
)
# Group-commit batching cap: buffered frames are written out in
# one write(2) no later than this many appends, bounding both the
# in-process buffer and the window an external tail-reader lags behind.
_GROUP_COMMIT_MAX = 256
# journal.flush_latency_s histogram bounds (seconds): the durable
# write+fsync pair at a flush point is syscall-scale work, so the healthy
# regime is sub-millisecond on a local disk.
_FLUSH_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.25)
# Record kinds that belong to one round's lifecycle (everything but the
# file header); recovery groups these by their "round" field.
ROUND_KINDS = (
    "round_open", "retry", "fold", "tier_fold", "ship_retry", "dedup",
    "reject", "miss", "commit", "degrade", "carry", "tier_carry",
    "round_close",
)


class JournalError(RuntimeError):
    """Base class: the journal cannot be used as-is."""


class JournalCorruptError(JournalError):
    """A COMPLETE frame failed its CRC or cannot be parsed — not a torn
    append (those are incomplete at EOF) but external damage. Recovery
    must fail loudly, never silently shrink the record."""


class JournalChainError(JournalError):
    """A frame's hash-chain digest does not extend its predecessor's —
    a record was altered, dropped, or reordered after the fact."""


class JournalReplayError(JournalError):
    """Replay divergence: the recovering engine re-derived a transition
    that does not match the journaled record (different kind, fields, or
    content hash). Either the journal belongs to a different run or the
    round is no longer deterministic — both must stop recovery."""


def default_fsync_policy() -> str:
    """`HEFL_JOURNAL_FSYNC` when set, else "commit". An unrecognized value raises — the
    operator who exported `always` with a typo must not be silently
    downgraded to a weaker durability guarantee."""
    pol = os.environ.get("HEFL_JOURNAL_FSYNC")
    if pol is None or pol == "":
        return "commit"
    if pol not in FSYNC_POLICIES:
        raise ValueError(
            f"HEFL_JOURNAL_FSYNC={pol!r}: must be one of {FSYNC_POLICIES}"
        )
    return pol


def _canon(fields: dict) -> dict:
    """JSON-canonical copy of a record's fields (numpy and torch scalars ->
    python, tuples -> lists) so live-vs-replay comparison is exact
    regardless of which side round-tripped through the file."""
    def c(v: Any):
        if isinstance(v, torch.Tensor):
            v = v.tolist()
        if isinstance(v, (list, tuple)):
            return [c(x) for x in v]
        if isinstance(v, dict):
            return {str(k): c(x) for k, x in v.items()}
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, (np.floating,)):
            return float(v)
        if isinstance(v, np.bool_):
            return bool(v)
        return v

    return {str(k): c(v) for k, v in fields.items()}


# ---------------------------------------------------------------------------
# Ciphertext bodies: raw uint32 bytes + the ct_hash-compatible digest.
# ---------------------------------------------------------------------------


def host_u32(x) -> np.ndarray:
    """Residues (a torch tensor on any device, or an array) as a contiguous
    host uint32 array: canonical int32 residues are below 2**31, so this is
    their uint32 view, the JAX package's dtype."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x).astype(np.uint32, copy=False))


def ct_body(c0, c1) -> bytes:
    """Serialize a ciphertext residue pair as the journal body: c0 bytes
    then c1 bytes (both uint32, same shape)."""
    return host_u32(c0).tobytes() + host_u32(c1).tobytes()


def ct_body_sha(c0, c1) -> str:
    """sha256 of the body — delegated to `fl.stream.ct_hash` so the
    journal's content hashes and the streaming bitwise gates are one
    digest, not two implementations that could drift. (Lazy import:
    stream pulls the whole FL round machinery.)"""
    from hefl_tpu_torch.fl.stream import ct_hash

    return ct_hash(c0, c1)


def ct_from_body(body: bytes, shape) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of `ct_body` for a known residue shape -> host uint32
    arrays (read-only views of `body`)."""
    shape = tuple(int(d) for d in shape)
    half = len(body) // 2
    c0 = np.frombuffer(body[:half], dtype=np.uint32).reshape(shape)
    c1 = np.frombuffer(body[half:], dtype=np.uint32).reshape(shape)
    return c0, c1


# ---------------------------------------------------------------------------
# Frame codec + reader.
# ---------------------------------------------------------------------------


def _encode_payload(rec: dict, body: bytes | None) -> bytes:
    head = json.dumps(rec, sort_keys=True, separators=(",", ":")).encode()
    return head if body is None else head + b"\x00" + body


def _decode_payload(payload: bytes) -> tuple[dict, bytes | None]:
    i = payload.find(b"\x00")
    if i < 0:
        return json.loads(payload.decode()), None
    return json.loads(payload[:i].decode()), payload[i + 1:]


@dataclasses.dataclass
class ScanResult:
    records: list[dict]        # parsed records; body bytes under "body"
    good_bytes: int            # offset of the first byte past the last
                               # complete, verified frame
    torn_bytes: int            # trailing bytes of an incomplete frame
    chain: bytes               # chain digest after the last good frame


def scan_journal(path: str) -> ScanResult:
    """Walk the frames, verifying CRC and hash chain.

    An incomplete frame at EOF is reported as a torn tail (repairable); a
    complete frame that fails CRC/parse raises JournalCorruptError and a
    chain mismatch raises JournalChainError — both fail-loud, see the
    module doc for why the classification is exhaustive.

    The walk STREAMS frame by frame (never the whole file at once), so
    recovery/compaction peak memory is the parsed records — which must
    live anyway — not records plus a second full-file bytes copy.
    """
    records: list[dict] = []
    chain = _CHAIN_SEED
    off = 0
    with open(path, "rb") as f:
        while True:
            head = f.read(_PREFIX)
            if not head:
                return ScanResult(records, off, 0, chain)
            if len(head) < _PREFIX:
                return ScanResult(records, off, len(head), chain)
            if head[:4] != MAGIC:
                raise JournalCorruptError(
                    f"{path}: bad frame magic at offset {off} — the "
                    "journal was damaged after the write (appends are "
                    "whole frames)"
                )
            plen, crc = _LEN_CRC.unpack_from(head, 4)
            if plen > _MAX_PAYLOAD:
                raise JournalCorruptError(
                    f"{path}: frame at offset {off} declares an "
                    f"impossible payload length {plen}"
                )
            rec_chain = head[12:44]
            payload = f.read(plen)
            if len(payload) < plen:
                # A torn append: the tail is a PREFIX of the frame being
                # written when the process died.
                return ScanResult(
                    records, off, _PREFIX + len(payload), chain
                )
            if zlib.crc32(payload) != crc:
                raise JournalCorruptError(
                    f"{path}: CRC mismatch on the complete frame at "
                    f"offset {off} — a torn append cannot produce this; "
                    "the file was damaged after the write"
                )
            want_chain = hashlib.sha256(chain + payload).digest()
            if rec_chain != want_chain:
                raise JournalChainError(
                    f"{path}: hash-chain break at offset {off} (record "
                    f"{len(records)}): the record does not extend its "
                    "predecessor — altered, dropped, or reordered history"
                )
            try:
                rec, body = _decode_payload(payload)
            except (ValueError, UnicodeDecodeError) as e:
                raise JournalCorruptError(
                    f"{path}: unparseable record payload at offset {off} "
                    f"({e}) despite a valid CRC"
                ) from e
            if body is not None:
                rec["body"] = body
            records.append(rec)
            chain = want_chain
            off += _PREFIX + plen


def read_journal(path: str, repair: bool = False) -> list[dict]:
    """Parse a journal back into records.

    repair=False (the gate/test-side default) raises JournalError on ANY
    damage, torn tail included. repair=True truncates a torn tail in
    place (counting `journal.torn_tail_truncated`) and returns the intact
    prefix — the recovery-side open; CRC/chain damage still raises.
    """
    scan = scan_journal(path)
    if scan.torn_bytes:
        if not repair:
            raise JournalError(
                f"{path}: torn tail ({scan.torn_bytes} trailing bytes of "
                "an incomplete frame); open with repair=True to truncate"
            )
        os.truncate(path, scan.good_bytes)
        from hefl_tpu_torch.obs import events as obs_events
        from hefl_tpu_torch.obs import metrics as obs_metrics

        obs_metrics.counter("journal.torn_tail_truncated").inc()
        obs_events.emit(
            "journal_torn_tail", path=path,
            truncated_bytes=scan.torn_bytes,
        )
    return scan.records


# ---------------------------------------------------------------------------
# Writer.
# ---------------------------------------------------------------------------


class JournalWriter:
    """Append-only frame writer with the configured fsync policy.

    Use `open_journal` to construct: it scans (and repairs) an existing
    file so the chain resumes from the last intact frame, and writes the
    `journal_open` header on a fresh file.

    **Group commit** (`group_commit=True`, the default): under
    `fsync_policy="commit"` the writer BUFFERS encoded frames in process
    and writes them in one `write(2)` at each transaction boundary
    (commit / degrade / round_close / journal_open), immediately before
    the boundary's single fsync — one syscall pair per transaction
    instead of one write+flush per append. The hash chain still advances
    per LOGICAL append (each digest is a pure function of the payload
    sequence), so a group-committed journal is BYTE-IDENTICAL to the
    unbatched writer's on the same record stream. Durability is unchanged: the
    "commit" contract only ever promised the platter at transaction
    boundaries, and a crash mid-transaction loses at most the open
    round's tail, which replay re-derives. A buffer that reaches
    `_GROUP_COMMIT_MAX` frames is written out early (no fsync) so the
    buffer stays bounded under fold storms. `always`/`never` policies
    are never buffered.
    """

    def __init__(
        self,
        path: str,
        fsync_policy: str | None = None,
        count_metrics: bool = True,
        group_commit: bool = True,
    ):
        pol = fsync_policy or default_fsync_policy()
        if pol not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync_policy={pol!r}: must be one of {FSYNC_POLICIES}"
            )
        self.path = path
        self.fsync_policy = pol
        # journal.* append counters measure ENGINE-transition traffic;
        # compaction's rewrite of surviving records passes False so the
        # telemetry doesn't inflate on every checkpoint.
        self.count_metrics = count_metrics
        self.group_commit = bool(group_commit) and pol == "commit"
        self._chain = _CHAIN_SEED
        self._f = None
        self._buf: list[bytes] = []

    def _open(self, chain: bytes) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "ab")
        self._chain = chain

    def _flush_buf(self, fsync: bool) -> None:
        """Write all buffered frames in one write(2); optionally fsync.
        The single write keeps the on-disk byte stream identical to the
        per-append writer's (frames land whole and in order; a kill mid-
        write leaves a torn SUFFIX that truncates to the last whole
        frame, exactly like a torn single append)."""
        import time as _time

        from hefl_tpu_torch.obs import metrics as obs_metrics
        from hefl_tpu_torch.obs import spans as obs_spans

        tracer = obs_spans.current() if self.count_metrics else None
        t0 = _time.perf_counter()
        if self._buf:
            nframes = len(self._buf)
            if tracer is not None:
                with tracer.measure("group_commit_flush", frames=nframes):
                    self._f.write(b"".join(self._buf))
                    self._f.flush()
            else:
                self._f.write(b"".join(self._buf))
                self._f.flush()
            self._buf.clear()
            if self.count_metrics:
                obs_metrics.counter("journal.write_batches").inc()
        if fsync:
            if tracer is not None:
                with tracer.measure("fsync"):
                    os.fsync(self._f.fileno())
            else:
                os.fsync(self._f.fileno())
            if self.count_metrics:
                obs_metrics.counter("journal.fsyncs").inc()
        if self.count_metrics and fsync:
            # Flush latency: the durable write+fsync pair at a flush
            # point — the journal's contribution to commit latency,
            # queryable as p50/p95/p99 via Histogram.quantile.
            obs_metrics.histogram(
                "journal.flush_latency_s", bounds=_FLUSH_BUCKETS
            ).observe(round(_time.perf_counter() - t0, 9))

    def append(self, kind: str, fields: dict, body: bytes | None = None) -> dict:
        rec = {"kind": kind, **_canon(fields)}
        payload = _encode_payload(rec, body)
        chain = hashlib.sha256(self._chain + payload).digest()
        frame = (
            MAGIC
            + _LEN_CRC.pack(len(payload), zlib.crc32(payload))
            + chain
            + payload
        )
        from hefl_tpu_torch.obs import metrics as obs_metrics
        from hefl_tpu_torch.obs import spans as obs_spans

        tracer = obs_spans.current() if self.count_metrics else None
        if self.count_metrics:
            obs_metrics.counter("journal.appends").inc()
            obs_metrics.counter("journal.bytes_written").inc(len(frame))
        if tracer is not None:
            # One point span per LOGICAL append (== journal.appends); the
            # write(2)/fsync syscall spans come from _flush_buf / below.
            t = tracer.wall()
            tracer.add("journal_append", t, t, clock="wall", kind_=kind,
                       bytes=len(frame))
        if self.group_commit:
            # Chain advancement stays per LOGICAL append; only the
            # write/flush/fsync syscalls batch to the transaction
            # boundary.
            self._buf.append(frame)
            self._chain = chain
            if kind in _COMMIT_KINDS:
                self._flush_buf(fsync=True)
            elif len(self._buf) >= _GROUP_COMMIT_MAX:
                self._flush_buf(fsync=False)
            return rec
        self._f.write(frame)
        self._f.flush()
        if self.fsync_policy == "always" or (
            self.fsync_policy == "commit" and kind in _COMMIT_KINDS
        ):
            import time as _time

            t0 = _time.perf_counter()
            if tracer is not None:
                with tracer.measure("fsync"):
                    os.fsync(self._f.fileno())
            else:
                os.fsync(self._f.fileno())
            if self.count_metrics:
                obs_metrics.counter("journal.fsyncs").inc()
                obs_metrics.histogram(
                    "journal.flush_latency_s", bounds=_FLUSH_BUCKETS
                ).observe(round(_time.perf_counter() - t0, 9))
        self._chain = chain
        return rec

    def append_torn(
        self, kind: str, fields: dict, body: bytes | None, nbytes: int
    ) -> None:
        """Write only the first `nbytes` of the frame — the REAL torn
        record a kill mid-`write(2)` leaves (crash injection's mid_append
        point). The chain state is NOT advanced: this frame never
        completed. Buffered group-commit frames are written out first:
        they logically precede the torn append, and a real kill mid-batch
        tears the batch's SUFFIX — complete predecessors, one partial
        tail — which is exactly this layout."""
        rec = {"kind": kind, **_canon(fields)}
        payload = _encode_payload(rec, body)
        chain = hashlib.sha256(self._chain + payload).digest()
        frame = (
            MAGIC
            + _LEN_CRC.pack(len(payload), zlib.crc32(payload))
            + chain
            + payload
        )
        nbytes = max(1, min(int(nbytes), len(frame) - 1))
        if self._buf:
            self._f.write(b"".join(self._buf))
            self._buf.clear()
        self._f.write(frame[:nbytes])
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._flush_buf(fsync=False)
            self._f.close()
            self._f = None


def open_journal(
    path: str,
    fsync_policy: str | None = None,
    meta: dict | None = None,
    group_commit: bool = True,
) -> tuple[JournalWriter, list[dict], int]:
    """Open (creating or recovering) a journal for appending.

    -> (writer, existing records, torn_bytes_truncated). A fresh file gets
    a `journal_open` header carrying `meta` (the stream-config echo the
    server verifies on recovery); an existing file is scanned with torn-
    tail repair and the chain resumed from its last intact frame.
    `group_commit=False` forces the historical one-write-per-append
    writer (the sha-equality twin the load harness compares against).
    """
    w = JournalWriter(path, fsync_policy, group_commit=group_commit)
    if os.path.exists(path) and os.path.getsize(path) > 0:
        scan = scan_journal(path)
        torn = scan.torn_bytes
        if torn:
            os.truncate(path, scan.good_bytes)
            from hefl_tpu_torch.obs import events as obs_events
            from hefl_tpu_torch.obs import metrics as obs_metrics

            obs_metrics.counter("journal.torn_tail_truncated").inc()
            obs_events.emit(
                "journal_torn_tail", path=path, truncated_bytes=torn
            )
        w._open(scan.chain)
        if not scan.records:
            # The file held ONLY a torn frame (a crash during the very
            # first append): after truncation it is an empty journal and
            # must get its header like any fresh file — otherwise the
            # stream-config echo the server verifies on recovery would
            # never exist.
            w.append("journal_open", {"version": 1, "meta": meta or {}})
        return w, scan.records, torn
    w._open(_CHAIN_SEED)
    w.append("journal_open", {"version": 1, "meta": meta or {}})
    return w, [], 0


# ---------------------------------------------------------------------------
# Round session: the engine's journal hook, with replay verification and
# deterministic crash injection.
# ---------------------------------------------------------------------------


class RoundSession:
    """One round's journaling surface, handed to `StreamEngine.run_round`.

    Live mode (replay empty): every transition appends a record, and the
    configured CrashConfig boundary raises SimulatedCrash (after writing
    any torn prefix). Replay mode: transitions are matched against the
    journaled records IN ORDER — a mismatch raises JournalReplayError —
    and fold records hand their persisted bytes back to the engine so the
    recovered accumulator re-folds exactly what was journaled. The replay
    queue may run dry mid-round (the crash point): the remaining
    transitions continue live, seamlessly.
    """

    def __init__(self, writer: JournalWriter | None, crash=None, replay=None):
        self.writer = writer
        self.crash = crash
        self._replay = list(replay or [])
        self._ri = 0
        self.replayed = 0
        self.replayed_folds = 0
        self._folds = 0

    # -- core ---------------------------------------------------------------

    def _record(self, kind: str, fields: dict, body: bytes | None = None):
        fields = _canon(fields)
        if body is not None:
            fields["sha"] = hashlib.sha256(body).hexdigest()
        if self._ri < len(self._replay):
            rec = self._replay[self._ri]
            self._ri += 1
            want = {k: v for k, v in rec.items() if k not in ("kind", "body")}
            if rec.get("kind") != kind or want != fields:
                raise JournalReplayError(
                    f"replay divergence at record {self._ri - 1}: journal "
                    f"has {rec.get('kind')} {want!r} but the re-executed "
                    f"round derived {kind} {fields!r} — the journal does "
                    "not match this run (wrong config/seed, or lost "
                    "determinism)"
                )
            self.replayed += 1
            if kind == "fold":
                self.replayed_folds += 1
                self._folds += 1
            return rec.get("body")
        if self.writer is None:
            return None
        if kind == "fold":
            self._folds += 1
        self._maybe_crash(kind, fields, body, before=True)
        self.writer.append(kind, fields, body)
        self._maybe_crash(kind, fields, body, before=False)
        return None

    def _maybe_crash(self, kind, fields, body, before: bool) -> None:
        c = self.crash
        if c is None or fields.get("round") != c.round:
            return
        if kind == "fold" and self._folds == c.after_folds:
            if before and c.at == "mid_append":
                self.writer.append_torn(kind, fields, body, c.torn_bytes)
                raise SimulatedCrash(
                    f"crash injection: torn append mid-fold {c.after_folds} "
                    f"of round {c.round}"
                )
            if not before and c.at == "post_fold":
                raise SimulatedCrash(
                    f"crash injection: after fold {c.after_folds} of round "
                    f"{c.round}"
                )
        if kind == "commit":
            if before and c.at == "pre_commit":
                raise SimulatedCrash(
                    f"crash injection: before the commit record of round "
                    f"{c.round}"
                )
            if not before and c.at == "post_commit":
                raise SimulatedCrash(
                    f"crash injection: after the commit record of round "
                    f"{c.round} (before carries/close)"
                )
        if kind == "round_close" and not before and c.at == "post_close":
            raise SimulatedCrash(
                f"crash injection: after round {c.round} closed (before "
                "the checkpoint)"
            )

    # -- typed transitions (what the engine calls) --------------------------

    def round_open(self, round_index, key_data, cohort, quorum, tau,
                   num_clients, packed_clients) -> None:
        self._record("round_open", dict(
            round=int(round_index), key=list(key_data),
            cohort=[int(c) for c in cohort], quorum=int(quorum),
            tau=int(tau), num_clients=int(num_clients),
            packed_clients=packed_clients,
        ))

    def retry(self, round_index, client, nonce, attempt, t) -> None:
        self._record("retry", dict(
            round=int(round_index), client=int(client), nonce=list(nonce),
            attempt=int(attempt), t=float(t),
        ))

    def fold(self, round_index, seq, src, client, nonce, lateness, t,
             c0, c1, persist: bool):
        """-> (c0, c1) to fold: the journal's persisted bytes on replay
        (verified against the re-derived upload's content hash), the live
        arrays otherwise. persist=False records the content hash only
        (stale folds: the bytes are already durable in the origin round's
        carry record). `src` is "fresh" | "stale"."""
        fields = dict(
            round=int(round_index), seq=int(seq), src=src,
            client=int(client), nonce=list(nonce), lateness=int(lateness),
            t=float(t),
        )
        if persist:
            body = self._record("fold", fields, body=ct_body(c0, c1))
            if body is not None:
                return ct_from_body(body, tuple(c0.shape))
            return c0, c1
        fields["sha"] = ct_body_sha(c0, c1)
        self._record("fold", fields)
        return c0, c1

    def dedup(self, round_index, seq, client, nonce) -> None:
        self._record("dedup", dict(
            round=int(round_index), seq=int(seq), client=int(client),
            nonce=list(nonce),
        ))

    def reject(self, round_index, seq, client, nonce) -> None:
        self._record("reject", dict(
            round=int(round_index), seq=int(seq), client=int(client),
            nonce=list(nonce),
        ))

    def miss(self, round_index, seq, src, client, nonce, t, lateness) -> None:
        self._record("miss", dict(
            round=int(round_index), seq=int(seq), src=src,
            client=int(client), nonce=list(nonce), t=float(t),
            lateness=int(lateness),
        ))

    def commit(self, round_index, sum_sha, surviving, fresh, stale_folded,
               commit_s) -> None:
        self._record("commit", dict(
            round=int(round_index), sum_sha=sum_sha, surviving=int(surviving),
            fresh=int(fresh), stale_folded=int(stale_folded),
            commit_s=float(commit_s),
        ))

    def degrade(self, round_index, reason, fresh, quorum) -> None:
        self._record("degrade", dict(
            round=int(round_index), reason=reason, fresh=int(fresh),
            quorum=int(quorum),
        ))

    def carry(self, round_index, client, origin_round, nonce, lands_at,
              lateness, c0, c1) -> None:
        self._record("carry", dict(
            round=int(round_index), client=int(client),
            origin_round=int(origin_round), nonce=list(nonce),
            lands_at=float(lands_at), lateness=int(lateness),
            shape=[int(d) for d in c0.shape],
        ), body=ct_body(c0, c1))

    def tier_fold(self, round_index, host, origin_round, sha, clients,
                  lateness) -> None:
        """A carried STALE TIER PARTIAL folding at the root this round
        (hierarchical engine). Hash-only: the partial's bytes are already durable in
        the origin round's tier_carry record — the stale-fold analog of
        fold(persist=False)."""
        self._record("tier_fold", dict(
            round=int(round_index), host=int(host),
            origin_round=int(origin_round), sha=sha, clients=int(clients),
            lateness=int(lateness),
        ))

    def ship_retry(self, round_index, host, attempt, t, lost) -> None:
        """One tier->root ship redelivery attempt on the virtual clock
        — the session-level mirror of the per-tier WAL's
        tier_ship attempt records, so engine replay re-derives the full
        retry timeline."""
        self._record("ship_retry", dict(
            round=int(round_index), host=int(host), attempt=int(attempt),
            t=float(t), lost=bool(lost),
        ))

    def tier_carry(self, round_index, host, origin_round, clients,
                   lateness, c0, c1) -> None:
        """A sealed tier partial that missed this round's ship, carried
        into the next round under host_staleness_rounds —
        payload-bearing like carry(): recovery re-materializes the pending
        partial from these bytes."""
        self._record("tier_carry", dict(
            round=int(round_index), host=int(host),
            origin_round=int(origin_round),
            clients=[int(c) for c in clients], lateness=int(lateness),
            shape=[int(d) for d in c0.shape],
        ), body=ct_body(c0, c1))

    def close(self, round_index, committed, surviving, excluded, seen) -> None:
        self._record("round_close", dict(
            round=int(round_index), committed=bool(committed),
            surviving=int(surviving), excluded=dict(excluded),
            seen=sorted([int(c), int(r)] for c, r in seen),
        ))


# ---------------------------------------------------------------------------
# Compaction: bounded journal growth, anchored to the round checkpoint.
# ---------------------------------------------------------------------------


def compact(
    path: str, keep_from_round: int, fsync_policy: str | None = None
) -> tuple[int, int]:
    """Rewrite the journal keeping only what recovery can still need once
    a round checkpoint covers everything before `keep_from_round`: records
    of rounds >= keep_from_round, plus round keep_from_round-1's
    carry/tier_carry/round_close records (the pending uploads, pending
    tier partials, and dedup window the next round starts from). Atomic
    (tmp + rename); the rewritten file re-seeds the hash chain and stamps
    `base_round`. -> (kept, dropped) round-record counts."""
    records = read_journal(path, repair=True)
    header_meta: dict = {}
    for rec in records:
        if rec.get("kind") == "journal_open":
            header_meta = rec.get("meta", {})
            break
    keep: list[dict] = []
    dropped = 0
    for rec in records:
        kind = rec.get("kind")
        if kind == "journal_open":
            continue
        r = rec.get("round", -1)
        if r >= keep_from_round or (
            r == keep_from_round - 1
            and kind in ("carry", "tier_carry", "round_close")
        ):
            keep.append(rec)
        else:
            dropped += 1
    tmp = path + ".compact.tmp"
    w = JournalWriter(tmp, fsync_policy, count_metrics=False)
    w._open(_CHAIN_SEED)
    w.append("journal_open", {
        "version": 1, "meta": header_meta,
        "base_round": int(keep_from_round),
    })
    for rec in keep:
        body = rec.get("body")
        fields = {
            k: v for k, v in rec.items() if k not in ("kind", "body")
        }
        if body is not None:
            # The copy must carry the original record VERBATIM (replay
            # compares fields exactly, sha included); verify the content
            # hash still matches the body before re-writing it.
            got = hashlib.sha256(body).hexdigest()
            if fields.get("sha") != got:
                w.close()
                os.unlink(tmp)
                raise JournalCorruptError(
                    f"{path}: compaction found a body whose sha256 {got} "
                    f"does not match its record ({fields.get('sha')}) — "
                    "refusing to copy corrupt history"
                )
        w.append(rec["kind"], fields, body)
    w.close()
    os.replace(tmp, path)
    from hefl_tpu_torch.obs import events as obs_events
    from hefl_tpu_torch.obs import metrics as obs_metrics

    obs_metrics.counter("journal.compactions").inc()
    obs_metrics.counter("journal.records_dropped").inc(dropped)
    obs_events.emit(
        "journal_compacted", path=path, base_round=int(keep_from_round),
        kept=len(keep), dropped=dropped,
    )
    return len(keep), dropped


__all__ = [
    "FSYNC_POLICIES",
    "ROUND_KINDS",
    "JournalError",
    "JournalCorruptError",
    "JournalChainError",
    "JournalReplayError",
    "SimulatedCrash",
    "JournalWriter",
    "RoundSession",
    "ScanResult",
    "ct_body",
    "ct_body_sha",
    "ct_from_body",
    "compact",
    "default_fsync_policy",
    "open_journal",
    "read_journal",
    "scan_journal",
]
