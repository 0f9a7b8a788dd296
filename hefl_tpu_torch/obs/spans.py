"""Round-lifecycle span tracing.

Counterpart of `hefl_tpu.obs.spans`, span for span. `SpanTracer`
records a structured span TREE per round on the engine's virtual clock (`clock="virtual"`: seconds since round start, the same
axis `_Delivery.t` / `commit_s` / `ships_done_s` live on) with wall-clock
spans (`clock="wall"`: perf_counter seconds since the tracer opened) for
the process-IO legs the virtual clock cannot see (journal writes, fsync,
transciphering, recovery replay).

Span kinds and their producers:

  round               the tracer root (one per `StreamEngine.run_round`)
  arrival             every fresh delivery processed (== stream.arrivals)
  retry               every scheduled redelivery   (== stream.retries)
  fold                every client fold, fresh or stale (== stream.folds)
  transcipher         the HHE batch transcipher dispatch (wall)
  tier_fold           a carried stale HOST partial folded at the root
                      (== dcn.tier.stale_folded)
  tier_ship           one per shipped tier: first send -> landing/miss
                      (== dcn.ship.landed + dcn.ship.missed)
  ship_retry          every retried ship delivery (== dcn.retry.attempts)
  journal_append      every logical WAL append (wall, == journal.appends)
  group_commit_flush  every buffered-batch write(2) (wall,
                      == journal.write_batches)
  fsync               every journal fsync (wall, == journal.fsyncs)
  commit              the round verdict (committed or degraded)
  recovery_replay     a replayed round's marker (== recovery.rounds_replayed)

The `COUNTER_OF` table IS the conservation contract: for every kind it
maps, the per-round span count must equal the per-round delta of the
named `obs.metrics` counters exactly (`conservation_errors` checks it).
The hierarchical kinds (tier_fold, tier_ship, ship_retry) have no
producer in the port's flat engine yet; their counters stay at 0.

Spans ride `obs.events` as a new `span` event kind (one record per span,
emitted at record time; no-op when the global event log is off) and
export to Chrome trace-viewer JSON via `to_trace_events` /
`export_chrome_trace` — the format the JAX package's `obs.trace` parses
(names are `hefl.span.<kind>`).

A replayed round's span tree matches its uninterrupted twin up to the
`recovery_replay` spans and the wall-clock IO spans (replay VERIFIES
journal records instead of appending them): compare with
`tree_signature`, which keys on the deterministic virtual-clock
structure and drops wall-clock spans by default.

Producers reach the active tracer through a module-level current-tracer
slot (`activate` / `current`): the engine installs one tracer per round
and the journal/hierarchy/transcipher layers record into it without
threading a parameter through every call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import itertools
import json
import time
from typing import Any, Iterable, Iterator

from hefl_tpu_torch.obs import events as obs_events

SPAN_KINDS = (
    "round",
    "arrival",
    "retry",
    "fold",
    "transcipher",
    "tier_fold",
    "tier_ship",
    "ship_retry",
    "journal_append",
    "group_commit_flush",
    "fsync",
    "commit",
    "recovery_replay",
)

# Wall-clock span kinds: process-IO artifacts, not round-lifecycle
# structure. Excluded from `tree_signature` by default (replay verifies
# journal records instead of re-appending them, so these legitimately
# differ between a replayed round and its uninterrupted twin).
WALL_KINDS = frozenset(
    {"transcipher", "journal_append", "group_commit_flush", "fsync",
     "recovery_replay"}
)

# kind -> obs.metrics counter name(s) whose per-round delta the per-round
# span count must equal EXACTLY (a tuple sums). Kinds absent here
# ("round", "transcipher", "commit") have no counter twin.
COUNTER_OF: dict[str, tuple[str, ...]] = {
    "arrival": ("stream.arrivals",),
    "retry": ("stream.retries",),
    "fold": ("stream.folds",),
    "tier_fold": ("dcn.tier.stale_folded",),
    "tier_ship": ("dcn.ship.landed", "dcn.ship.missed"),
    "ship_retry": ("dcn.retry.attempts",),
    "journal_append": ("journal.appends",),
    "group_commit_flush": ("journal.write_batches",),
    "fsync": ("journal.fsyncs",),
    "recovery_replay": ("recovery.rounds_replayed",),
}

_TRACE_IDS = itertools.count()


@dataclasses.dataclass
class Span:
    """One recorded span. Times are seconds on the tracer's clock axis
    (`clock`: "virtual" = engine virtual clock, "wall" = process seconds
    since the tracer opened)."""

    kind: str
    t0: float
    t1: float
    clock: str = "virtual"
    args: dict = dataclasses.field(default_factory=dict)
    children: list["Span"] = dataclasses.field(default_factory=list)

    @property
    def dur(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def walk(self) -> Iterator["Span"]:
        """Pre-order traversal, self included."""
        yield self
        for ch in self.children:
            yield from ch.walk()


class SpanTracer:
    """One round's span tree + its event/export surface.

    `add` records a completed span at explicit (virtual-clock) times;
    `measure` is the wall-clock context manager for IO legs. Every
    recorded span also rides the global event log as a `span` event
    immediately (no-op when events are unconfigured), so a crash
    mid-round loses nothing that was recorded."""

    def __init__(self, round_index: int, kind: str = "round"):
        self.round_index = int(round_index)
        self.trace_id = f"r{int(round_index)}.{next(_TRACE_IDS)}"
        self._wall0 = time.perf_counter()
        self._next_id = 0
        self.root = Span(kind, 0.0, 0.0, clock="virtual",
                         args={"round": int(round_index)})
        self._ids: dict[int, int] = {id(self.root): self._take_id()}
        self._finished = False

    def _take_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    def wall(self) -> float:
        """Seconds since the tracer opened (the wall-clock span axis)."""
        return time.perf_counter() - self._wall0

    def add(
        self,
        kind: str,
        t0: float,
        t1: float | None = None,
        parent: Span | None = None,
        clock: str = "virtual",
        **args: Any,
    ) -> Span:
        """Record a completed span (point span when t1 is omitted) under
        `parent` (the root by default) and emit its `span` event."""
        sp = Span(kind, float(t0), float(t0 if t1 is None else t1),
                  clock=clock, args=dict(args))
        (parent if parent is not None else self.root).children.append(sp)
        self._ids[id(sp)] = self._take_id()
        self._emit(sp, parent if parent is not None else self.root)
        return sp

    @contextlib.contextmanager
    def measure(self, kind: str, parent: Span | None = None, **args: Any):
        """Wall-clock span around a `with` body (journal IO, transcipher,
        recovery replay)."""
        t0 = self.wall()
        sp = Span(kind, t0, t0, clock="wall", args=dict(args))
        (parent if parent is not None else self.root).children.append(sp)
        self._ids[id(sp)] = self._take_id()
        try:
            yield sp
        finally:
            sp.t1 = self.wall()
            self._emit(sp, parent if parent is not None else self.root)

    def finish(self, t1: float | None = None) -> None:
        """Seal the root: extend it to cover `t1` (and every child) and
        emit its event. Idempotent."""
        end = float(t1) if t1 is not None else 0.0
        for sp in self.root.walk():
            if sp is not self.root and sp.clock == "virtual":
                end = max(end, sp.t1)
        self.root.t1 = max(self.root.t1, end)
        if not self._finished:
            self._finished = True
            self._emit(self.root, None)

    # -- event + export surface --------------------------------------------

    def _emit(self, sp: Span, parent: Span | None) -> None:
        obs_events.emit(
            "span",
            trace=self.trace_id,
            round=self.round_index,
            span_kind=sp.kind,
            id=self._ids[id(sp)],
            parent=None if parent is None else self._ids[id(parent)],
            t0=round(sp.t0, 9),
            t1=round(sp.t1, 9),
            clock=sp.clock,
            args=sp.args,
        )

    def spans(self) -> list[Span]:
        """Every span, pre-order (root first)."""
        return list(self.root.walk())

    def counts(self) -> dict[str, int]:
        """Per-kind span counts (root excluded)."""
        out: dict[str, int] = {}
        for sp in self.root.walk():
            if sp is self.root:
                continue
            out[sp.kind] = out.get(sp.kind, 0) + 1
        return out

    def to_trace_events(self) -> list[dict]:
        """Chrome trace-viewer events (`ph:"X"`, microsecond ts/dur) —
        the shape `hefl_tpu.obs.trace.load_trace_events` parses; names are
        `hefl.span.<kind>` so they land in trace_attribution host_rows."""
        out = []
        for sp in self.root.walk():
            out.append({
                "ph": "X",
                "name": f"hefl.span.{sp.kind}",
                "ts": round(sp.t0 * 1e6, 3),
                "dur": round(sp.dur * 1e6, 3),
                "args": {
                    "round": self.round_index,
                    "trace": self.trace_id,
                    "clock": sp.clock,
                    **sp.args,
                },
            })
        return out


# ---------------------------------------------------------------------------
# The current-tracer slot producers record into.
# ---------------------------------------------------------------------------

_CURRENT: SpanTracer | None = None


def current() -> SpanTracer | None:
    """The active tracer (None outside a traced round)."""
    return _CURRENT


@contextlib.contextmanager
def activate(tracer: SpanTracer):
    """Install `tracer` as the current tracer for the `with` body. Nested
    activations restore the outer tracer on exit."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer
    try:
        yield tracer
    finally:
        _CURRENT = prev


# ---------------------------------------------------------------------------
# Export, reconstruction, conservation, twin comparison.
# ---------------------------------------------------------------------------


def export_chrome_trace(path: str, tracers: Iterable[SpanTracer]) -> str:
    """Write the tracers' spans as ONE Chrome trace-viewer JSON file
    ({"traceEvents": [...]}; gzipped when `path` ends in .gz). Returns
    `path`. Loadable by `hefl_tpu.obs.trace.load_trace_events`."""
    events: list[dict] = []
    for tr in tracers:
        events.extend(tr.to_trace_events())
    blob = json.dumps({"traceEvents": events}).encode("utf-8")
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)
    return path


def trees_from_events(events: Iterable[dict]) -> dict[str, Span]:
    """Rebuild span trees from `span` event records (obs.events JSONL) ->
    {trace_id: root Span}. Orphaned children (their root never sealed —
    a crash mid-round) are attached to a synthetic root so nothing
    recorded is dropped silently."""
    by_trace: dict[str, list[dict]] = {}
    for ev in events:
        if ev.get("event") == "span":
            by_trace.setdefault(str(ev["trace"]), []).append(ev)
    out: dict[str, Span] = {}
    for trace_id, evs in by_trace.items():
        spans: dict[int, Span] = {}
        parents: dict[int, int | None] = {}
        for ev in evs:
            spans[int(ev["id"])] = Span(
                ev["span_kind"], float(ev["t0"]), float(ev["t1"]),
                clock=ev.get("clock", "virtual"),
                args=dict(ev.get("args") or {}),
            )
            parents[int(ev["id"])] = ev.get("parent")
        root = None
        orphans = []
        for i in sorted(spans):
            pi = parents[i]
            if pi is None:
                root = spans[i]
            elif int(pi) in spans:
                spans[int(pi)].children.append(spans[i])
            else:
                orphans.append(spans[i])
        if root is None:
            root = Span("round", 0.0, 0.0, args={"unsealed": True})
        root.children.extend(orphans)
        out[trace_id] = root
    return out


def span_counts(root: Span) -> dict[str, int]:
    """Per-kind counts under `root` (root itself excluded)."""
    out: dict[str, int] = {}
    for sp in root.walk():
        if sp is root:
            continue
        out[sp.kind] = out.get(sp.kind, 0) + 1
    return out


def conservation_errors(
    counts: dict[str, int], metrics_delta: dict[str, Any]
) -> list[str]:
    """The span-count == counter-delta contract, checked: for every kind
    in COUNTER_OF, span count must equal the summed counter delta
    exactly. -> human-readable violations ([] = conserved). `counts` is
    `SpanTracer.counts()` (or summed across tracers); `metrics_delta` is
    `obs.metrics.snapshot_delta(baseline)` over the same region."""
    errs = []
    for kind, names in COUNTER_OF.items():
        want = sum(int(metrics_delta.get(n, 0) or 0) for n in names)
        got = int(counts.get(kind, 0))
        if got != want:
            errs.append(
                f"span kind {kind!r}: {got} spans but counters "
                f"{'+'.join(names)} moved {want}"
            )
    return errs


def tree_signature(
    root: Span,
    ignore: tuple[str, ...] = ("recovery_replay",),
    include_wall: bool = False,
):
    """A comparable signature of the span tree's DETERMINISTIC structure:
    (kind, virtual times, args, child signatures). Wall-clock spans are
    dropped unless `include_wall` (replay verifies journal records
    instead of re-appending, so IO spans legitimately differ between a
    replayed round and its uninterrupted twin); kinds in `ignore` are
    dropped wholesale — the replay-equals-twin gate compares with the
    defaults."""
    if root.kind in ignore or (not include_wall and root.clock == "wall"):
        return None
    times = (
        (round(root.t0, 6), round(root.t1, 6))
        if root.clock == "virtual"
        else ()
    )
    args = tuple(sorted(
        (k, v) for k, v in root.args.items()
        if isinstance(v, (str, int, float, bool, type(None)))
    ))
    kids = tuple(
        s for s in (
            tree_signature(ch, ignore, include_wall)
            for ch in root.children
        )
        if s is not None
    )
    return (root.kind, times, args, kids)


__all__ = [
    "COUNTER_OF",
    "SPAN_KINDS",
    "Span",
    "SpanTracer",
    "WALL_KINDS",
    "activate",
    "conservation_errors",
    "current",
    "export_chrome_trace",
    "span_counts",
    "trees_from_events",
    "tree_signature",
]
