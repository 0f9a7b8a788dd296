"""The port's observability layer (`hefl_tpu_torch.obs`) against the JAX
package's `hefl_tpu.obs`, on the CPU: the same metrics JSON, the same
percentiles, event files each package reads, the same Chrome trace JSON
and the same span-tree signatures."""

import gzip
import itertools
import json
import os

import numpy as np
import pytest

from hefl_tpu.obs import events as jevents
from hefl_tpu.obs import metrics as jmetrics
from hefl_tpu.obs import spans as jspans

from hefl_tpu_torch.fl.faults import RoundMeta, record_round_meta
from hefl_tpu_torch.obs import events, metrics, scopes, spans


def _drive(mod):
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(4)
    reg.counter("stream.arrivals").inc(7)
    reg.counter("stream.arrivals").inc()
    reg.gauge("device.peak").max(3)
    reg.gauge("device.peak").max(2)
    h = reg.histogram("stream.staleness_rounds")
    lat = reg.histogram("stream.commit_latency_s", bounds=(0.1, 0.5, 1.0, 2.5))
    for v in rng.integers(0, 3, 40):
        h.observe(int(v))
    for v in rng.exponential(0.7, 30):
        lat.observe(round(float(v), 9))
    base = reg.snapshot()
    reg.counter("stream.arrivals").inc(2)
    lat.observe(0.3)
    return reg, base


def test_registry_snapshots_are_the_jax_json():
    mine, mbase = _drive(metrics)
    theirs, tbase = _drive(jmetrics)
    assert json.dumps(mine.snapshot()) == json.dumps(theirs.snapshot())
    assert mine.snapshot_delta(mbase) == theirs.snapshot_delta(tbase)
    with pytest.raises(ValueError, match="conflicting"):
        mine.histogram("stream.commit_latency_s", bounds=(1.0,))
    with pytest.raises(TypeError, match="counter"):
        mine.gauge("stream.arrivals")
    mine.reset()
    assert mine.snapshot() == {}


@pytest.mark.parametrize("n", [1, 7, 200, 700])
def test_quantiles_equal_jax_exactly(n):
    rng = np.random.default_rng(n)
    xs = rng.lognormal(0.0, 1.2, n)
    mine, theirs = metrics.Histogram((0.5, 1.0, 2.0, 8.0)), jmetrics.Histogram((0.5, 1.0, 2.0, 8.0))
    for v in xs:
        mine.observe(v)
        theirs.observe(v)
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert mine.quantile(q) == theirs.quantile(q)
        assert metrics.Histogram.quantile_of(mine.value, q) == jmetrics.Histogram.quantile_of(
            theirs.value, q)
        assert metrics.exact_percentile(xs, 100 * q) == jmetrics.exact_percentile(xs, 100 * q)
    assert mine.value == theirs.value
    assert mine.delta({"le_1": 1, "count": 2}) == theirs.delta({"le_1": 1, "count": 2})


def test_event_log_reads_through_jax_after_rotation_and_torn_tail(tmp_path, monkeypatch):
    monkeypatch.setenv("HEFL_EVENTS", "1")
    monkeypatch.setenv("HEFL_EVENTS_MAX_BYTES", "600")
    path = str(tmp_path / "events.jsonl")
    rotated = []
    hook = events.on_rotation(rotated.append)
    try:
        log = events.configure(path)
        for i in range(12):
            events.emit("stream_round", round=i, fresh=np.int64(3), commit_s=np.float64(0.5),
                        cohort=np.arange(3))
        log.close()
    finally:
        events.remove_rotation_hook(hook)
        events.configure(None)
    assert rotated and rotated[-1] == path + ".1"
    for reader in (events.read_events, jevents.read_events):
        cur, old = reader(path), reader(path + ".1")
        assert cur[0]["event"] == "log_open" and cur[0]["rotated_from"] == path + ".1"
        assert [e["round"] for e in old + cur if e["event"] == "stream_round"][-1] == 11
        assert cur[-1]["cohort"] == [0, 1, 2] and cur[-1]["fresh"] == 3
    with open(path, "a") as f:
        f.write('{"ts": 1, "event": "torn')          # a crash mid-append
    with pytest.raises(ValueError, match="malformed"):
        jevents.read_events(path)
    log = events.EventLog(path)
    log.emit("after_crash", round=12)
    log.close()
    recs = jevents.read_events(path)
    assert [e["event"] for e in recs[-2:]] == ["torn_tail_recovered", "after_crash"]
    assert recs[-2]["truncated_bytes"] == len('{"ts": 1, "event": "torn')
    assert events.read_events(path) == recs


def test_event_switches_and_default_path(monkeypatch, tmp_path):
    monkeypatch.setenv("HEFL_EVENTS", "0")
    events.configure(str(tmp_path / "e.jsonl"))
    assert events.emit("x") is None and not os.path.exists(tmp_path / "e.jsonl")
    events.configure(None)
    assert events.enabled() is jevents.enabled() is False
    monkeypatch.setenv("HEFL_EVENTS_MAX_BYTES", "nope")
    assert events.max_bytes() == jevents.max_bytes() == events.DEFAULT_MAX_BYTES
    assert events.default_events_path("a/b/ck.npz") == jevents.default_events_path("a/b/ck.npz")
    assert events.default_events_path(None) == "events.jsonl"


def _tracer(mod, monkeypatch):
    monkeypatch.setattr(mod, "_TRACE_IDS", itertools.count())
    tr = mod.SpanTracer(3)
    with mod.activate(tr):
        assert mod.current() is tr
        a = tr.add("arrival", 0.25, client=1, outcome="folded", retried=False)
        tr.add("fold", 0.25, parent=a, client=1, src="fresh")
        tr.add("retry", 1.5, client=2, attempt=1, delivered=True)
        tr.add("arrival", 1.5, client=2, outcome="duplicate", retried=True)
        tr.add("journal_append", 0.0, 0.001, clock="wall", kind_="fold", bytes=10)
        tr.add("commit", 1.5, committed=True, degraded_reason=None, surviving=1, fresh=1,
               quorum=1)
        tr.finish(2.0)
    assert mod.current() is None
    return tr


def test_span_trees_export_and_signatures_equal_jax(tmp_path, monkeypatch):
    mine, theirs = _tracer(spans, monkeypatch), _tracer(jspans, monkeypatch)
    assert mine.counts() == theirs.counts() == {"arrival": 2, "fold": 1, "retry": 1,
                                                "journal_append": 1, "commit": 1}
    assert mine.to_trace_events() == theirs.to_trace_events()
    for name in ("t.json", "t.json.gz"):
        a, b = str(tmp_path / f"port-{name}"), str(tmp_path / f"jax-{name}")
        spans.export_chrome_trace(a, [mine])
        jspans.export_chrome_trace(b, [theirs])
        opener = gzip.open if name.endswith(".gz") else open
        with opener(a, "rb") as fa, opener(b, "rb") as fb:
            assert json.loads(fa.read()) == json.loads(fb.read())
    assert spans.tree_signature(mine.root) == jspans.tree_signature(theirs.root)
    assert spans.span_counts(mine.root) == jspans.span_counts(theirs.root)
    delta = {"stream.arrivals": 2, "stream.retries": 1, "stream.folds": 1,
             "journal.appends": 2}
    assert spans.conservation_errors(mine.counts(), delta) == jspans.conservation_errors(
        theirs.counts(), delta) != []
    assert spans.COUNTER_OF == jspans.COUNTER_OF and spans.SPAN_KINDS == jspans.SPAN_KINDS


def test_span_events_rebuild_into_the_same_trees(tmp_path, monkeypatch):
    monkeypatch.setenv("HEFL_EVENTS", "1")
    path = str(tmp_path / "events.jsonl")
    events.configure(path)
    try:
        tr = _tracer(spans, monkeypatch)
    finally:
        events.configure(None)
    evs = jevents.read_events(path)
    mine, theirs = spans.trees_from_events(evs), jspans.trees_from_events(evs)
    assert list(mine) == list(theirs) == [tr.trace_id]
    assert spans.tree_signature(mine[tr.trace_id]) == jspans.tree_signature(
        theirs[tr.trace_id]) == spans.tree_signature(tr.root)


def test_round_meta_publishes_counters_and_event(tmp_path, monkeypatch):
    monkeypatch.setenv("HEFL_EVENTS", "1")
    events.configure(str(tmp_path / "e.jsonl"))
    base = metrics.snapshot()
    try:
        record_round_meta(RoundMeta.from_bits(np.array([0, 2, 1, 0])), round_index=5)
    finally:
        events.configure(None)
    d = metrics.snapshot_delta(base)
    assert (d["exclusions.nonfinite"], d["exclusions.scheduled"]) == (1, 1)
    assert (d["rounds.masked"], d["clients.excluded"]) == (1, 2)
    ev = jevents.read_events(str(tmp_path / "e.jsonl"))[-1]
    assert ev["event"] == "round_robust" and ev["round"] == 5 and ev["surviving"] == 2
    assert metrics.record_device_memory("cpu") is None
    assert scopes.QUORUM_WAIT == "hefl.quorum_wait"
