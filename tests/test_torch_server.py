"""The port's durable aggregation server (`hefl_tpu_torch.fl.server`) on the
CPU: a crash at every boundary of rounds 0 and 1 recovers to the
uninterrupted twin's commit chain bitwise, the hybrid-HE replay
re-transciphers the persisted symmetric bodies (bitwise the JAX package's
`retranscipher_decode` on the same pads), compaction and the sealed-round
rerun keep the chain, and a streaming run with faults, DP and a journal
gives the JAX driver's stream, robust and dp_epsilon records and stream.*
counters."""

import dataclasses

import numpy as np
import pytest
import torch

import hefl_tpu.analysis as janalysis
import hefl_tpu.analysis.ranges as jranges
from hefl_tpu import experiment as jexp
from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.fl import config as jconfig
from hefl_tpu.fl import dp as jdp
from hefl_tpu.fl import faults as jfaults
from hefl_tpu.hhe import transcipher as jtc

from hefl_tpu_torch import experiment
from hefl_tpu_torch.ckks import keys, packing, quantize
from hefl_tpu_torch.data import partition, synthetic
from hefl_tpu_torch.fl import journal as jr
from hefl_tpu_torch.fl import server, stream
from hefl_tpu_torch.fl.config import HheConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.dp import DpConfig
from hefl_tpu_torch.fl.faults import CRASH_POINTS, CrashConfig, FaultConfig, SimulatedCrash
from hefl_tpu_torch.hhe import transcipher
from hefl_tpu_torch.models import create_model
from hefl_tpu_torch.obs import metrics as obs_metrics

torch.set_num_threads(2)

CFG = TrainConfig(epochs=1, batch_size=4, num_classes=10, augment=False, val_fraction=0.25)
SC = StreamConfig(quorum=0.75, deadline_s=1.0, staleness_rounds=1)
FC = FaultConfig(seed=3, straggler_fraction=0.25, straggler_delay_s=1.5, arrival_delay_s=1.0,
                 duplicate_clients=1)


@pytest.fixture(scope="module")
def setup():
    (x, y), _, _ = synthetic.make_dataset("mnist", seed=0, n_train=32, n_test=8)
    xs, ys = (torch.from_numpy(a) for a in partition.stack_federated(
        x, y, partition.iid_contiguous(32, 4)))
    model = create_model("smallcnn", device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=256)
    sk, pk = keys.keygen(ctx, torch.Generator().manual_seed(21), device="cpu")
    return model, params, xs, ys, ctx, pk


def _spec(setup):
    """A packed geometry (b = 8): 4x fewer ciphertexts than the float
    upload, so the CPU's plain encrypt keeps the matrix inside its time."""
    return packing.PackedSpec.for_params(setup[1], setup[4],
                                         quantize.PackingConfig(bits=8, clip=0.05), 4)


def _run(target, setup, rounds, **kw):
    model, params, xs, ys, ctx, pk = setup
    kw.setdefault("packing", _spec(setup))
    out = {}
    for r in rounds:
        ct, _, _, sm = target.run_round(model, CFG, ctx, pk, params, xs, ys,
                                        torch.Generator().manual_seed(100 + r), r, **kw)
        out[r] = (stream.ct_hash(ct.c0, ct.c1), sm.record())
    return out


@pytest.fixture(scope="module")
def twin(setup):
    eng = stream.StreamEngine(SC, FC)
    out = _run(eng, setup, (0, 1))
    assert out[0][1]["carried"] and out[1][1]["stale_folded"]   # a carry crosses the rounds
    return out


@pytest.mark.parametrize("crash_round", [0, 1])
@pytest.mark.parametrize("at", CRASH_POINTS)
def test_kill_at_every_boundary_recovers_the_twin_chain_bitwise(tmp_path, setup, twin, at,
                                                                crash_round):
    jp = str(tmp_path / "j.wal")
    folds = 2 if at in ("post_fold", "mid_append") else 1
    srv = server.AggregationServer(SC, FC, journal_path=jp, fsync_policy="never",
                                   crash=CrashConfig(round=crash_round, at=at, after_folds=folds))
    _run(srv, setup, range(crash_round))
    with pytest.raises(SimulatedCrash):
        _run(srv, setup, (crash_round,))
    before = jr.read_journal(jp, repair=True)
    journaled = [r for r in before if r["kind"] == "fold" and r["round"] == crash_round]
    base = obs_metrics.snapshot()
    srv2 = server.AggregationServer(SC, FC, journal_path=jp, fsync_policy="never")
    rep = srv2.recovered
    assert rep.open_round == (None if at == "post_close" else crash_round)
    assert rep.sealed_rounds == tuple(range(crash_round + (at == "post_close")))
    got = _run(srv2, setup, range(crash_round, 2))
    srv2.close()
    d = obs_metrics.snapshot_delta(base)
    for r in range(crash_round, 2):
        assert got[r] == twin[r], r
    sealed = twin[crash_round][1]
    assert d.get("recovery.refolded_uploads", 0) == (
        len(journaled) if at != "post_close" else sealed["fresh"] + sealed["stale_folded"])
    assert d.get("recovery.rounds_replayed", 0) == 1
    recs = jr.read_journal(jp)
    commits = {r["round"]: r["sum_sha"] for r in recs if r["kind"] == "commit"}
    assert commits == {r: twin[r][0] for r in (0, 1)}
    nonces = [tuple(r["nonce"]) for r in recs if r["kind"] == "fold" and r["src"] == "fresh"]
    assert len(nonces) == len(set(nonces))


def test_compaction_and_sealed_round_rerun_keep_the_chain(tmp_path, setup, twin):
    jp = str(tmp_path / "j.wal")
    srv = server.AggregationServer(SC, FC, journal_path=jp, fsync_policy="commit")
    assert _run(srv, setup, (0,))[0] == twin[0]
    assert srv.committed_sum_sha(0) is None               # a live round keeps no script
    kept, dropped = srv.compact_to(1)
    assert kept == 1 + twin[0][1]["carried"] and dropped > 0
    srv.close()
    srv2 = server.AggregationServer(SC, FC, journal_path=jp)
    assert srv2.recovered.sealed_rounds == (0,)
    assert srv2.recovered.carried_uploads == twin[0][1]["carried"]
    assert _run(srv2, setup, (1,))[1] == twin[1]
    assert srv2.report().keys() == {"journal_path", "fsync_policy", "recovered"}
    srv2.close()
    srv3 = server.AggregationServer(SC, FC, journal_path=jp)   # re-run the sealed round 1
    assert srv3.committed_sum_sha(1) == twin[1][0]
    assert _run(srv3, setup, (1,))[1] == twin[1]
    srv3.close()
    with pytest.raises(jr.JournalError, match="different stream config"):
        server.AggregationServer(dataclasses.replace(SC, quorum=0.5), FC, journal_path=jp)


def test_hhe_replay_retranscipher_is_bitwise_jax_and_recovers(tmp_path, setup):
    model, params, xs, ys, ctx, pk = setup
    spec = _spec(setup)
    # retranscipher_decode's plain version is bitwise the JAX package's on
    # the same words and pads.
    rng = np.random.default_rng(1)
    w_hi, w_lo = (rng.integers(0, 2**31, (spec.n_ct, 256)).astype(np.uint32) for _ in "hl")
    p = np.asarray(ctx.ntt.p).reshape(1, 3, 1)
    pads = [(rng.integers(0, 2**27, (spec.n_ct, 3, 256)) % p).astype(np.uint32) for _ in "01"]
    jctx = jkeys.CkksContext.create(n=256)
    want = jtc.retranscipher_decode(jctx, w_hi, w_lo, *pads)
    got = transcipher.retranscipher_decode(ctx, w_hi, w_lo,
                                           *(torch.from_numpy(a.astype(np.int32)) for a in pads))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), np.asarray(w))
    # A journaled HHE round crashed after 2 folds recovers bitwise, the
    # persisted symmetric bodies re-transciphered.
    hsc = StreamConfig(quorum=0.75, deadline_s=1.0, upload_kind="hhe")
    kw = dict(packing=spec, hhe=HheConfig(key_seed=2))
    twin = _run(stream.StreamEngine(hsc, FC), setup, (0,), **kw)
    jp = str(tmp_path / "h.wal")
    srv = server.AggregationServer(hsc, FC, journal_path=jp, fsync_policy="never",
                                   crash=CrashConfig(round=0, at="post_fold", after_folds=2))
    with pytest.raises(SimulatedCrash):
        _run(srv, setup, (0,), **kw)
    bodies = [r for r in jr.read_journal(jp) if r["kind"] == "fold"]
    assert len(bodies) == 2 and len(bodies[0]["body"]) == 2 * spec.n_ct * 256 * 4
    calls = []
    real = transcipher.retranscipher_decode

    def counted(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    transcipher.retranscipher_decode = counted
    try:
        srv2 = server.AggregationServer(hsc, FC, journal_path=jp, fsync_policy="never")
        got = _run(srv2, setup, (0,), **kw)
        srv2.close()
    finally:
        transcipher.retranscipher_decode = real
    assert got == twin and calls == [(spec.n_ct, 256)] * 2


TINY = dict(model="smallcnn", dataset="mnist", num_clients=4, rounds=2, n_train=64, n_test=16,
            seed=3, events_path="")
TINY_TRAIN = dict(epochs=1, batch_size=8, num_classes=10, augment=False, val_fraction=0.25)


class _Ok:
    ok = True

    def summary(self):
        return "stubbed"


def test_driver_stream_faults_dp_journal_records_equal_the_jax_drivers(tmp_path, monkeypatch):
    monkeypatch.setattr(janalysis, "check_experiment", lambda *a, **k: None)
    for name in ("certify_fold_inductive", "certify_transciphering", "certify_packing"):
        monkeypatch.setattr(jranges, name, lambda *a, **k: _Ok())
    s_kw = dict(cohort_size=3, quorum=0.5, deadline_s=1.0, max_retries=1, seed=1)
    f_kw = dict(seed=2, straggler_fraction=0.25, straggler_delay_s=3.0, duplicate_clients=1,
                transient_fail_clients=1, nan_clients=1)
    d_kw = dict(clip_norm=1.0, noise_multiplier=1.1)
    mine = experiment.run_experiment(experiment.ExperimentConfig(
        **TINY, he=experiment.HEConfig(n=256), train=TrainConfig(**TINY_TRAIN),
        packing=quantize.PackingConfig(bits=8, clip=0.5),
        stream=StreamConfig(**s_kw), faults=FaultConfig(**f_kw), dp=DpConfig(**d_kw),
        journal_path=str(tmp_path / "port.wal"), fsync_policy="never"),
        verbose=False, device="cpu")
    theirs = jexp.run_experiment(jexp.ExperimentConfig(
        **TINY, he=jexp.HEConfig(n=256), train=jconfig.TrainConfig(**TINY_TRAIN),
        packing=jexp.PackingConfig(bits=8, clip=0.5),
        stream=jconfig.StreamConfig(**s_kw), faults=jfaults.FaultConfig(**f_kw),
        dp=jdp.DpConfig(**d_kw), journal_path=str(tmp_path / "jax.wal"), fsync_policy="never"),
        verbose=False)
    for g, w in zip(mine["history"], theirs["history"]):
        assert g["stream"] == w["stream"] and g["robust"] == w["robust"]
        assert g["dp_epsilon"] == w["dp_epsilon"]
    assert any(rec["robust"]["excluded"]["nonfinite"] for rec in mine["history"])
    counters = {k: v for k, v in theirs["obs"]["metrics"].items()
                if k.startswith(("stream.", "exclusions.", "journal.appends", "rounds."))}
    assert {k: mine["obs"]["metrics"].get(k) for k in counters} == counters
    assert mine["journal"].keys() == theirs["journal"].keys()
    assert mine["journal"]["recovered"] == {**theirs["journal"]["recovered"],
                                            "journal_path": str(tmp_path / "port.wal")}
    assert {e["kind"] for e in jr.read_journal(str(tmp_path / "jax.wal"))} == {
        e["kind"] for e in jr.read_journal(str(tmp_path / "port.wal"))}


def test_driver_serve_crash_then_recover_resumes_bitwise(tmp_path):
    cfg = experiment.ExperimentConfig(
        **{**TINY, "n_train": 32}, he=experiment.HEConfig(n=256), train=TrainConfig(**TINY_TRAIN),
        packing=quantize.PackingConfig(bits=8, clip=0.5), stream=SC, faults=FC, span_trace_path=str(tmp_path / "spans.json.gz"))
    twin = experiment.run_experiment(dataclasses.replace(
        cfg, checkpoint_path=str(tmp_path / "twin" / "ck.npz"), serve=True),
        verbose=False, device="cpu")
    crashed = dataclasses.replace(cfg, checkpoint_path=str(tmp_path / "c" / "ck.npz"),
                                  serve=True, crash=CrashConfig(round=1, at="mid_append",
                                                                after_folds=2))
    with pytest.raises(SimulatedCrash):
        experiment.run_experiment(crashed, verbose=False, device="cpu")
    out = experiment.run_experiment(dataclasses.replace(crashed, crash=None), verbose=False,
                                    device="cpu")
    rec = out["journal"]["recovered"]
    assert (rec["torn_bytes_truncated"], rec["open_round"], rec["sealed_rounds"]) == (24, 1, [0])
    assert [r["round"] for r in out["history"]] == [1]
    assert out["history"][0]["stream"] == twin["history"][1]["stream"]
    for k in twin["params"]:
        assert torch.equal(out["params"][k], twin["params"][k]), k
    assert out["obs"]["metrics"]["recovery.refolded_uploads"] == 1
    assert out["span_trace"] == str(tmp_path / "spans.json.gz")
    with pytest.raises(ValueError, match="crash injection without a write-ahead journal"):
        experiment.run_experiment(dataclasses.replace(cfg, crash=CrashConfig()), verbose=False,
                                  device="cpu")


def test_round_span_counts_conserve_the_counters(tmp_path, setup):
    # Every span kind with a counter twin (obs.spans.COUNTER_OF) is counted
    # exactly as often as its counter moved over the journaled round, and
    # the replayed round of a recovery adds its recovery_replay marker.
    from hefl_tpu_torch.obs import spans

    srv = server.AggregationServer(SC, FC, journal_path=str(tmp_path / "j.wal"),
                                   fsync_policy="commit",
                                   crash=CrashConfig(round=0, at="pre_commit"))
    with pytest.raises(SimulatedCrash):
        _run(srv, setup, (0,))
    srv2 = server.AggregationServer(SC, FC, journal_path=str(tmp_path / "j.wal"),
                                    fsync_policy="commit")
    base = obs_metrics.snapshot()
    _run(srv2, setup, (0,))
    counts = srv2.engine.last_spans.counts()
    assert spans.conservation_errors(counts, obs_metrics.snapshot_delta(base)) == []
    assert counts["recovery_replay"] == 1 and counts["fold"] >= 1 and counts["fsync"] >= 1
    srv2.close()
