"""The port's streaming engine (`hefl_tpu_torch.fl.stream`) against the JAX
package's, on the CPU.

The engine's public outcome — `StreamRoundMeta.record()`, the exclusion
bits and the journal's record stream — is a function of the fault schedule,
the cohort sampler, the retry jitter and the sanitizer's verdicts, not of
the training's random streams; so the two packages must agree on it
exactly over the same schedule (the content hashes, the round key and the
bodies aside: the port's uploads come from torch generators). The JAX
engine's round-setup certifiers need `jax.experimental.enable_x64`, gone
in JAX 0.9 (ROADMAP caveat R1): the tests run them for real through the
`jax_x64` stand-in (tests/torch_jax_x64.py). The fold itself
is held bitwise: the streamed sum is `lazy_sum_mod` over the folded rows,
in any arrival order, and a cohort-only round's released sum equals the
full-C round's.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hefl_tpu.analysis.ranges as jranges
from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import quantize as jq
from hefl_tpu.fl import config as jconfig
from hefl_tpu.fl import faults as jfaults
from hefl_tpu.fl import journal as jjournal
from hefl_tpu.fl import server as jserver
from hefl_tpu.fl import stream as jstream
from hefl_tpu.models import SmallCNN as JSmallCNN
from hefl_tpu.parallel import make_mesh

from hefl_tpu_torch import experiment, presets
from hefl_tpu_torch.analysis import ranges
from hefl_tpu_torch.ckks import keys, packing
from hefl_tpu_torch.ckks.ntt import plain_tables
from hefl_tpu_torch.data import partition, synthetic
from hefl_tpu_torch.fl import journal, secure, server, stream
from hefl_tpu_torch.fl.config import PackingConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.faults import EXCLUDED_UNSAMPLED, FaultConfig
from hefl_tpu_torch.models import create_model

from test_torch_packing import jax_spec
from torch_jax_x64 import jax_x64  # noqa: F401  (the JAX certifiers' stand-in)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TRAIN = dict(epochs=1, batch_size=4, num_classes=10, augment=False, val_fraction=0.25)
C = 6

# Two schedules: (a) a sampled cohort, quorum < 1, a deadline, retries with
# jitter, tau = 1, stragglers, a duplicate, a transient and a permanent
# loss and a NaN client; (b) the full cohort with one duplicate and
# stragglers past a deadline, carried under tau = 1.
CONFIGS = {
    "cohort_faults": (
        dict(cohort_size=5, quorum=0.4, deadline_s=1.0, max_retries=2, retry_jitter=0.5,
             staleness_rounds=1, seed=2),
        dict(seed=13, straggler_fraction=0.25, straggler_delay_s=3.0, arrival_delay_s=0.5,
             duplicate_clients=1, transient_fail_clients=1, permanent_fail_clients=1,
             nan_clients=1),
    ),
    "full_cohort": (
        dict(quorum=0.75, deadline_s=1.0, staleness_rounds=1),
        dict(seed=3, straggler_fraction=0.25, straggler_delay_s=3.0, duplicate_clients=1),
    ),
}


def _data(n=8 * C, seed=0):
    (x, y), _, _ = synthetic.make_dataset("mnist", seed=seed, n_train=n, n_test=8)
    return partition.stack_federated(x, y, partition.iid_contiguous(n, C))


def _port_setup():
    xs, ys = (torch.from_numpy(a) for a in _data())
    model = create_model("smallcnn", device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=256)
    _, pk = keys.keygen(ctx, torch.Generator().manual_seed(21), device="cpu")
    return model, params, xs, ys, ctx, pk


def _jax_setup():
    xs, ys = _data()
    model = JSmallCNN(num_classes=10)
    params = model.init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"]
    ctx = jkeys.CkksContext.create(n=256)
    _, pk = jkeys.keygen(ctx, jax.random.key(21))
    return model, params, jnp.asarray(xs), jnp.asarray(ys), ctx, pk


_CONTENT = ("key", "sha", "sum_sha", "body")


def _records(path, reader):
    return [{k: v for k, v in rec.items() if k not in _CONTENT} for rec in reader(path)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_matches_jax_engine_records_bits_and_journal(name, tmp_path, jax_x64):
    _engine_matches_jax(name, tmp_path)


def test_engine_matches_jax_engine_under_its_own_certifiers(tmp_path, jax_x64):
    # The packed schedule, the JAX engine's round set-up certifying for
    # real (fold loop with its packed leg), then the same certificates.
    _engine_matches_jax("cohort_faults", tmp_path)
    ctx = keys.CkksContext.create(n=256)
    p = max(int(v) for v in ctx.ntt.p.reshape(-1))
    spec = packing.PackedSpec.for_params(_port_setup()[1], ctx, PackingConfig(bits=8, clip=0.05),
                                         C)
    got = ranges.certify_fold_inductive(p, spec, int(ctx.modulus))
    assert got.ok and got.summary() == jranges.certify_fold_inductive(
        p, spec, int(ctx.modulus)).summary()


def _engine_matches_jax(name, tmp_path):
    s_kw, f_kw = CONFIGS[name]
    model, params, xs, ys, ctx, pk = _port_setup()
    tpath, jpath = str(tmp_path / "port.wal"), str(tmp_path / "jax.wal")
    srv = server.AggregationServer(StreamConfig(**s_kw), FaultConfig(**f_kw),
                                   journal_path=tpath, fsync_policy="never")
    cfg = TrainConfig(**TRAIN)
    # The sampled-cohort schedule runs packed (b = 8, the headroom cap in
    # play), the full cohort on the float upload.
    packed = name == "cohort_faults"
    spec = (packing.PackedSpec.for_params(params, ctx, PackingConfig(bits=8, clip=0.05), C)
            if packed else None)
    got = []
    for r in range(2):
        ct, _, _, sm = srv.run_round(model, cfg, ctx, pk, params, xs, ys,
                                     torch.Generator().manual_seed(100 + r), r, packing=spec)
        got.append(sm)
        assert ct.c0.shape == ((spec.n_ct if packed else 55 * 16), 3, 256)
    srv.close()

    jmodel, jparams, jxs, jys, jctx, jpk = _jax_setup()
    jsrv = jserver.AggregationServer(jconfig.StreamConfig(**s_kw), jfaults.FaultConfig(**f_kw),
                                     journal_path=jpath, fsync_policy="never")
    jcfg = jconfig.TrainConfig(**TRAIN)
    jspec = jax_spec(jparams, jctx, jq.PackingConfig(bits=8, clip=0.05), C) if packed else None
    if packed:
        assert (jspec.n_ct, jspec.k, jspec.clients) == (spec.n_ct, spec.k, spec.clients)
    want = []
    for r in range(2):
        _, _, _, sm = jsrv.run_round(jmodel, jcfg, make_mesh(C), jctx, jpk, jparams, jxs, jys,
                                     jax.random.key(100 + r), r, packing=jspec)
        want.append(sm)
    jsrv.close()

    for g, w in zip(got, want):
        assert g.record() == w.record()
        assert g.meta.bits == w.meta.bits and g.meta.record() == w.meta.record()
    assert any(sm.fresh for sm in got) and any(sm.carried for sm in got)
    if name == "cohort_faults":
        assert all(sm.meta.excluded["unsampled"] == 1 for sm in got)
        assert any(sm.retries for sm in got) and any(sm.unreachable for sm in got)
        assert any(sm.meta.excluded["nonfinite"] for sm in got)
    mine, theirs = _records(tpath, journal.read_journal), _records(jpath, jjournal.read_journal)
    assert [r["kind"] for r in mine] == [r["kind"] for r in theirs]
    assert mine == theirs
    # The key holds the round seed as [hi, lo]; the persisted bodies' shas.
    opens = [rec for rec in journal.read_journal(tpath) if rec["kind"] == "round_open"]
    assert [rec["key"] for rec in opens] == [[0, 100], [0, 101]]


def _round(engine, setup, r, **kw):
    model, params, xs, ys, ctx, pk = setup
    return engine.run_round(model, TrainConfig(**TRAIN), ctx, pk, params, xs, ys,
                            torch.Generator().manual_seed(100 + r), r, **kw)


def test_streamed_sum_is_the_masked_lazy_sum_of_the_same_uploads(monkeypatch):
    # The released sum is bitwise lazy_sum_mod over the same uploads with
    # the rows that did not fold zeroed (the batched masked round's sum).
    setup = _port_setup()
    captured = {}
    real = stream.client_uploads

    def spy(*a, **k):
        out = real(*a, **k)
        captured["cts"] = out[0]
        return out

    monkeypatch.setattr(stream, "client_uploads", spy)
    eng = stream.StreamEngine(StreamConfig(quorum=0.5, deadline_s=1.0),
                              FaultConfig(seed=3, straggler_fraction=0.25, straggler_delay_s=3.0,
                                          duplicate_clients=1, nan_clients=1))
    ct, _, _, sm = _round(eng, setup, 0)
    cts = captured["cts"]
    keep = torch.tensor(sm.meta.participation, dtype=torch.bool)
    assert 0 < int(keep.sum()) < C and sm.stale_folded == 0
    want = secure.aggregate_encrypted(setup[4], secure.zero_excluded(cts, keep))
    assert torch.equal(ct.c0, want.c0) and torch.equal(ct.c1, want.c1)


@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled"])
def test_accumulator_is_bitwise_jax_in_any_arrival_order(order):
    ctx = keys.CkksContext.create(n=256)
    p = ctx.ntt.p
    rng = np.random.default_rng(5)
    rows = (rng.integers(0, 2**32, (6, 2, 3, 256), dtype=np.uint64)
            % np.asarray(p, np.uint64).reshape(1, 1, 3, 1)).astype(np.uint32)
    idx = {"forward": np.arange(6), "reverse": np.arange(6)[::-1],
           "shuffled": rng.permutation(6)}[order]
    mine, theirs = stream.OnlineAccumulator(p), jstream.OnlineAccumulator(np.asarray(p))
    for i in idx:
        mine.fold((int(i), 0), torch.from_numpy(rows[i].astype(np.int32)),
                  torch.from_numpy(rows[i].astype(np.int32)[::-1].copy()))
        theirs.fold((int(i), 0), rows[i], rows[i][::-1])
    assert not mine.fold((0, 0), rows[0], rows[0]) and mine.duplicates == 1
    batch = stream.OnlineAccumulator(p)
    assert batch.fold_batch([(int(i), 0) for i in idx] + [(0, 0)], rows[idx],
                            rows[idx][:, ::-1].copy()) == 6
    want = jstream.ct_hash(*theirs.value())
    assert stream.ct_hash(*mine.value()) == want == stream.ct_hash(*batch.value())
    lazy = secure.lazy_sum_mod(torch.from_numpy(rows.astype(np.int32)), plain_tables(
        ctx.ntt, "cpu").p)
    assert torch.equal(mine.value()[0], lazy)


def test_dedup_window_matches_jax_over_a_nonce_storm():
    rng = np.random.default_rng(9)
    mine, theirs = stream.DedupWindow(), jstream.DedupWindow()
    for r in range(12):
        mine, theirs = mine.advanced(r, 2), theirs.advanced(r, 2)
        for _ in range(40):
            nonce = (int(rng.integers(0, 30)), int(r - rng.integers(0, 5)))
            assert (nonce in mine) == (nonce in theirs)
            mine.add(nonce)
            theirs.add(nonce)
        assert set(mine) == set(theirs) and len(mine) == len(theirs)
        assert mine.peak_entries == theirs.peak_entries
    assert mine == set(theirs) and mine == stream.DedupWindow(theirs)


def test_retry_times_and_cohorts_match_jax():
    sc = dict(cohort_size=5, deadline_s=1.5, max_retries=4, retry_backoff_s=0.3,
              retry_jitter=0.7, seed=11)
    mine = stream.StreamEngine(StreamConfig(**sc))
    theirs = jstream.StreamEngine(jconfig.StreamConfig(**sc))
    for r in range(3):
        np.testing.assert_array_equal(stream.sample_cohort(mine.stream, r, 12),
                                      jstream.sample_cohort(theirs.stream, r, 12))
        for c in range(12):
            for t0 in (0.0, 0.7, 2.25):
                assert mine._retry_times(r, c, t0) == theirs._retry_times(r, c, t0)
    assert stream.quorum_count(mine.stream, 5) == jstream.quorum_count(theirs.stream, 5)


def test_cohort_only_round_equals_the_full_c_round_bitwise():
    setup = _port_setup()
    s_kw, f_kw = CONFIGS["cohort_faults"]
    spec = packing.PackedSpec.for_params(setup[1], setup[4], PackingConfig(bits=8, clip=0.05), C)
    sums = {}
    for only in (True, False):
        eng = stream.StreamEngine(StreamConfig(**s_kw, cohort_only=only), FaultConfig(**f_kw))
        ct, mets, overflow, sm = _round(eng, setup, 0, packing=spec)
        sums[only] = (stream.ct_hash(ct.c0, ct.c1), sm.record(), sm.meta.bits)
        unsampled = [c for c in range(C) if c not in sm.cohort]
        assert [sm.meta.bits[c] & EXCLUDED_UNSAMPLED for c in unsampled] == [EXCLUDED_UNSAMPLED]
        if only:
            assert float(mets[unsampled[0]].abs().sum()) == 0.0
    assert sums[True] == sums[False]


def test_cohort_bucket_and_gather_index_match_jax():
    from hefl_tpu.fl import fedavg as jfedavg

    from hefl_tpu_torch.fl import fedavg

    for num in (1, 2, 3, 8, 13):
        for size in range(1, num + 1):
            assert fedavg.cohort_bucket(size, num) == jfedavg.cohort_bucket(size, num, 1)
    np.testing.assert_array_equal(fedavg.cohort_gather_index([2, 5, 6], 4),
                                  jfedavg.cohort_gather_index([2, 5, 6], 4))
    with pytest.raises(ValueError, match="phantom"):
        fedavg.cohort_bucket(9, 8)


def test_chaos_smoke_streaming_twin_rounds_match_chaos_smoke_json():
    gate = json.loads((REPO / "CHAOS_SMOKE.json").read_text())["stream_check"]
    cfg = presets.PRESETS["chaos-smoke"]
    faults = dataclasses.replace(cfg.faults, straggler_fraction=0.25, straggler_delay_s=6.0,
                                 arrival_delay_s=0.5, duplicate_clients=1,
                                 transient_fail_clients=1)
    cfg = dataclasses.replace(
        cfg, rounds=2, faults=faults, n_train=256,
        stream=StreamConfig(quorum=0.375, deadline_s=2.0, max_retries=1, staleness_rounds=1,
                            seed=0))
    out = experiment.run_experiment(cfg, verbose=False, device="cpu")
    for rec, ref in zip(out["history"], gate["rounds"][:2]):
        assert {k: rec["round"] if k == "round" else rec["stream"][k] for k in ref} == ref
    m = out["obs"]["metrics"]
    assert m["stream.arrivals"] == sum(r["stream"]["arrivals"] for r in out["history"])
    assert m["stream.duplicates"] == 2 and m["stream.retries"] == 2


def test_engine_refuses_the_hierarchy_error_feedback_and_padding_by_name():
    # The hierarchy and error feedback run now; what stays refused: a link
    # schedule of another fold-tree topology, error feedback under dp, and
    # the multi-device padding.
    setup = _port_setup()
    eng = stream.StreamEngine(StreamConfig(num_hosts=2),
                              FaultConfig(num_hosts=3, link_loss_hosts=1))
    spec = packing.PackedSpec.for_params(setup[1], setup[4], PackingConfig(bits=8, clip=0.05), C)
    with pytest.raises(ValueError, match="FaultConfig.num_hosts=3 does not match"):
        _round(eng, setup, 0, packing=spec)
    from hefl_tpu_torch.fl.dp import DpConfig

    ef = dataclasses.replace(spec, error_feedback=True)
    with pytest.raises(ValueError, match="dp cannot be combined with error-feedback"):
        _round(stream.StreamEngine(StreamConfig()), setup, 0, packing=ef, dp=DpConfig())
    eng = stream.StreamEngine(StreamConfig())
    with pytest.raises(ValueError, match="num_real_clients"):
        _round(eng, setup, 0, num_real_clients=4)
