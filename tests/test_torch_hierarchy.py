"""The port's hierarchical fold tree (`hefl_tpu_torch.fl.hierarchy`, the
engine's tier branches and `parallel`) against the JAX package's, on the
CPU.

The fold is exact mod-p addition, so the tree's aggregate is bitwise the
flat fold and bitwise the JAX aggregator's on the same numpy uploads; the
ship timeline (delays, losses, retries, duplicates, dark links, deadlines)
is a function of the link schedule and the retry PRNG, so its report, the
tier and root WALs (`fl.journal` framing) and the engine's `hosts` record
are the JAX package's exactly. The JAX aggregator's and engine's
certifiers need `jax.experimental.enable_x64`, gone in JAX 0.9 (ROADMAP
caveat R1): the tests stub them with monkeypatch.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hefl_tpu.analysis.ranges as jranges
from hefl_tpu import cli as jcli
from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import quantize as jq
from hefl_tpu.fl import config as jconfig
from hefl_tpu.fl import faults as jfaults
from hefl_tpu.fl import hierarchy as jhier
from hefl_tpu.fl import journal as jjournal
from hefl_tpu.fl import server as jserver
from hefl_tpu.fl import stream as jstream
from hefl_tpu.models import SmallCNN as JSmallCNN
from hefl_tpu.parallel import collectives as jcoll
from hefl_tpu.parallel import make_mesh
from hefl_tpu.parallel import mesh as jmesh

from hefl_tpu_torch import cli, parallel
from hefl_tpu_torch.analysis import ranges
from hefl_tpu_torch.ckks import keys, packing
from hefl_tpu_torch.data import partition, synthetic
from hefl_tpu_torch.fl import hierarchy, journal, server, stream
from hefl_tpu_torch.fl.config import PackingConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.faults import FaultConfig, LinkFaults, SimulatedCrash, schedule_links
from hefl_tpu_torch.models import create_model

from test_torch_packing import jax_spec

torch.set_num_threads(2)

C = 8
TRAIN = dict(epochs=1, batch_size=4, num_classes=10, augment=False, val_fraction=0.25)
P256 = np.asarray(keys.CkksContext.create(n=256).ntt.p)


class _Ok:
    ok = True

    def summary(self):
        return "stubbed"


def _stub_jax_certifiers(monkeypatch):
    for name in ("certify_fold_inductive", "certify_transciphering", "certify_packing",
                 "certify_fold_tree"):
        monkeypatch.setattr(jranges, name, lambda *a, **k: _Ok())


def _uploads(n=C, seed=0, shape=(2, 3, 256)):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**32, (n, 2) + shape, dtype=np.uint64)
    return (rows % P256.astype(np.uint64).reshape(1, 1, 1, 3, 1)).astype(np.uint32)


# ---- parallel helpers ---------------------------------------------------------


@pytest.mark.parametrize("clients,hosts", [(8, 2), (8, 3), (8, 4), (9, 4), (16, 5), (4, 4)])
def test_topology_helpers_equal_jax(clients, hosts):
    np.testing.assert_array_equal(parallel.host_of_clients(clients, hosts),
                                  jmesh.host_of_clients(clients, hosts))
    assert parallel.dcn_link_names(hosts) == jmesh.dcn_link_names(hosts)
    per = tuple(int(n) for n in np.bincount(parallel.host_of_clients(clients, hosts),
                                            minlength=hosts))
    for kw in ({}, {"participants_per_host": per}):
        assert (parallel.dcn_traffic_model(clients, hosts, 4096, **kw)
                == jcoll.dcn_traffic_model(clients, hosts, 4096, **kw))
    with pytest.raises(ValueError):
        parallel.host_of_clients(hosts - 1, hosts)


def test_fold_tree_certificate():
    cert = ranges.certify_fold_tree(int(P256.max()))
    assert cert.ok and cert.bits is None and cert.count_ceiling_bits == 48
    assert cert.summary().startswith(f"fold-inductive p<2**{cert.prime_bits} arrivals<=2**48: "
                                     "CERTIFIED")
    assert any("fold-tree = flat fold bitwise" in c for c in cert.checks)
    bad = ranges.certify_fold_tree(1)
    assert not bad.ok and "UNSAFE" in bad.summary()
    with pytest.raises(ValueError, match="fold tree rejected"):
        hierarchy.HierarchicalAggregator(np.asarray([[1]]), 2, 4)


# ---- the fold tree ------------------------------------------------------------


@pytest.mark.parametrize("hosts", [2, 3, 4])
def test_fold_tree_is_the_flat_fold_and_the_jax_tree_in_any_order(hosts, monkeypatch):
    _stub_jax_certifiers(monkeypatch)
    rows = _uploads()
    clients = np.arange(C)
    rec = hierarchy.dcn_compare_record(P256, rows[:, 0], rows[:, 1], clients, C, hosts, seed=3)
    jrec = jhier.dcn_compare_record(P256, rows[:, 0], rows[:, 1], clients, C, hosts, seed=3)
    assert rec == jrec and rec["bitwise_equal"] and rec["ratio_ok"]
    # The tree's value equals the JAX tree's and the flat fold's, folding
    # torch int32 residues in a shuffled order with a duplicate storm.
    order = np.random.default_rng(hosts).permutation(C)
    mine = hierarchy.HierarchicalAggregator(P256, hosts, C)
    theirs = jhier.HierarchicalAggregator(P256, hosts, C)
    flat = stream.OnlineAccumulator(P256)
    for i in list(order) + list(order[::2]):
        t0, t1 = (torch.from_numpy(rows[i, j].astype(np.int32)) for j in (0, 1))
        mine.fold((int(i), 0), t0, t1)
        theirs.fold((int(i), 0), rows[i, 0], rows[i, 1])
        flat.fold((int(i), 0), t0, t1)
    want = jstream.ct_hash(*theirs.value())
    assert stream.ct_hash(*mine.value()) == want == stream.ct_hash(*flat.value())
    assert mine.report() == theirs.report() and mine.duplicates == len(order[::2])


def _both(monkeypatch, link, ship, crash=None, jdir=None, tdir=None, folds=None, t0=0.0,
          round_index=0):
    """The same folds and ship through both aggregators."""
    _stub_jax_certifiers(monkeypatch)
    rows = _uploads()
    jlink = None if link is None else jfaults.LinkFaults(**dataclasses.asdict(link))
    mine = hierarchy.HierarchicalAggregator(
        P256, 4, C, journal_dir=tdir, fsync_policy="never", round_index=round_index, link=link,
        ship=hierarchy.ShipPolicy(**ship), crash=crash, device="cpu")
    theirs = jhier.HierarchicalAggregator(
        P256, 4, C, journal_dir=jdir, fsync_policy="never", round_index=round_index, link=jlink,
        ship=jhier.ShipPolicy(**ship),
        crash=None if crash is None else jhier.TierCrash(**dataclasses.asdict(crash)))
    out = []
    for agg in (mine, theirs):
        try:
            for i in (folds if folds is not None else range(C)):
                agg.fold((int(i), round_index), rows[i, 0], rows[i, 1])
            agg.ship_all(t0)
            out.append(None)
        except (SimulatedCrash, jfaults.SimulatedCrash) as e:
            out.append(type(e).__name__)
    return mine, theirs, out


def _link(**kw):
    base = dict(delay_s=np.zeros(4), duplicate=np.zeros(4, bool), transient=np.zeros(4, bool),
                dark=np.zeros(4, bool))
    for k, hosts in kw.items():
        if k == "delay_s":
            base[k] = np.asarray(hosts, np.float64)
        else:
            base[k][list(hosts)] = True
    return LinkFaults(**base)


SHIP = dict(deadline_s=0.6, max_retries=2, backoff_s=0.25, jitter=0.5, seed=4)


def test_ship_retry_times_equal_jax(monkeypatch):
    mine, theirs, _ = _both(monkeypatch, None, SHIP, round_index=3)
    for h in range(4):
        for t in (0.0, 0.4, 2.5):
            assert mine._ship_retry_times(h, t) == theirs._ship_retry_times(h, t)


@pytest.mark.parametrize("case", ["transient", "duplicate", "dark", "deadline", "clean"])
def test_faulty_uplinks_match_jax(case, monkeypatch):
    link = {
        "transient": _link(transient=[1], delay_s=[0.0, 0.9, 0.0, 0.0]),
        "duplicate": _link(duplicate=[2]),
        "dark": _link(dark=[3]),
        "deadline": _link(delay_s=[0.0, 0.0, 0.8, 0.1]),
        "clean": None,
    }[case]
    mine, theirs, out = _both(monkeypatch, link, SHIP, t0=1.5)
    assert out == [None, None]
    assert mine.report() == theirs.report() and mine.ship_log == theirs.ship_log
    assert stream.ct_hash(*mine._root.value()) == jstream.ct_hash(*theirs._root.value())
    rep = mine.report()
    if case == "transient":
        # The lost first delivery retries past the deadline and lands.
        assert rep["ship_lost"] == 1 and rep["ship_retries"] == 1 and rep["missed_hosts"] == []
        assert mine.ship_log[1][2] > 1.5 + SHIP["deadline_s"]
    if case == "duplicate":
        assert rep["ship_deduped"] == 1 and rep["shipping_hosts"] == 4
    if case in ("dark", "deadline"):
        missed = {"dark": [[3, "unreachable"]], "deadline": [[2, "timeout"]]}[case]
        assert rep["missed_hosts"] == missed and rep["released"] == 6
        h = missed[0][0]
        # The missed partial carries into the next round's root and folds
        # once: the two rounds together hold every upload.
        pc0, pc1, sha, nfold = mine.take_late_partial(h)
        jc0, jc1, jsha, _ = theirs.take_late_partial(h)
        assert sha == jsha and nfold == 2
        nxt = hierarchy.HierarchicalAggregator(P256, 4, C, round_index=1)
        assert nxt.fold_carried(h, 0, pc0, pc1, sha, nfold)
        assert not nxt.fold_carried(h, 0, pc0, pc1, sha, nfold)
        jnxt = jhier.HierarchicalAggregator(P256, 4, C, round_index=1)
        jnxt.fold_carried(h, 0, jc0, jc1, jsha, 2)
        jnxt.fold_carried(h, 0, jc0, jc1, jsha, 2)
        assert nxt.report() == jnxt.report() and nxt.ship_deduped == 1
        flat = stream.OnlineAccumulator(P256)
        rows = _uploads()
        for i in range(C):
            flat.fold((i, 0), rows[i, 0], rows[i, 1])
        total = stream.OnlineAccumulator(P256)
        total.fold("a", *mine._root.value())
        total.fold("b", *nxt._root.value())
        assert stream.ct_hash(*total.value()) == stream.ct_hash(*flat.value())
        with pytest.raises(journal.JournalError, match="diverged"):
            nxt.fold_carried(h, 0, pc0, pc1, "0" * 64, nfold)


def _wal_bytes(d):
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


def _recover_and_finish(lib, d, link, monkeypatch):
    """Recover an aggregator from journal dir `d`, re-deliver every upload,
    ship -> (root sha, uploads refolded from the journal, duplicates)."""
    _stub_jax_certifiers(monkeypatch)
    if lib is hierarchy:
        agg = hierarchy.HierarchicalAggregator(P256, 4, C, journal_dir=d, fsync_policy="never",
                                               link=link, ship=hierarchy.ShipPolicy(**SHIP),
                                               device="cpu")
    else:
        agg = jhier.HierarchicalAggregator(P256, 4, C, journal_dir=d, fsync_policy="never",
                                           link=jfaults.LinkFaults(**dataclasses.asdict(link)),
                                           ship=jhier.ShipPolicy(**SHIP))
    refolded = agg.refolded
    rows = _uploads()
    hosts = parallel.host_of_clients(C, 4)
    redelivered = [i for i in range(C) if not agg._shipped[hosts[i]]]
    for i in redelivered:
        agg.fold((i, 0), rows[i, 0], rows[i, 1])
    # Every upload is in exactly once: a redelivery the journal held dedups.
    assert agg.folded == C and agg.duplicates == refolded - (C - len(redelivered))
    sha = stream.ct_hash(*agg.value())
    agg.close()
    return sha, refolded


@pytest.mark.parametrize("at", hierarchy.TIER_CRASH_POINTS)
def test_tier_crash_matrix_recovers_bitwise_with_jax_identical_wals(at, tmp_path, monkeypatch):
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    link = _link(duplicate=[0], transient=[2])
    crash = hierarchy.TierCrash(host=1, at=at, after_folds=2)
    mine, theirs, out = _both(monkeypatch, link, SHIP, crash=crash, jdir=jdir, tdir=tdir)
    assert out == ["SimulatedCrash", "SimulatedCrash"]
    mine.close()
    theirs.close()
    assert _wal_bytes(tdir) == _wal_bytes(jdir)
    # Each package reads the other's crashed journals.
    shutil.copytree(tdir, str(tmp_path / "port_copy"))
    shutil.copytree(jdir, str(tmp_path / "jax_copy"))
    want = stream.ct_hash(*_both(monkeypatch, link, SHIP)[0].value())
    got = {
        "port": _recover_and_finish(hierarchy, tdir, link, monkeypatch),
        "jax": _recover_and_finish(jhier, jdir, link, monkeypatch),
        "port_reads_jax": _recover_and_finish(hierarchy, str(tmp_path / "jax_copy"), link,
                                              monkeypatch),
        "jax_reads_port": _recover_and_finish(jhier, str(tmp_path / "port_copy"), link,
                                              monkeypatch),
    }
    assert {sha for sha, _ in got.values()} == {want}
    # The uploads the crashed tier journaled are refolded, none twice.
    assert len({n for _, n in got.values()}) == 1
    assert got["port"][1] == {"mid_fold": 3, "post_fold": 4}.get(at, C)
    assert _wal_bytes(tdir) == _wal_bytes(jdir)
    roots = journal.read_journal(os.path.join(tdir, "root.wal"))
    assert sorted(r["host"] for r in roots if r["kind"] == "root_fold") == [0, 1, 2, 3]


# ---- the engine ----------------------------------------------------------------

ENGINE = {
    # A regional outage under a cohort of 4 of 8 (the flat twin's schedule).
    "outage": (dict(cohort_size=4, quorum=0.5, deadline_s=2.0, num_hosts=4),
               dict(seed=5, outage_hosts=1, num_hosts=4)),
    # A lost and a duplicated ship without retries: host quorum 0.5 commits
    # without the lost tier.
    "lossy": (dict(cohort_size=4, quorum=0.5, deadline_s=2.0, num_hosts=4, host_quorum=0.5),
              dict(seed=5, num_hosts=4, link_loss_hosts=1, link_dup_hosts=1)),
    # A dark uplink and delays past a ship deadline: the missed tiers carry
    # under the tier staleness budget and fold at the next round's root.
    "dark_carry": (dict(quorum=0.5, deadline_s=2.0, max_retries=1, num_hosts=4,
                        host_quorum=0.5, ship_deadline_s=0.3, host_staleness_rounds=1),
                   dict(seed=1, num_hosts=4, link_dark_hosts=1, link_delay_s=0.6)),
}


def _data(seed=0):
    (x, y), _, _ = synthetic.make_dataset("mnist", seed=seed, n_train=8 * C, n_test=8)
    return partition.stack_federated(x, y, partition.iid_contiguous(8 * C, C))


def _records(path, reader):
    content = ("key", "sha", "sum_sha", "body")
    return [{k: v for k, v in rec.items() if k not in content} for rec in reader(path)]


@pytest.mark.parametrize("name", list(ENGINE))
def test_hierarchical_engine_matches_jax_engine(name, tmp_path, monkeypatch):
    _stub_jax_certifiers(monkeypatch)
    s_kw, f_kw = ENGINE[name]
    xs, ys = _data()
    model = create_model("smallcnn", device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=256)
    _, pk = keys.keygen(ctx, torch.Generator().manual_seed(21), device="cpu")
    spec = packing.PackedSpec.for_params(params, ctx, PackingConfig(bits=8, clip=0.05), C)
    tpath, jpath = str(tmp_path / "port.wal"), str(tmp_path / "jax.wal")
    srv = server.AggregationServer(StreamConfig(**s_kw), FaultConfig(**f_kw), journal_path=tpath,
                                   fsync_policy="never")
    got = []
    for r in range(2):
        ct, _, _, sm = srv.run_round(model, TrainConfig(**TRAIN), ctx, pk, params,
                                     torch.from_numpy(xs), torch.from_numpy(ys),
                                     torch.Generator().manual_seed(100 + r), r, packing=spec)
        got.append(sm)
    srv.close()

    jmodel = JSmallCNN(num_classes=10)
    jparams = jmodel.init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"]
    jctx = jkeys.CkksContext.create(n=256)
    _, jpk = jkeys.keygen(jctx, jax.random.key(21))
    jspec = jax_spec(jparams, jctx, jq.PackingConfig(bits=8, clip=0.05), C)
    jsrv = jserver.AggregationServer(jconfig.StreamConfig(**s_kw), jfaults.FaultConfig(**f_kw),
                                     journal_path=jpath, fsync_policy="never")
    want = []
    for r in range(2):
        _, _, _, sm = jsrv.run_round(jmodel, jconfig.TrainConfig(**TRAIN), make_mesh(C), jctx,
                                     jpk, jparams, jnp.asarray(xs), jnp.asarray(ys),
                                     jax.random.key(100 + r), r, packing=jspec)
        want.append(sm)
    jsrv.close()

    for g, w in zip(got, want):
        assert g.record() == w.record() and g.hosts is not None
        assert g.meta.bits == w.meta.bits and g.meta.record() == w.meta.record()
    assert _records(tpath, journal.read_journal) == _records(jpath, jjournal.read_journal)
    kinds = {r["kind"] for r in journal.read_journal(tpath)}
    if name == "outage":
        assert all(sm.committed for sm in got)
    if name == "lossy":
        assert any(sm.hosts["missed"] and sm.committed for sm in got)
        assert any(sm.hosts["ship_deduped"] for sm in got)
    if name == "dark_carry":
        assert {"tier_carry", "tier_fold", "ship_retry"} <= kinds
        assert got[1].hosts["tier_stale_folded"] == 1
        assert got[0].meta.excluded["host_unreachable"] or got[0].meta.excluded["host_timeout"]


def test_engine_twin_commits_the_flat_sum_under_a_duplicate_storm():
    xs, ys = (torch.from_numpy(a) for a in _data())
    model = create_model("smallcnn", device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=256)
    _, pk = keys.keygen(ctx, torch.Generator().manual_seed(21), device="cpu")
    spec = packing.PackedSpec.for_params(params, ctx, PackingConfig(bits=8, clip=0.05), C)
    faults = FaultConfig(seed=5, duplicate_clients=2, arrival_delay_s=1.0)
    out = {}
    for hosts in (0, 4):
        eng = stream.StreamEngine(StreamConfig(cohort_size=4, quorum=0.5, deadline_s=2.0,
                                               num_hosts=hosts), faults)
        ct, _, _, sm = eng.run_round(model, TrainConfig(**TRAIN), ctx, pk, params, xs, ys,
                                     torch.Generator().manual_seed(22), 0, packing=spec)
        rec = sm.record()
        rec.pop("hosts", None)
        out[hosts] = (stream.ct_hash(ct.c0, ct.c1), rec, sm.meta.bits)
        assert sm.committed and sm.duplicates
    assert out[0] == out[4]


def test_link_schedule_of_another_topology_is_refused():
    eng = stream.StreamEngine(StreamConfig(num_hosts=4),
                              FaultConfig(num_hosts=2, link_loss_hosts=1))
    xs, ys = (torch.from_numpy(a) for a in _data())
    model = create_model("smallcnn", device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=256)
    _, pk = keys.keygen(ctx, torch.Generator().manual_seed(21), device="cpu")
    spec = packing.PackedSpec.for_params(params, ctx, PackingConfig(bits=8, clip=0.05), C)
    with pytest.raises(ValueError, match="FaultConfig.num_hosts=2 does not match"):
        eng.run_round(model, TrainConfig(**TRAIN), ctx, pk, params, xs, ys,
                      torch.Generator().manual_seed(22), 0, packing=spec)


def test_dp_refuses_a_tier_staleness_budget():
    from hefl_tpu_torch.fl.dp import DpConfig

    eng = stream.StreamEngine(StreamConfig(num_hosts=2, host_staleness_rounds=1))
    with pytest.raises(ValueError, match="tier staleness budget"):
        eng.run_round(None, TrainConfig(**TRAIN), keys.CkksContext.create(n=256), None, {},
                      torch.zeros((C, 1)), torch.zeros((C, 1)), torch.Generator(), 0,
                      dp=DpConfig())


# ---- the CLI --------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--num-hosts", "4"],
    ["--num-hosts", "4", "--outage-hosts", "1", "--cohort-size", "4"],
    ["--num-hosts", "4", "--link-loss", "1", "--link-dup", "1", "--link-delay", "0.5",
     "--host-quorum", "0.5", "--ship-deadline", "1.0", "--host-staleness", "1",
     "--stream-retries", "1"],
    ["--num-hosts", "3", "--link-dark", "1", "--host-quorum", "0.5", "--fault-seed", "2"],
])
def test_hierarchy_flags_build_the_jax_configs(argv):
    mine = cli.config_from_args(cli.parse_args(["--device", "cpu"] + argv))
    theirs = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(mine.stream) == dataclasses.asdict(theirs.stream)
    assert (mine.faults is None) == (theirs.faults is None)
    if mine.faults is not None:
        assert dataclasses.asdict(mine.faults) == dataclasses.asdict(theirs.faults)


@pytest.mark.parametrize("argv,flag", [
    (["--outage-hosts", "1"], "--outage-hosts"),
    (["--link-dup", "1"], "--link-loss/--link-dark"),
    (["--host-quorum", "0.5"], "--host-quorum"),
    (["--num-hosts", "1"], "--num-hosts 1"),
])
def test_hierarchy_flags_without_tiers_are_refused(argv, flag, capsys):
    with pytest.raises(SystemExit):
        cli.parse_args(["--device", "cpu"] + argv)
    assert flag in capsys.readouterr().err
    with pytest.raises(SystemExit):
        jcli.config_from_args(jcli.build_parser().parse_args(argv))


def test_link_schedule_reaches_the_aggregator():
    fc = FaultConfig(seed=3, num_hosts=4, link_loss_hosts=1, link_dup_hosts=1, link_delay_s=0.5)
    lf = schedule_links(fc, 2)
    jlf = jfaults.schedule_links(jfaults.FaultConfig(**dataclasses.asdict(fc)), 2)
    for f in ("delay_s", "duplicate", "transient", "dark"):
        np.testing.assert_array_equal(getattr(lf, f), getattr(jlf, f))


def test_dcn_compare_smoke_record_and_fold_throughput_record():
    from hefl_tpu_torch.fl import load

    rec = hierarchy.dcn_compare_smoke_record(device="cpu")
    assert rec["bitwise_equal"] and rec["ratio_ok"] and rec["cohort_size"] == 8
    cohort = stream.sample_cohort(StreamConfig(cohort_size=8), 0, 16)
    assert rec["shipping_hosts"] == len(set(parallel.host_of_clients(16, 4)[cohort]))
    tput = load.fold_throughput_record(n_rows=32, repeats=1, device="cpu")
    assert tput["sha_equal"] and set(tput["folds_per_s"]) == {"sequential", "batched", "hier"}


def test_load_records_and_tier_recovery_default_to_cuda(monkeypatch, tmp_path):
    # Entry points run on the card unless the caller passes a device: with
    # none present they raise instead of folding on the host.
    from hefl_tpu_torch.fl import load

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load.fold_throughput_record(n_rows=4, repeats=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        load.ef_packing_record(cohort=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        hierarchy.HierarchicalAggregator(P256, 4, C, journal_dir=str(tmp_path))
    # Without a journal nothing is recovered, so no device is needed.
    hierarchy.HierarchicalAggregator(P256, 4, C)


def test_fold_refuses_a_tensor_off_the_sums_device():
    ups = _uploads(2)
    acc = stream.OnlineAccumulator(P256)
    acc.fold((0, 0), torch.from_numpy(ups[0, 0].astype(np.int32)),
             torch.from_numpy(ups[0, 1].astype(np.int32)))
    # A host array moves to the sum's device; a tensor elsewhere is refused.
    acc.fold((1, 0), ups[1, 0], ups[1, 1])
    off = torch.empty(ups.shape[2:], dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="running sum"):
        acc.fold((2, 0), off, off)
