"""The port's write-ahead journal (`hefl_tpu_torch.fl.journal`) against the
JAX package's, on the CPU: byte for byte.

The frame, the hash chain, the JSON and the bodies are the JAX package's,
so the same record stream gives the same file through either writer, each
package reads (and compacts) the other's file, and the load trace of
`fl.load` reproduces BENCH_LOAD.json's committed `journal_bytes_sha` and
`sum_sha` under every fsync policy, group-committed or not, folded one at
a time or in batches.
"""

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from hefl_tpu.fl import journal as jjr

from hefl_tpu_torch.fl import journal as jr
from hefl_tpu_torch.fl import load
from hefl_tpu_torch.fl.stream import ct_hash
from hefl_tpu_torch.obs import metrics as obs_metrics

REPO = Path(__file__).resolve().parent.parent
RUNS = json.loads((REPO / "BENCH_LOAD.json").read_text())["bench_load"]["runs"]


@pytest.mark.parametrize("policy,group_commit,fold_batched,run", [
    ("never", True, False, None), ("never", False, True, None), ("always", True, False, "always"),
    ("commit", True, False, "commit_grouped"), ("commit", False, False, "commit_unbatched"),
    ("commit", True, True, "commit_grouped_batchfold"),
])
def test_load_trace_reproduces_bench_load_shas(tmp_path, policy, group_commit, fold_batched, run):
    rec = load.drive_trace(load.LoadConfig(), str(tmp_path / "j.wal"), policy,
                           group_commit=group_commit, fold_batched=fold_batched, device="cpu")
    assert rec["journal_bytes_sha"] == (
        "e0db2886b333c42b94cd51c9600bc1a71c19043a92e90723cae9f99331d0ae2d")
    assert rec["sum_sha"] == (
        "e31de3db60e7b96c52c67fbce38e3d7d661c5952ff24b9b145b6ab2a28c48b7d")
    ref = RUNS[run or "always"]
    assert (rec["journal_bytes_sha"], rec["sum_sha"]) == (ref["journal_bytes_sha"], ref["sum_sha"])
    for key in ("folds", "dedup_hits", "appends", "bytes_written", "dedup_window_peak"):
        assert rec[key] == ref[key], key
    assert rec["fsyncs"] == (0 if policy == "never" else ref["fsyncs"])
    assert rec["group_commit"] == ref["group_commit"] if run else rec["dedup_bound_ok"]


def test_recovery_record_scans_whole_and_half_journal(tmp_path):
    path = str(tmp_path / "j.wal")
    load.drive_trace(load.LoadConfig.smoke(), path, "never", device="cpu")
    half, whole = load.recovery_record(load.LoadConfig.smoke(), path)
    assert 0 < half["records"] < whole["records"] and half["bytes"] < whole["bytes"]
    assert whole["records"] == len(jjr.read_journal(path))


def _stream(mod, path, tensors: bool, group_commit=True):
    """One deterministic record stream through `mod`'s writer: torch int32
    residues on the port's side, numpy uint32 on the JAX side."""
    rng = np.random.default_rng(0)
    w, recs, torn = mod.open_journal(path, "commit", meta={"stream": {"quorum": 0.5}},
                                     group_commit=group_commit)
    assert recs == [] and torn == 0
    for r in range(2):
        w.append("round_open", {"round": r, "key": [0, 100 + r], "cohort": [0, 1, 2]})
        for i in range(5):
            c = rng.integers(0, 2**27 - 39, (2, 3, 16)).astype(np.uint32)
            a, b = (torch.from_numpy(c.astype(np.int32)), torch.from_numpy(
                c[::-1].astype(np.int32).copy())) if tensors else (c, c[::-1])
            w.append("fold", {"round": r, "seq": i, "client": i % 3,
                              "t": float(rng.uniform(0, 2)), "nonce": (i % 3, r),
                              "sha": mod.ct_body_sha(a, b)}, mod.ct_body(a, b))
        w.append("commit", {"round": r, "surviving": np.int64(3), "sum_sha": "ab" * 32,
                            "commit_s": np.float64(0.25)})
        w.append("carry", {"round": r, "client": 2, "origin_round": r, "nonce": [2, r],
                           "lands_at": 0.5, "lateness": 1, "shape": [2, 3, 16],
                           "sha": hashlib.sha256(mod.ct_body(a, b)).hexdigest()},
                 mod.ct_body(a, b))
        w.append("round_close", {"round": r, "committed": True, "seen": [[0, r], [1, r]]})
    w.close()


def _sha(path):
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


@pytest.mark.parametrize("group_commit", [True, False])
def test_same_record_stream_gives_identical_files_and_each_reads_the_other(tmp_path,
                                                                          group_commit):
    mine, theirs = str(tmp_path / "port.wal"), str(tmp_path / "jax.wal")
    _stream(jr, mine, tensors=True, group_commit=group_commit)
    _stream(jjr, theirs, tensors=False, group_commit=group_commit)
    assert _sha(mine) == _sha(theirs)
    for reader in (jr.read_journal, jjr.read_journal):
        a, b = reader(mine), reader(theirs)
        assert a == b and [r["kind"] for r in a][:3] == ["journal_open", "round_open", "fold"]
    assert jr.scan_journal(theirs).chain == jjr.scan_journal(mine).chain
    fold = jr.read_journal(theirs)[2]
    c0, c1 = jr.ct_from_body(fold["body"], (2, 3, 16))
    assert ct_hash(c0, c1) == fold["sha"] == ct_hash(torch.from_numpy(c0.astype(np.int32)),
                                                    torch.from_numpy(c1.astype(np.int32)))


def test_compaction_gives_identical_bytes_in_both(tmp_path):
    mine, theirs = str(tmp_path / "port.wal"), str(tmp_path / "jax.wal")
    _stream(jr, mine, tensors=True)
    shutil.copy(mine, theirs)
    assert jr.compact(mine, 1) == jjr.compact(theirs, 1) == (11, 7)
    assert _sha(mine) == _sha(theirs)
    recs = jjr.read_journal(mine)
    assert recs[0]["base_round"] == 1 and recs[0]["meta"] == {"stream": {"quorum": 0.5}}
    assert {r["kind"] for r in recs if r.get("round") == 0} == {"carry", "round_close"}


def test_torn_tail_is_truncated_only_with_repair(tmp_path):
    path = str(tmp_path / "j.wal")
    _stream(jr, path, tensors=True)
    size = Path(path).stat().st_size
    with open(path, "ab") as f:
        f.write(jr.MAGIC + b"\x07" * 20)          # a torn append: 24 bytes
    for mod in (jr, jjr):
        with pytest.raises(mod.JournalError, match="torn tail \\(24 trailing bytes"):
            mod.read_journal(path)
    base = obs_metrics.snapshot()
    recs = jr.read_journal(path, repair=True)
    assert Path(path).stat().st_size == size and len(recs) == 19
    assert obs_metrics.snapshot_delta(base)["journal.torn_tail_truncated"] == 1
    w, recs2, torn = jr.open_journal(path)      # a clean file reopens with nothing to cut
    w.close()
    assert torn == 0 and len(recs2) == 19


def _frame_offsets(path):
    data, off, out = Path(path).read_bytes(), 0, []
    while off < len(data):
        plen, _ = jr._LEN_CRC.unpack_from(data, off + 4)
        out.append(off)
        off += jr._PREFIX + plen
    return out


@pytest.mark.parametrize("damage", ["crc", "chain", "magic"])
def test_damage_raises_the_jax_error_classes_with_the_same_messages(tmp_path, damage):
    path = str(tmp_path / "j.wal")
    _stream(jr, path, tensors=True)
    data = bytearray(Path(path).read_bytes())
    off = _frame_offsets(path)[3]
    if damage == "crc":
        data[off + jr._PREFIX + 5] ^= 1
    elif damage == "chain":
        data[off + 12] ^= 1
    else:
        data[off] ^= 1
    Path(path).write_bytes(bytes(data))
    want = {"crc": (jr.JournalCorruptError, jjr.JournalCorruptError),
            "chain": (jr.JournalChainError, jjr.JournalChainError),
            "magic": (jr.JournalCorruptError, jjr.JournalCorruptError)}[damage]
    with pytest.raises(want[0]) as got:
        jr.read_journal(path, repair=True)
    with pytest.raises(want[1]) as ref:
        jjr.read_journal(path, repair=True)
    assert str(got.value) == str(ref.value)
    assert issubclass(want[0], jr.JournalError)


def test_replay_divergence_raises():
    replay = [{"kind": "round_open", "round": 0, "key": [1, 2], "cohort": [0], "quorum": 1,
               "tau": 0, "num_clients": 1, "packed_clients": None}]
    jr.RoundSession(None, replay=list(replay)).round_open(0, [1, 2], [0], 1, 0, 1, None)
    with pytest.raises(jr.JournalReplayError, match="divergence"):
        jr.RoundSession(None, replay=list(replay)).round_open(0, [9, 9], [0], 1, 0, 1, None)
    fold = jr.RoundSession(None, replay=[{"kind": "fold", "round": 0, "seq": 0, "src": "fresh",
                                          "client": 0, "nonce": [0, 0], "lateness": 0,
                                          "t": 0.0, "sha": "00"}])
    with pytest.raises(jr.JournalReplayError, match="fold"):
        fold.fold(0, 0, "fresh", 0, (0, 0), 0, 0.0, torch.zeros(2, 3, 4, dtype=torch.int32),
                  torch.zeros(2, 3, 4, dtype=torch.int32), persist=True)


def test_bodies_are_the_uint32_view_and_fields_canonical():
    c0 = torch.tensor([[0, 1, 2**27 - 40]], dtype=torch.int32)
    c1 = torch.tensor([[5, 6, 7]], dtype=torch.int32)
    want = jjr.ct_body(c0.numpy().astype(np.uint32), c1.numpy().astype(np.uint32))
    assert jr.ct_body(c0, c1) == want
    assert jr.ct_body_sha(c0, c1) == jjr.ct_body_sha(c0.numpy(), c1.numpy())
    fields = {"a": torch.tensor(3), "b": torch.tensor(0.5, dtype=torch.float64),
              "c": (np.int64(1), np.float64(2.5), np.bool_(True)), "d": torch.tensor([1, 2])}
    assert jr._canon(fields) == {"a": 3, "b": 0.5, "c": [1, 2.5, True], "d": [1, 2]}
    assert jr._encode_payload(jr._canon(fields), None) == jjr._encode_payload(
        {"a": 3, "b": 0.5, "c": [1, 2.5, True], "d": [1, 2]}, None)


def test_fsync_policies_and_the_environment_switch(tmp_path, monkeypatch):
    base = obs_metrics.snapshot()
    _stream(jr, str(tmp_path / "c.wal"), tensors=True)
    assert obs_metrics.snapshot_delta(base)["journal.fsyncs"] == 1 + 2 * 2
    monkeypatch.setenv("HEFL_JOURNAL_FSYNC", "Always")
    with pytest.raises(ValueError, match="HEFL_JOURNAL_FSYNC"):
        jr.JournalWriter(str(tmp_path / "x.wal"))
    monkeypatch.setenv("HEFL_JOURNAL_FSYNC", "never")
    assert jr.JournalWriter(str(tmp_path / "x.wal")).fsync_policy == "never"
    with pytest.raises(ValueError, match="fsync_policy"):
        jr.JournalWriter(str(tmp_path / "y.wal"), "sometimes")


def test_hierarchical_journal_recovers_carried_tier_partials(tmp_path):
    # A dark uplink and ship delays past the deadline: round 0 carries its
    # missed host partials (tier_carry records); a crash in round 1 leaves
    # them to recovery, which rebuilds them from the journal alone and
    # replays round 1 to the uninterrupted twin's commit chain.
    from hefl_tpu_torch.ckks import keys, packing
    from hefl_tpu_torch.data import partition, synthetic
    from hefl_tpu_torch.fl import server
    from hefl_tpu_torch.fl.config import PackingConfig, StreamConfig, TrainConfig
    from hefl_tpu_torch.fl.faults import CrashConfig, FaultConfig, SimulatedCrash
    from hefl_tpu_torch.models import create_model

    (x, y), _, _ = synthetic.make_dataset("mnist", seed=0, n_train=64, n_test=8)
    xs, ys = (torch.from_numpy(a) for a in partition.stack_federated(
        x, y, partition.iid_contiguous(64, 8)))
    model = create_model("smallcnn", device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=256)
    _, pk = keys.keygen(ctx, torch.Generator().manual_seed(21), device="cpu")
    spec = packing.PackedSpec.for_params(params, ctx, PackingConfig(bits=8, clip=0.05), 8)
    s = StreamConfig(quorum=0.5, deadline_s=2.0, max_retries=1, num_hosts=4, host_quorum=0.5,
                     ship_deadline_s=0.3, host_staleness_rounds=1)
    f = FaultConfig(seed=1, num_hosts=4, link_dark_hosts=1, link_delay_s=0.6)
    cfg = TrainConfig(epochs=1, batch_size=4, num_classes=10, augment=False, val_fraction=0.25)

    def rounds(srv, todo):
        shas = {}
        for r in todo:
            ct, _, _, sm = srv.run_round(model, cfg, ctx, pk, params, xs, ys,
                                         torch.Generator().manual_seed(100 + r), r, packing=spec)
            shas[r] = ct_hash(ct.c0, ct.c1)
        return shas

    twin = server.AggregationServer(s, f, journal_path=str(tmp_path / "twin.wal"),
                                    fsync_policy="never")
    want = rounds(twin, (0, 1))
    twin.close()
    path = str(tmp_path / "crash.wal")
    srv = server.AggregationServer(s, f, journal_path=path, fsync_policy="never",
                                   crash=CrashConfig(round=1, at="post_fold", after_folds=1))
    rounds(srv, (0,))
    with pytest.raises(SimulatedCrash):
        rounds(srv, (1,))
    rec = server.AggregationServer(s, f, journal_path=path, fsync_policy="never")
    assert rec.recovered.carried_tier_partials >= 1 and rec.recovered.open_round == 1
    assert rec.engine._pending_tiers[0].sha in {
        r["sha"] for r in jr.read_journal(path) if r["kind"] == "tier_carry"}
    assert rounds(rec, (1,)) == {1: want[1]}
    rec.close()
    kinds = [r["kind"] for r in jr.read_journal(path)]
    assert "tier_carry" in kinds and "tier_fold" in kinds
    # The JAX reader takes the hierarchical journal too.
    assert [r["kind"] for r in jjr.read_journal(path)] == kinds
