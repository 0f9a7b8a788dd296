"""`data.RoundPrefetcher` and the streaming driver across ranks, on the CPU.

The prefetcher has the JAX package's ring semantics (tests/test_fusion.py's
three prefetcher cases): the same host arrays keep one device copy, a
staged copy is promoted and the previous round's copy retired (its storage
freed, the analog of `delete()`), and a tensor the caller passed in is
never freed. With `rows` a rank holds only its block: a test of that and of
the rounds' refusal of a client that is not resident. On a card (marked
`cuda`, skipped here) the staged rows read back bitwise under
deterministic algorithms, whose fill of `empty` the side stream must wait
for.

`run_experiment` with a stream config (a sampled cohort, quorum, deadline,
staleness, a fault schedule, b = 8 uploads) in a 2-rank gloo world gives
rank 0's history and both ranks' parameters bitwise the one-process run's;
so does the journaled run after a crash mid-append in round 1 (rank 0
raises SimulatedCrash, rank 1 PeerRankFailed) and its recovery (the same
command again). Only rank 0 opens the journal and writes files.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_stream_tasks as tasks
from hefl_tpu_torch import experiment, parallel
from hefl_tpu_torch.data import RoundPrefetcher
from hefl_tpu_torch.fl import fedavg
from hefl_tpu_torch.fl.config import PackingConfig, StreamConfig
from hefl_tpu_torch.fl.faults import CrashConfig, FaultConfig
from hefl_tpu_torch.parallel.launch import World


def _freed(t: torch.Tensor) -> bool:
    return t.untyped_storage().size() == 0


def test_round_prefetcher_identity_short_circuit():
    xs = np.arange(24, dtype=np.uint8).reshape(2, 12)
    ys = np.arange(2, dtype=np.int32)
    pf = RoundPrefetcher("cpu")
    a = pf.get(xs, ys)
    np.testing.assert_array_equal(a[0].numpy(), xs)
    # same host arrays -> the SAME resident device buffers, no new copy
    b = pf.get(xs, ys)
    assert a[0] is b[0] and a[1] is b[1]
    pf.prefetch(xs, ys)  # no-op: already resident
    assert pf.get(xs, ys)[0] is a[0]


def test_round_prefetcher_stages_and_retires():
    pf = RoundPrefetcher("cpu")
    r0 = (np.zeros((2, 4), np.float32), np.zeros(2, np.int32))
    r1 = (np.ones((2, 4), np.float32), np.ones(2, np.int32))
    cur = pf.get(*r0)
    pf.prefetch(*r1)                    # the copy overlaps "round 0"
    staged = pf._next[0][0]
    nxt = pf.get(*r1)                   # promote the staged buffers
    assert nxt[0] is staged
    np.testing.assert_array_equal(nxt[0].numpy(), r1[0])
    # round 0's buffers were retired (their storage freed) on promotion,
    # and the host arrays they were copied from are untouched
    assert _freed(cur[0]) and _freed(cur[1])
    assert not r0[0].any()


def test_round_prefetcher_never_frees_caller_tensors():
    pf = RoundPrefetcher("cpu")
    dev0 = torch.arange(8, dtype=torch.float32)   # already on the device
    got = pf.get(dev0)
    assert got[0] is dev0
    pf.get(np.ones(8, np.float32))                 # retires round 0's entry
    assert not _freed(dev0)
    np.testing.assert_array_equal(dev0.numpy(), np.arange(8, dtype=np.float32))


@pytest.mark.parametrize("num,n_dev", [(4, 2), (6, 4)])
def test_a_rank_stages_only_its_block_of_the_padded_registry(num, n_dev):
    xs = np.arange(num * 3, dtype=np.uint8).reshape(num, 3)
    ys = np.arange(num, dtype=np.int32)
    mesh = parallel.make_mesh(num, world=n_dev)
    pad = fedavg.pad_index(num, n_dev)
    padded = xs if pad is None else xs[pad]
    cpd = len(padded) // n_dev
    for r in range(n_dev):
        at = dataclasses.replace(mesh, rank=r)
        rows, _ = fedavg.client_block(at, num, pad)
        got = RoundPrefetcher("cpu").get(xs, ys, rows=rows)
        np.testing.assert_array_equal(got[0].numpy(), padded[r * cpd:(r + 1) * cpd])
        assert got[0].numel() * n_dev == padded.size
    # A round that needs a client this rank did not stage refuses.
    with pytest.raises(ValueError, match=r"clients \[3\] are not among the rows resident"):
        fedavg.resident_index(np.array([0, 3]), np.array([0, 1]), "cpu")


@pytest.mark.cuda
def test_staged_rows_on_the_card_are_the_host_rows_under_deterministic_algorithms():
    # On a card the copy runs on a side stream into buffers allocated on the
    # current one, where deterministic algorithms queue a fill of `empty`:
    # the side stream must wait for that fill, or labels read back garbage.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the staged copy runs on a side stream of the card)")
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 256, (8, 48, 16, 16, 3), dtype=np.uint8)
    ys = rng.integers(0, 2, (8, 48)).astype(np.int32)
    pf = RoundPrefetcher("cuda")
    with experiment.deterministic_algorithms():
        for r, rows in enumerate(([0, 1], [2, 3], [4, 5], [6, 7])):
            got = pf.get(xs, ys, rows=rows)
            if r < 3:
                pf.prefetch(xs, ys, rows=[2 * r + 2, 2 * r + 3])
            np.testing.assert_array_equal(got[0].cpu().numpy(), xs[rows])
            np.testing.assert_array_equal(got[1].cpu().numpy(), ys[rows])


def _cfg(**kw):
    return experiment.ExperimentConfig(
        model="smallcnn", dataset="mnist", num_clients=4, rounds=2, n_train=32, n_test=8,
        he=experiment.HEConfig(n=1024), train=tasks.CFG, events_path="",
        stream=StreamConfig(**tasks.FLAT[0]), faults=FaultConfig(**tasks.FLAT[1]),
        packing=PackingConfig(bits=8), **kw)


@pytest.fixture(scope="module")
def one_process():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # the ranks' thread count: the same float bits
    try:
        out = experiment.run_experiment(_cfg(), verbose=False, device="cpu")
    finally:
        torch.set_num_threads(threads)
    hist = [{k: v for k, v in rec.items() if k not in ("phases", "phase_roofline")}
            for rec in out["history"]]
    return hist, out["params"]


@pytest.fixture(scope="module")
def world2():
    with World(2, threads=1) as w:
        yield w


def _same_as_one_process(got, one_process) -> None:
    hist, params = one_process
    assert [g["ended"] for g in got] == ["completed"] * 2
    assert got[0]["history"] == hist and got[1]["history"] == []
    for g in got:
        for k, v in params.items():
            np.testing.assert_array_equal(g["params"][k], v.numpy())
    assert got[1]["writes"] == [] and got[1]["opened"] == []


def test_streaming_driver_in_a_two_rank_world_is_the_one_process_run(world2, one_process):
    got = world2.run(tasks.experiment_run, _cfg())
    _same_as_one_process(got, one_process)
    assert got[0]["mesh"] == {"axes": ["clients"], "clients": 2, "ct": 1, "world": 2,
                              "backend": "gloo"}
    assert [rec["stream"]["committed"] for rec in got[0]["history"]] == [True, True]


def test_journaled_streaming_driver_recovers_a_crash_across_ranks(world2, one_process,
                                                                   tmp_path):
    journal = str(tmp_path / "journal.wal")
    cfg = _cfg(journal_path=journal, fsync_policy="never")
    crashed = world2.run(tasks.experiment_run, dataclasses.replace(
        cfg, crash=CrashConfig(round=1, at="mid_append", after_folds=1)))
    assert [g["ended"] for g in crashed] == ["SimulatedCrash", "PeerRankFailed"]
    assert [g["opened"] for g in crashed] == [[journal], []]
    got = world2.run(tasks.experiment_run, cfg)
    _same_as_one_process(got, one_process)
    assert got[0]["opened"] == [journal]
    rec = got[0]["journal"]["recovered"]
    assert (rec["torn_bytes_truncated"], rec["sealed_rounds"], rec["open_round"]) == (24, [0], 1)
