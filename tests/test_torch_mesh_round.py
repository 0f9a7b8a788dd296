"""The port's rounds across the client mesh (`mesh=`), on the CPU.

Worlds of 2 and 4 gloo ranks (`parallel.launch.World`, spawned once for the
module, one torch thread a rank) run the encrypted round on SmallCNN at
N = 1024 with 4 and 6 clients (6 on 4 ranks pads two masked slots). Under
the per-client loop ("vmap") each client trains the same bits whatever its
rank, so the ciphertext sum is bitwise the one-device round's (rank 0 runs
that round too, in the same process), on every rank, padded, pre-padded
and masked (a participation mask that crosses rank boundaries) alike; the
decrypted average sits within the repo's 5e-6 yardstick of the round's own
plaintext mean. The fused backend groups a rank's clients differently, so
its rounds are held to the fused-versus-loop tolerance (2e-2) instead. The
plaintext round, the owner-side sharded encrypt/decrypt and
`run_experiment` (in a 2-rank world: rank 0's history is the one-device
run's, and only rank 0 writes files) are held here too. The JAX side of
the mesh (collectives, the HE half on `make_mesh(4)`, padding, constructors,
certificates) is in tests/test_torch_mesh.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_mesh_tasks as tasks
from hefl_tpu_torch import experiment
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.parallel.launch import World

N = 1024


@pytest.fixture(scope="module")
def world4():
    with World(4, threads=1) as w:
        yield w


@pytest.fixture(scope="module")
def world2():
    with World(2, threads=1) as w:
        yield w


def _same_sum(a: dict, b: dict) -> None:
    np.testing.assert_array_equal(a["c0"], b["c0"])
    np.testing.assert_array_equal(a["c1"], b["c1"])


def _check_round(got: list[dict]) -> None:
    lead = got[0]
    for r in got:                      # the sum, metrics and meta on every rank
        _same_sum(r["sum"], lead["one"]["sum"])
        np.testing.assert_array_equal(r["mets"], lead["one"]["mets"])
        np.testing.assert_array_equal(r["overflow"], lead["one"]["overflow"])
        if lead["one"]["meta"] is not None or r["meta"] is None:
            assert r["meta"] == lead["one"]["meta"]
        else:    # a padded round runs masked: its meta keeps every real client
            assert set(r["meta"]["bits"]) == {0} and r["meta"]["surviving"] == len(r["mets"])
    assert lead["avg_vs_ref"] <= 5e-6
    assert lead["ref_vs_one_ref"] <= 1e-6


@pytest.mark.parametrize("num,prepad", [(4, False), (6, False), (6, True)],
                         ids=["4_clients", "6_padded_by_the_round", "6_pre_padded"])
def test_secure_round_on_4_ranks_is_the_one_device_round_bitwise(world4, num, prepad):
    got = world4.run(tasks.secure_round, num, 3 + num, N, None, prepad)
    _check_round(got)
    assert (got[0]["meta"] is None) == (num == 4)      # padding runs the masked engine
    if num == 6:
        assert got[0]["meta"]["num_clients"] == 6 and got[0]["meta"]["surviving"] == 6


def test_secure_round_on_2_ranks_is_the_one_device_round_bitwise(world2):
    _check_round(world2.run(tasks.secure_round, 4, 11, N))


def test_masked_round_across_rank_boundaries(world4):
    # Clients 1 and 4 scheduled out: ranks 0 and 2 each keep one of their two.
    mask = [1, 0, 1, 1, 0, 1]
    got = world4.run(tasks.secure_round, 6, 13, N, mask)
    _check_round(got)
    meta = got[0]["meta"]
    assert meta["participation"] == tuple(mask) and meta["surviving"] == 4


def test_fused_rounds_across_ranks_within_the_fused_tolerance(world2):
    cfg = dataclasses.replace(tasks.CFG, client_fusion="fused")
    got = world2.run(tasks.secure_round, 4, 17, N, None, False, cfg)
    assert got[0]["avg_vs_ref"] <= 5e-6
    # A rank fuses its block, one device fuses all four: within 2e-2.
    assert got[0]["ref_vs_one_ref"] <= 2e-2
    _same_sum(got[0]["sum"], got[1]["sum"])


def test_plaintext_round_across_ranks(world2):
    got = world2.run(tasks.plain_round, 4, 19)
    one = got[0]["one"]
    for r in got:
        np.testing.assert_array_equal(r["mets"], one["mets"])
        for k, v in one["params"].items():
            assert float(np.abs(r["params"][k] - v).max()) <= 1e-7, k
    masked = world2.run(tasks.plain_round, 4, 19, [0, 1, 1, 0])
    for r in masked:
        assert r["meta"] == masked[0]["one"]["meta"] and r["meta"]["surviving"] == 2
        for k, v in masked[0]["one"]["params"].items():
            assert float(np.abs(r["params"][k] - v).max()) <= 1e-7, k


def test_owner_side_encrypt_and_decrypt_over_the_ct_mesh(world2):
    assert world2.run(tasks.owner_he, N, 23) == [{"ct_equal": True, "avg_equal": True}] * 2


def test_driver_in_a_two_rank_world_is_the_one_device_run(world2, tmp_path):
    for sub in ("mesh", "one"):
        (tmp_path / sub).mkdir()
    cfg = experiment.ExperimentConfig(
        model="smallcnn", dataset="mnist", num_clients=4, rounds=2, n_train=64, n_test=16,
        he=experiment.HEConfig(n=N), train=TrainConfig(epochs=1, batch_size=8, num_classes=10),
        checkpoint_path=str(tmp_path / "mesh" / "ckpt"),
        save_model_path=str(tmp_path / "mesh" / "model.npz"))
    got = world2.run(tasks.experiment_run, cfg, str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # the ranks' thread count: the same float bits
    try:
        one = experiment.run_experiment(
            dataclasses.replace(cfg, checkpoint_path=str(tmp_path / "one" / "ckpt"),
                                save_model_path=str(tmp_path / "one" / "model.npz")),
            verbose=False, device="cpu")
    finally:
        torch.set_num_threads(threads)
    want = [{k: v for k, v in rec.items() if k not in ("phases", "phase_roofline")}
            for rec in one["history"]]
    assert got[0]["history"] == want and got[1]["history"] == []
    for r in got:
        for k, v in one["params"].items():
            np.testing.assert_array_equal(r["params"][k], v.numpy())
    assert got[1]["writes"] == [] and len(got[0]["writes"]) == 3    # 2 checkpoints + model
    assert got[0]["mesh"] == {"axes": ["clients"], "clients": 2, "ct": 1, "world": 2,
                              "backend": "gloo"}
    assert one["mesh"] == {"axes": ["clients"], "clients": 1, "ct": 1}


def test_a_fault_on_one_rank_fails_the_run_instead_of_a_lone_retry():
    # Rank 1's round raises where rank 0's does not: a retry on rank 1 alone
    # would pair its collectives with rank 0's out of order, so neither
    # rank retries. Rank 0 fails when its all-gather times out (the world's
    # short limit); a DeviceLost, raised on every rank alike, is retried.
    cfg = experiment.ExperimentConfig(
        model="smallcnn", dataset="mnist", num_clients=2, rounds=1, n_train=16, n_test=8,
        encrypted=False, train=TrainConfig(epochs=1, batch_size=8, num_classes=10),
        max_round_retries=2, retry_backoff_s=0.0)
    with World(2, threads=1, timeout_s=15) as world:
        got = world.run(tasks.experiment_one_rank_fault, cfg, 1)
    assert got[1] == {"ended": "RuntimeError: rank 1: injected fault", "calls": 1}
    assert got[0]["ended"] != "completed" and got[0]["calls"] == 1
