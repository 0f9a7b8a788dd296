"""The streaming and hierarchical engines across the client mesh, and the
ct axis across ranks, on the CPU.

Worlds of 2 and 4 gloo ranks (`parallel.launch.World`, one torch thread a
rank, spawned once for the module) run the streaming engine
(`StreamEngine.run_round(mesh=)`) on SmallCNN at N = 1024 under the
per-client loop and deterministic algorithms, each rank's rows staged by
`data.RoundPrefetcher` (`fl.stream.round_rows`): a sampled cohort,
quorum and deadline, retries, staleness tau = 1 and a fault schedule
(stragglers, a duplicate, a transient loss, a NaN client), with float and
b = 8 uploads, and through 4 host tiers (a lossy uplink) with b = 4 error
feedback and the hybrid-HE upload. 6 clients on 4 ranks pad the bucket.
Every rank's committed sum (`ct_hash`), round record, round metadata,
metrics and residual registry are the one-rank engine's (rank 0 runs it on
the same inputs), and the decrypted averages sit within 5e-6 (float) or
the packing's error budget (b = 8) of their released clients' plaintext
mean. The fused backend groups a rank's clients differently: its averages
are held to 2e-2 of the one-rank engine's.

The ct split (`secure.ct_sharded_encrypt_core`) is bitwise the JAX
package's `_ct_sharded_encrypt_core` under `shard_map` on `make_mesh_2d(2,
2)` and `(1, 4)` (4 of the 8 virtual CPU devices of tests/conftest.py), on
JAX-drawn samples and an odd ciphertext count (5, so the rows pad); the
secure round on the 2-D mesh is bitwise the 1-D round and the one-device
round. The cohort buckets and gather indices are the JAX ones at 1, 2, 4
and 8 ranks, and `cohort_compare_record` on a 2-rank mesh reports the JAX
record's bucket and devices per axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import ops as jops
from hefl_tpu.fl import fedavg as jfedavg
from hefl_tpu.fl import secure as jsecure
from hefl_tpu.parallel import mesh as jmesh

import torch_stream_tasks as tasks
from hefl_tpu_torch import convert, parallel
from hefl_tpu_torch.ckks import keys
from hefl_tpu_torch.fl import fedavg, secure
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


def _worlds(request, size):
    return request.getfixturevalue(f"world{size}")


def _same_rounds(got: list[dict], backend: str = "vmap") -> None:
    lead = got[0]
    for r, one in enumerate(lead["one"]):
        for g in got:
            mine = g["mesh"][r]
            assert mine["record"] == one["record"]
            assert mine["meta"] == one["meta"]
            if backend == "vmap":
                assert mine["hash"] == one["hash"], (g, r)
                np.testing.assert_array_equal(mine["mets"], one["mets"])
                np.testing.assert_array_equal(mine["overflow"], one["overflow"])
                assert mine["ef"] == one["ef"]


@pytest.mark.parametrize("name,num,size", [
    ("flat", 4, 2), ("packed", 6, 4), ("tiers", 4, 2), ("tiers", 6, 4),
], ids=["float_4_on_2", "b8_6_on_4_padded", "tiers_ef_hhe_4_on_2", "tiers_ef_hhe_6_on_4"])
def test_streaming_rounds_across_ranks_are_the_one_rank_engine_bitwise(request, name, num,
                                                                        size):
    got = _worlds(request, size).run(tasks.stream_rounds, name, num, 5 + num, N, 2)
    _same_rounds(got)
    lead = got[0]
    assert [rec["record"]["committed"] for rec in lead["one"]] == [True, True]
    assert all(d == 0.0 for d in lead["diffs"])
    errs = [e for e in lead["errs"] if e is not None]
    if name == "tiers":
        assert all(rec["record"]["hosts"] is not None for rec in lead["one"])
        assert lead["one"][-1]["ef"] is not None
    else:
        assert errs
        assert max(errs) <= (5e-6 if name == "flat" else lead["budget"])


def test_fused_streaming_rounds_across_ranks_within_the_fused_tolerance(world2):
    got = world2.run(tasks.stream_rounds, "packed", 4, 31, N, 2, "fused")
    _same_rounds(got, backend="fused")
    # A rank fuses its block of the bucket, one device the whole bucket.
    assert got[0]["diffs"] and max(got[0]["diffs"]) <= 2e-2


@pytest.mark.parametrize("ct", [2, 4], ids=["clients2_ct2", "clients1_ct4"])
def test_secure_round_on_the_2d_mesh_is_the_1d_round_bitwise(world4, ct):
    got = world4.run(tasks.secure_round_2d, 4, 7, N, ct, True)
    rows = 4 // ct
    assert got[0]["record"] == {"axes": ["clients", "ct"], "clients": rows, "ct": ct,
                                "world": 4, "backend": "gloo"}
    assert [g["coords"] for g in got] == [{"clients": r // ct, "ct": r % ct} for r in range(4)]
    assert all(g["equal_1d"] for g in got) and len({g["hash"] for g in got}) == 1
    assert got[0]["equal_one"] and got[0]["err"] <= got[0]["budget"]


@pytest.fixture(scope="module")
def he_keys():
    jctx = jkeys.CkksContext.create(n=N)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(61))
    return jctx, jsk, jpk


@pytest.mark.parametrize("rows,ct", [(2, 2), (1, 4)], ids=["clients2_ct2", "clients1_ct4"])
def test_ct_split_is_the_jax_ct_sharded_encrypt_core_bitwise(world4, he_keys, rows, ct):
    jctx, jsk, jpk = he_keys
    num, n_ct = 2, 5                       # odd: 5 rows pad to a multiple of ct
    enc_keys = jax.random.split(jax.random.key(62), num)
    u, e0, e1 = jax.jit(jax.vmap(lambda k: jops.encrypt_samples(jctx, k, (n_ct,))))(enc_keys)
    p = np.asarray(jctx.ntt.p, np.uint64).reshape(1, 1, -1, 1)
    m = (np.random.default_rng(63).integers(0, 2**40, (num, n_ct, jctx.num_primes, N),
                                            dtype=np.uint64) % p).astype(np.uint32)
    mesh = jmesh.make_mesh_2d(num, ct, devices=jax.devices()[:4])
    assert dict(mesh.shape) == {"clients": rows, "ct": ct}

    def body(m_blk, u_blk, e0_blk, e1_blk):
        out = jsecure._ct_sharded_encrypt_core(jctx, jpk, m_blk, u_blk, e0_blk, e1_blk, ct)
        return out.c0, out.c1

    fn = jmesh.shard_map(body, mesh=mesh, in_specs=(P("clients"),) * 4,
                         out_specs=(P("clients"), P("clients")), check_vma=False)
    want = [np.asarray(w) for w in jax.jit(fn)(jnp.asarray(m), u, e0, e1)]
    as_i32 = [np.asarray(a).view(np.int32) for a in (m, u, e0, e1)]
    pk = tuple(np.asarray(a).view(np.int32) for a in (jpk.b_mont, jpk.a_mont))
    got = world4.run(tasks.ct_split, *as_i32, pk, N, num, ct)
    for g in got:
        assert g["record"]["clients"] == rows and g["record"]["ct"] == ct
        np.testing.assert_array_equal(g["c0"].view(np.uint32), want[0][g["block"]])
        np.testing.assert_array_equal(g["c1"].view(np.uint32), want[1][g["block"]])
    # ... and the unsplit core on the same inputs.
    ctx = keys.CkksContext.create(n=N)
    _, tpk = convert.keys_from_jax(jsk, jpk)
    one = secure.ct_sharded_encrypt_core(ctx, tpk, *(torch.from_numpy(a) for a in as_i32), None)
    np.testing.assert_array_equal(one.c0.numpy().view(np.uint32), want[0])
    np.testing.assert_array_equal(one.c1.numpy().view(np.uint32), want[1])


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_cohort_buckets_and_gather_indices_are_the_jax_ones(n_dev):
    for num in (4, 6, 8, 16):
        for size in range(1, num + 1):
            assert fedavg.cohort_bucket(size, num, n_dev) == jfedavg.cohort_bucket(
                size, num, n_dev), (size, num)
            cohort = np.sort(np.random.default_rng(size).choice(num, size, replace=False))
            bucket = fedavg.cohort_bucket(size, num, n_dev)
            np.testing.assert_array_equal(fedavg.cohort_gather_index(cohort, bucket),
                                          jfedavg.cohort_gather_index(cohort, bucket))
            # A rank's block of the bucket: the bucket laid out on the mesh,
            # each block's real rows leading it.
            if size < num:
                blocks = [fedavg.cohort_block(_at_rank(n_dev, r), cohort, num)
                          for r in range(n_dev)]
                np.testing.assert_array_equal(np.concatenate([g for g, _ in blocks]),
                                              fedavg.cohort_gather_index(cohort, bucket))
                cpd = bucket // n_dev
                assert [k for _, k in blocks] == [int(np.clip(size - r * cpd, 0, cpd))
                                                  for r in range(n_dev)]


def _at_rank(n_dev: int, r: int):
    mesh = parallel.make_mesh(n_dev, world=n_dev)
    return parallel.Mesh(axis_names=mesh.axis_names, sizes=mesh.sizes, world=n_dev, rank=r,
                         device=mesh.device)


def test_cohort_compare_record_on_the_mesh_has_the_jax_geometry(world2):
    got = world2.run(tasks.cohort_compare, 8, 2, N)
    for g in got:
        assert g["bucket"] == jfedavg.cohort_bucket(2, 8, 2) == 4
        assert g["devices_per_axis"] == {"clients": 2, "ct": 1}
        assert g["bitwise_equal"] and g["cohort_size"] == 2 and g["num_clients"] == 8
