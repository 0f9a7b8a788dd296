"""The port's client mesh (`hefl_tpu_torch.parallel`) against the JAX
package's, on the CPU.

The mesh constructors' axes and sizes are the JAX ones over a table of (clients,
devices, ct shards); `pad_index` / `pad_federated` are bitwise the JAX
ones. The collectives run in spawned gloo worlds (`parallel.launch.World`,
one per world size for the module) and are held bitwise against the JAX
functions under `shard_map` on the same count of the 8 virtual CPU devices
(tests/conftest.py), on residues near p drawn with numpy from a seed;
`pmean_tree` within one float32 ulp. So is the HE half of a sharded round
(encrypt each rank's block with JAX-drawn samples, zero the excluded rows,
sum, all-reduce mod p) against the JAX round body's tail on `make_mesh(4)`,
padded and masked counts included. The aggregation certificate's psum
legs are the JAX certificate's string for string (through the `jax_x64`
stand-in) and the psum_mod regions pass the exact-integer lint.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hefl_tpu.analysis import ranges as jranges
from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import ops as jops
from hefl_tpu.ckks.packing import PackSpec as JPackSpec
from hefl_tpu.fl import fedavg as jfedavg
from hefl_tpu.fl import secure as jsecure
from hefl_tpu.parallel import collectives as jcoll
from hefl_tpu.parallel import mesh as jmesh

import torch_mesh_tasks as tasks
from hefl_tpu_torch import convert, parallel
from hefl_tpu_torch.analysis import lint, ranges
from hefl_tpu_torch.ckks import keys
from hefl_tpu_torch.fl import fedavg, secure
from hefl_tpu_torch.parallel.launch import World
from torch_jax_x64 import jax_x64  # noqa: F401  (the JAX certifiers' stand-in)

REPO = Path(__file__).resolve().parent.parent
P27 = 2**27 - 39


@pytest.fixture(scope="module")
def world4():
    with World(4, threads=1) as w:
        yield w


@pytest.fixture(scope="module")
def world2():
    with World(2, threads=1) as w:
        yield w


# ---- mesh constructors and padding (arithmetic, no world) ---------------------


def _jshape(m) -> dict:
    return {a: int(m.shape[a]) for a in m.axis_names}


@pytest.mark.parametrize("clients,devices", [(1, 8), (2, 8), (4, 4), (6, 4), (16, 8), (3, 1)])
def test_make_mesh_is_the_jax_mesh(clients, devices, monkeypatch):
    monkeypatch.delenv("HEFL_MESH_CT", raising=False)
    want = jmesh.make_mesh(clients, devices=jax.devices()[:devices])
    got = parallel.make_mesh(clients, world=devices)
    assert got.axis_names == tuple(want.axis_names) and got.shape == _jshape(want)
    assert parallel.client_axes(got) == jmesh.client_axes(want)
    assert parallel.client_mesh_size(got) == jmesh.client_mesh_size(want)
    assert parallel.local_client_count(got, clients) == jmesh.local_client_count(want, clients)
    assert parallel.ct_shard_count(got) == jmesh.ct_shard_count(want) == 1
    assert parallel.host_count(got) == jmesh.host_count(want) == 1
    assert got.group is None and got.member        # layout only: no process group


@pytest.mark.parametrize("clients,ct,devices", [
    (1, 1, 8), (4, 2, 8), (8, 2, 8), (3, 4, 8), (2, 16, 8), (6, 3, 4), (5, 1, 1)])
def test_make_mesh_2d_is_the_jax_mesh(clients, ct, devices):
    want = jmesh.make_mesh_2d(clients, ct, devices=jax.devices()[:devices])
    got = parallel.make_mesh_2d(clients, ct, world=devices)
    assert got.axis_names == tuple(want.axis_names) and got.shape == _jshape(want)
    assert parallel.ct_shard_count(got) == jmesh.ct_shard_count(want)
    assert parallel.client_mesh_size(got) == jmesh.client_mesh_size(want)
    with pytest.raises(ValueError, match="ct_shards=0 must be >= 1"):
        parallel.make_mesh_2d(clients, 0, world=devices)


@pytest.mark.parametrize("hosts,per,devices", [(2, 2, 4), (2, 4, 8), (4, 2, 8), (1, 3, 4)])
def test_make_host_mesh_is_the_jax_mesh(hosts, per, devices):
    want = jmesh.make_host_mesh(hosts, per, devices=jax.devices()[:devices])
    got = parallel.make_host_mesh(hosts, per, world=devices)
    assert got.axis_names == tuple(want.axis_names) and got.shape == _jshape(want)
    assert parallel.client_axes(got) == jmesh.client_axes(want) == ("hosts", "clients")
    assert parallel.client_mesh_size(got) == jmesh.client_mesh_size(want)
    assert parallel.host_count(got) == jmesh.host_count(want) == hosts
    with pytest.raises(ValueError) as jerr:
        jmesh.make_host_mesh(hosts, devices + 1, devices=jax.devices()[:devices])
    with pytest.raises(ValueError) as err:
        parallel.make_host_mesh(hosts, devices + 1, world=devices)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("devices,cap", [(8, None), (8, 3), (4, 8), (1, None)])
def test_make_ct_mesh_is_the_jax_mesh(devices, cap):
    want = jmesh.make_ct_mesh(devices=jax.devices()[:devices], max_devices=cap)
    got = parallel.make_ct_mesh(world=devices, max_devices=cap)
    assert got.axis_names == tuple(want.axis_names) and got.shape == _jshape(want)


def test_mesh_coords_and_client_blocks_are_row_major():
    host = parallel.make_host_mesh(2, 3, world=6)
    assert host.coords == {"hosts": 0, "clients": 0}
    import dataclasses

    for r, want in enumerate([(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]):
        m = dataclasses.replace(host, rank=r)
        assert tuple(m.coords.values()) == want and parallel.client_index(m) == r
    two_d = parallel.make_mesh_2d(3, 2, world=6)
    for r in range(6):       # every ct rank of a row trains the row's block
        assert parallel.client_index(dataclasses.replace(two_d, rank=r)) == r // 2
    outside = dataclasses.replace(parallel.make_mesh(2, world=4), rank=3)
    assert not outside.member
    with pytest.raises(ValueError, match="outside the 2-rank mesh"):
        outside.coords


@pytest.mark.parametrize("clients,n_dev", [(4, 4), (6, 4), (5, 2), (1, 8), (7, 3), (16, 8)])
def test_padding_is_the_jax_padding(clients, n_dev):
    want, got = jfedavg.pad_index(clients, n_dev), fedavg.pad_index(clients, n_dev)
    assert (want is None) == (got is None)
    if got is not None:
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(clients)
    xs = rng.integers(0, 255, (clients, 3, 4, 4, 1), dtype=np.uint8)
    ys = rng.integers(0, 10, (clients, 3)).astype(np.int32)
    jx, jy, jn = jfedavg.pad_federated(xs, ys, n_dev)
    tx, ty, tn = fedavg.pad_federated(torch.from_numpy(xs), torch.from_numpy(ys), n_dev)
    assert tn == jn == clients
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    num, pad, prepadded = fedavg._round_geometry(tx, n_dev, tn)
    assert num == clients and prepadded and (pad is None) == (got is None)
    with pytest.raises(ValueError, match="pre-padded") as err:
        fedavg._round_geometry(tx[:-1], n_dev, tn)
    with pytest.raises(ValueError) as jerr:
        jfedavg._round_geometry(np.asarray(jx)[:-1], n_dev, jn)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("clients,n_dev", [(6, 4), (8, 4), (5, 2), (3, 3)])
def test_client_blocks_tile_the_padded_registry(clients, n_dev):
    import dataclasses

    mesh = parallel.make_mesh(n_dev, world=n_dev)
    pad = fedavg.pad_index(clients, n_dev)
    padded = np.arange(clients) if pad is None else pad
    blocks = [fedavg.client_block(dataclasses.replace(mesh, rank=r), clients, pad)
              for r in range(n_dev)]
    np.testing.assert_array_equal(np.concatenate([g for g, _ in blocks]), padded)
    cpd = len(padded) // n_dev
    # A block's real rows lead it: the padding is the registry's suffix.
    assert [rows for _, rows in blocks] == [int(np.clip(clients - r * cpd, 0, cpd))
                                           for r in range(n_dev)]


@pytest.mark.parametrize("mesh_ct", [0, 2])
def test_a_process_group_runs_the_1d_mesh_whatever_mesh_ct(mesh_ct):
    # In a process group mesh_ct > 1 builds the 2-D (clients, ct) mesh, whose
    # ct ranks split a block's encrypt rows, and the record shows its real
    # ct size; mesh_ct 0 the 1-D mesh. With no group one device is one
    # block: the two axes named, ct of size 1.
    from hefl_tpu_torch import experiment

    cfg = experiment.ExperimentConfig(num_clients=4, mesh_ct=mesh_ct)
    axes = ["clients", "ct"] if mesh_ct > 1 else ["clients"]
    mesh = (parallel.make_mesh_2d(4, mesh_ct, world=4) if mesh_ct > 1
            else parallel.make_mesh(4, world=4))
    assert experiment.mesh_record(cfg, mesh) == {
        "axes": axes, "clients": 4 // max(mesh_ct, 1), "ct": max(mesh_ct, 1), "world": 4,
        "backend": None}
    assert experiment.mesh_record(cfg, None) == {"axes": axes, "clients": 1, "ct": 1}
    assert ("make_mesh_2d(cfg.num_clients, cfg.mesh_ct, device=device) if cfg.mesh_ct > 1"
            in Path(experiment.__file__).read_text())


def test_init_mesh_refuses_more_nccl_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="a world of 2 NCCL ranks needs 2 cards, have 1"):
        parallel.init_mesh("cuda", rank=0, world_size=2)
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.init_mesh("cpu") == torch.device("cpu")     # no world: no group
    assert not torch.distributed.is_initialized()


def test_parallel_exports_the_jax_names():
    tree = ast.parse((REPO / "hefl_tpu" / "parallel" / "__init__.py").read_text())
    names = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                 and any(getattr(t, "id", None) == "__all__" for t in n.targets))
    # shard_map: each rank runs its own block eagerly; nothing maps a body.
    unported = {"shard_map"}
    for name in names:
        assert hasattr(parallel, name) != (name in unported), name
        assert (name in parallel.__all__) != (name in unported), name


def test_the_import_scan_covers_the_mesh_modules():
    files = {p.relative_to(REPO).as_posix() for p in (REPO / "hefl_tpu_torch").rglob("*.py")}
    assert {"hefl_tpu_torch/parallel/mesh.py", "hefl_tpu_torch/parallel/collectives.py",
            "hefl_tpu_torch/parallel/launch.py"} <= files


def test_a_failing_rank_fails_the_call_and_the_world_serves_on(world2):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        world2.run(tasks.raise_on, 1)
    assert world2.run(tasks.raise_on, 5) == [0, 1]


# ---- collectives in spawned worlds vs the JAX ones on the virtual mesh --------


def _residues(seed: int, world: int, p: np.ndarray) -> np.ndarray:
    """int32[world, L, 64] residues, half within 1000 of p (the sums wrap p
    several times), half uniform."""
    rng = np.random.default_rng(seed)
    near = p[None, :, None] - 1 - rng.integers(0, 1000, (world, len(p), 32))
    far = rng.integers(0, 2**40, (world, len(p), 32)) % p[None, :, None]
    return np.concatenate([near, far], axis=-1).astype(np.int32)


def _jax_reduce(fn, mesh, axes, x, p):
    body = lambda blk: fn(blk[0], p, axes)  # noqa: E731
    return np.asarray(jmesh.shard_map(body, mesh=mesh, in_specs=P(axes), out_specs=P(),
                                      check_vma=False)(jnp.asarray(x.view(np.uint32))))


@pytest.mark.parametrize("seed", [0, 1])
def test_modular_all_reduces_are_bitwise_the_jax_ones(world4, seed):
    p = np.array([[P27], [2**27 - 147], [2**26 - 5]], np.int64)
    x = _residues(seed, 4, p[:, 0])
    got = world4.run(tasks.collectives, x, p)
    jp = jnp.asarray(p.astype(np.uint32))
    flat = jmesh.make_mesh(4, devices=jax.devices()[:4])
    host = jmesh.make_host_mesh(2, 2, devices=jax.devices()[:4])
    want = {
        "psum_mod": _jax_reduce(jcoll.psum_mod, flat, "clients", x, jp),
        "ring_psum_mod": _jax_reduce(jcoll.ring_psum_mod, flat, "clients", x, jp),
        "reduce_mod": _jax_reduce(jcoll.reduce_mod, flat, "clients", x, jp),
        "hierarchical": _jax_reduce(jcoll.hierarchical_psum_mod, host, ("hosts", "clients"),
                                    x, jp),
    }
    total = (x.astype(np.int64).sum(0) % p).astype(np.uint32)
    for name, w in want.items():
        np.testing.assert_array_equal(w, total)
        for r in range(4):
            np.testing.assert_array_equal(got[r][name].view(np.uint32), w, err_msg=f"{name} {r}")
    for r in range(4):         # a host row's own clients only
        row = (x[2 * (r // 2): 2 * (r // 2) + 2].astype(np.int64).sum(0) % p).astype(np.uint32)
        np.testing.assert_array_equal(got[r]["host_rows"].view(np.uint32), row)


def test_pmean_tree_is_the_jax_pmean_within_one_ulp(world4):
    # Bitwise in fact: psum_tree adds the ranks in rank order, as the JAX
    # package's CPU psum does.
    rng = np.random.default_rng(9)
    trees = [{"w": rng.uniform(-0.5, 0.5, (7, 5)).astype(np.float32),
              "b": rng.uniform(-0.5, 0.5, (5,)).astype(np.float32)} for _ in range(4)]
    got = world4.run(tasks.pmean, trees)
    mesh = jmesh.make_mesh(4, devices=jax.devices()[:4])
    stack = {k: jnp.asarray(np.stack([t[k] for t in trees])) for k in trees[0]}
    fn = jmesh.shard_map(lambda s: jcoll.pmean_tree({k: v[0] for k, v in s.items()}, "clients"),
                         mesh=mesh, in_specs=P("clients"), out_specs=P(), check_vma=False)
    want = {k: np.asarray(v) for k, v in fn(stack).items()}
    for r in range(4):
        for k, w in want.items():
            assert np.all(np.abs(got[r][k] - w) <= np.spacing(np.abs(w))), (r, k)
            np.testing.assert_array_equal(got[r][k], w)


@pytest.mark.parametrize("keep", [(1, 1, 1, 1), (1, 0, 0, 1), (0, 0, 0, 0)])
def test_masked_mean_across_ranks_matches_jax(world2, keep):
    # The tolerance of test_torch_round's masked_mean_tree test; the port
    # runs the JAX op sequence across the ranks, so it is bitwise here.
    rng = np.random.default_rng(61)
    gp = {"Dense_0": {"bias": rng.uniform(-0.3, 0.3, (7,)).astype(np.float32),
                      "kernel": rng.uniform(-0.3, 0.3, (20, 7)).astype(np.float32)}}
    trees = [jax.tree_util.tree_map(lambda g: (g + rng.uniform(-0.1, 0.1, g.shape)).astype(
        np.float32), gp) for _ in keep]
    stack = jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)), *trees)
    mesh = jmesh.make_mesh(2, devices=jax.devices()[:2])
    axes = jmesh.client_axes(mesh)
    fn = jmesh.shard_map(lambda g, s, k: jfedavg.masked_mean_tree(g, s, k, axes, len(keep)),
                         mesh=mesh, in_specs=(P(), P(axes), P(axes)), out_specs=(P(), P()))
    want, jcount = fn(gp, stack, jnp.asarray(np.array(keep, bool)))
    want = convert.from_flax(jax.tree_util.tree_map(np.asarray, want))
    np_tree = lambda t: {k: v.numpy() for k, v in convert.from_flax(t).items()}  # noqa: E731
    got = world2.run(tasks.masked_mean, np_tree(gp), [np_tree(t) for t in trees],
                     [bool(k) for k in keep])
    for out, count in got:
        assert count == float(jcount) == sum(keep)
        for k in want:
            assert float(np.abs(out[k] - want[k].numpy()).max()) <= 1e-7, k
            np.testing.assert_array_equal(out[k], want[k].numpy())
        if not any(keep):
            assert all(np.array_equal(out[k], v) for k, v in np_tree(gp).items())


# ---- the sharded HE half on JAX-drawn samples vs the JAX round tail -----------


def _client_trees(num: int, seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"Conv_0": {"bias": (4,), "kernel": (3, 3, 2, 4)},
              "Dense_0": {"bias": (10,), "kernel": (500, 10)}}
    return [{layer: {leaf: rng.normal(0, 0.2, shape).astype(np.float32)
                     for leaf, shape in leaves.items()} for layer, leaves in shapes.items()}
            for _ in range(num)]


@pytest.fixture(scope="module")
def he_keys():
    jctx = jkeys.CkksContext.create(n=1024)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(51))
    return jctx, jsk, jpk


@pytest.mark.parametrize("num,keep", [(4, None), (6, None), (6, (1, 0, 1, 1, 0, 1))],
                         ids=["4_clients", "6_padded", "6_masked"])
def test_sharded_he_half_is_the_jax_round_tail_and_the_one_device_sum(world4, he_keys, num,
                                                                       keep):
    jctx, _, jpk = he_keys
    trees = _client_trees(num, 52 + num)
    n_ct = JPackSpec.for_params(trees[0], jctx.n).n_ct
    enc_keys = jax.random.split(jax.random.key(53), num)
    samples = [np.asarray(s).view(np.int32) for s in jax.jit(jax.vmap(
        lambda k: jops.encrypt_samples(jctx, k, (n_ct,))))(enc_keys)]
    keep = (1,) * num if keep is None else keep
    # JAX: the secure round body's tail on make_mesh(4), padded as it pads.
    mesh = jmesh.make_mesh(num, devices=jax.devices()[:4])
    pad = jfedavg.pad_index(num, 4)
    idx = np.arange(num) if pad is None else pad
    stack = jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)[idx]), *trees)
    jkeep = np.concatenate([np.asarray(keep, bool), np.zeros(len(idx) - num, bool)])
    p = jnp.asarray(jctx.ntt.p)

    def body(blk, ke_blk, keep_blk):
        cts = jsecure.encrypt_stack(jctx, jpk, blk, ke_blk)
        sel = keep_blk.reshape((-1, 1, 1, 1))
        cts = jops.Ciphertext(jnp.where(sel, cts.c0, jnp.uint32(0)),
                              jnp.where(sel, cts.c1, jnp.uint32(0)), cts.scale)
        local = jsecure.aggregate_encrypted(jctx, cts)
        return (jcoll.hierarchical_psum_mod(local.c0, p, ("clients",)),
                jcoll.hierarchical_psum_mod(local.c1, p, ("clients",)))

    fn = jmesh.shard_map(body, mesh=mesh, in_specs=(P("clients"),) * 3, out_specs=(P(), P()),
                         check_vma=False)
    want = [np.asarray(w) for w in jax.jit(fn)(stack, enc_keys[idx], jnp.asarray(jkeep))]
    # The port: each rank's block through encrypt_stack on the same samples.
    torch_trees = [{k: v.numpy() for k, v in convert.from_flax(t).items()} for t in trees]
    pk = tuple(np.asarray(a).view(np.int32) for a in (jpk.b_mont, jpk.a_mont))
    got = world4.run(tasks.he_half, torch_trees, tuple(samples), pk, 1024, list(keep))
    for r in range(4):
        np.testing.assert_array_equal(got[r]["c0"].view(np.uint32), want[0])
        np.testing.assert_array_equal(got[r]["c1"].view(np.uint32), want[1])
    # ... and the one-device sum of the kept clients.
    ctx = keys.CkksContext.create(n=1024)
    _, tpk = convert.keys_from_jax(*he_keys[1:])
    ct = secure.encrypt_stack(ctx, tpk, [convert.from_flax(t) for t in trees],
                              samples=tuple(torch.from_numpy(s) for s in samples))
    one = secure.aggregate_encrypted(ctx, secure.zero_excluded(ct, torch.tensor(keep, dtype=bool)))
    np.testing.assert_array_equal(one.c0.numpy(), got[0]["c0"])
    np.testing.assert_array_equal(one.c1.numpy(), got[0]["c1"])


# ---- certificates and the exact-integer lint -----------------------------------


def test_psum_legs_are_the_jax_certificate_string_for_string(jax_x64):
    got, want = ranges.certify_aggregation(P27), jranges.certify_aggregation(P27)
    legs = ("psum_mod[32 participants]", "psum_mod 2-D[32 clients x 32 ct]")
    mine = [c for c in got.checks if c.startswith(legs)]
    assert len(mine) == 2 and mine == [c for c in want.checks if c.startswith(legs)]
    assert got.summary() == want.summary()


def test_all_reduce_rule_scales_by_the_declared_group_size():
    from hefl_tpu_torch.parallel import collectives

    fn, args = collectives.psum_range_probe(P27)
    with collectives.tracing_group() as group:
        gm = ranges.trace_graph(fn, args)
        name = group.group_name
    canon = ranges.Interval(0, P27 - 1)
    res = ranges.eval_graph_ranges(gm, [canon], axis_sizes={name: 32})
    assert res.out_intervals[0] == ranges.Interval(0, 32 * (P27 - 1)) and not res.findings
    assert res.out_ops == ["psum"]
    wide = ranges.eval_graph_ranges(gm, [ranges.Interval(0, 2**62)], axis_sizes={name: 4})
    assert [f.op for f in wide.findings] == ["psum"]          # wraps int64
    blind = ranges.eval_graph_ranges(gm, [canon])
    assert blind.out_intervals[0] == ranges.TOP and any("undeclared size" in n
                                                       for n in blind.notes)
    assert not torch.distributed.is_initialized()     # the tracing group is gone


def test_psum_regions_pass_the_exact_integer_lint():
    regions = lint.exact_int_regions("cpu")
    assert lint.UNPORTED_REGIONS == {}
    for name in ("parallel.collectives.psum_mod", "parallel.collectives.psum_mod_2d"):
        fn, args = regions[name]
        assert lint.lint_fn(fn, args, name, exact_int=True) == []
        np.testing.assert_array_equal(fn(*args).numpy(), args[0].numpy())
