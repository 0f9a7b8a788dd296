"""The port's encrypted FedAvg round, its CLI and its package boundary.

The HE half of a round (encrypt_stack -> lazy_sum_mod -> decrypt) is held
BITWISE against the JAX package on the same per-client weights, keys and
encryption samples; the decoded average within 1 float32 ulp. So is the
masked half (poison -> exclusion bits -> encrypt -> zero the excluded rows
-> lazy_sum_mod -> decrypt_average(meta=)), NaN and saturated rows included,
and `masked_mean_tree` within 1e-7. A whole round on the CPU is held against
its own in-program plaintext mean with the repo's 5e-6 encrypted-average
yardstick, masked and with DP too; a clean schedule is the unmasked round
bit for bit.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.ckks import encoding as jencoding
from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import ops as jops
from hefl_tpu.ckks.packing import PackSpec as JPackSpec
from hefl_tpu.ckks.packing import pack_pytree as jpack_pytree
from hefl_tpu.fl import config as jconfig
from hefl_tpu.fl import faults as jfaults
from hefl_tpu.fl import fedavg as jfedavg
from hefl_tpu.fl import secure as jsecure
from hefl_tpu.parallel import client_axes, make_mesh, shard_map

import hefl_tpu_torch
from hefl_tpu_torch import cli, convert
from hefl_tpu_torch.ckks import keys, ops
from hefl_tpu_torch.ckks.packing import PackSpec
from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
from hefl_tpu_torch.data.synthetic import make_dataset
from hefl_tpu_torch.fl import faults, fedavg, secure
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.fl.dp import DpConfig
from hefl_tpu_torch.models import create_model

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _client_trees(num_clients: int, seed: int):
    """Small flax-layout weight trees, one per client (3 rows at N=4096)."""
    rng = np.random.default_rng(seed)
    shapes = {"Conv_0": {"bias": (4,), "kernel": (3, 3, 2, 4)},
              "Dense_0": {"bias": (10,), "kernel": (1000, 10)}}
    return [
        {layer: {leaf: rng.normal(0, 0.2, shape).astype(np.float32)
                 for leaf, shape in leaves.items()}
         for layer, leaves in shapes.items()}
        for _ in range(num_clients)
    ]


@pytest.fixture(scope="module")
def he_half():
    """Both packages' HE half of a 2-client round on the same inputs."""
    jctx, tctx = jkeys.CkksContext.create(), keys.CkksContext.create()
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(41))
    trees = _client_trees(2, 42)
    jstack = jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)), *trees)
    enc_keys = jax.random.split(jax.random.key(43), 2)
    n_ct = JPackSpec.for_params(trees[0], jctx.n).n_ct
    samples = jax.jit(jax.vmap(lambda k: jops.encrypt_samples(jctx, k, (n_ct,))))(enc_keys)

    def j_round(jstack, jpk, enc_keys, jsk):
        ct = jsecure.encrypt_stack(jctx, jpk, jstack, enc_keys)
        p = jnp.asarray(jctx.ntt.p)
        ct_sum = jops.Ciphertext(jsecure._lazy_sum_mod(ct.c0, p),
                                 jsecure._lazy_sum_mod(ct.c1, p), ct.scale)
        return ct, ct_sum, jops.decrypt(jctx, jsk, ct_sum)

    jct, jsum, jres = jax.jit(j_round)(jstack, jpk, enc_keys, jsk)
    javg = jsecure.decrypt_average(jctx, jsk, jsum, 2, JPackSpec.for_params(trees[0], jctx.n))

    sk, pk = convert.keys_from_jax(jsk, jpk)
    p_out = [convert.from_flax(t) for t in trees]
    ct = secure.encrypt_stack(tctx, pk, p_out, samples=tuple(_t(s) for s in samples))
    ct_sum = secure.aggregate_encrypted(tctx, ct)
    res = ops.decrypt(tctx, sk, ct_sum)
    avg = secure.decrypt_average(tctx, sk, ct_sum, 2, PackSpec.for_params(p_out[0], tctx.n))
    return dict(jct=jct, jsum=jsum, jres=jres, javg=javg, ct=ct, ct_sum=ct_sum, res=res,
                avg=avg, trees=trees)


@pytest.mark.parametrize("stage", ["encrypt_stack", "lazy_sum_mod", "decrypt"])
def test_he_half_of_round_bitwise_equal_jax(he_half, stage):
    # Bitwise: every stage outputs canonical residues mod p.
    h = he_half
    if stage == "encrypt_stack":
        assert tuple(h["ct"].c0.shape) == (2, 3, 3, 4096)
        pairs = [(h["ct"].c0, h["jct"].c0), (h["ct"].c1, h["jct"].c1)]
    elif stage == "lazy_sum_mod":
        pairs = [(h["ct_sum"].c0, h["jsum"].c0), (h["ct_sum"].c1, h["jsum"].c1)]
    else:
        pairs = [(h["res"], h["jres"])]
    for got, want in pairs:
        np.testing.assert_array_equal(_u(got), np.asarray(want))


def test_decrypt_average_matches_jax_and_plain_mean(he_half):
    # Within 1 float32 ulp of the JAX decode (same digits, float32
    # recombination may round differently), and within the 5e-6
    # encrypted-average yardstick of the plaintext mean.
    h = he_half
    got = convert.to_flax(h["avg"])
    for layer, leaves in h["javg"].items():
        for leaf, want in leaves.items():
            want = np.asarray(want)
            ulp = np.spacing(np.abs(want).astype(np.float32))
            assert np.all(np.abs(got[layer][leaf] - want) <= ulp), (layer, leaf)
            mean = (h["trees"][0][layer][leaf] + h["trees"][1][layer][leaf]) / 2
            assert np.max(np.abs(got[layer][leaf] - mean)) <= 5e-6


def test_lazy_sum_mod_many_clients_no_int32_overflow():
    # 40 summands near 2**27 overflow int32; the int64 sum must not.
    p = torch.tensor([[134215681]], dtype=torch.int64)
    x = torch.full((40, 1, 8), 134215680, dtype=torch.int32)
    got = secure.lazy_sum_mod(x, p)
    assert got.dtype == torch.int32
    assert torch.all(got == (40 * 134215680) % 134215681)


def test_whole_round_decrypts_within_yardstick_of_plain_mean():
    # SmallCNN, ring n=256, 2 clients, 1 epoch on the CPU: the decrypted
    # average sits within 5e-6 of the same program's plaintext mean (the
    # repo's encrypted-average yardstick: encode quantum plus RLWE noise).
    (x, y), (xt, yt), _ = make_dataset("mnist", seed=3, n_train=48, n_test=8)
    xs, ys = stack_federated(x, y, iid_contiguous(len(y), 2))
    gen = torch.Generator().manual_seed(4)
    model = create_model("smallcnn", gen=gen, device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=256)
    sk, pk = keys.keygen(ctx, gen, device="cpu")
    ct_sum, mets, overflow, ref = secure.secure_fedavg_round(
        model, TrainConfig(epochs=1, batch_size=8, num_classes=10), ctx, pk, params,
        torch.from_numpy(xs), torch.from_numpy(ys), gen, with_plain_reference=True,
    )
    spec = PackSpec.for_params(params, ctx.n)
    assert tuple(ct_sum.c0.shape) == (spec.n_ct, 3, 256)
    assert tuple(mets.shape) == (2, 1, 4) and int(overflow.sum()) == 0
    avg = secure.decrypt_average(ctx, sk, ct_sum, 2, spec)
    assert avg.keys() == ref.keys()
    assert max((avg[k] - ref[k]).abs().max().item() for k in ref) <= 5e-6
    moved = max((ref[k] - params[k]).abs().max().item() for k in ref)
    assert moved > 1e-4                     # training really changed the weights


# --- the masked round ----------------------------------------------------------------

# Six clients around one global model: clean, NaN-poisoned, +1e15-poisoned,
# scheduled out, and two clean; the sanitizing knobs on (update norms ~1,
# far below the bound of 50).
MASK = np.array([1, 1, 1, 0, 1, 1], np.int32)
CODES = np.array([0, 1, 2, 0, 0, 0], np.int32)
MASKED_KW = dict(max_update_norm=50.0, on_overflow="exclude")


@pytest.fixture(scope="module")
def masked_half():
    """Both packages' masked HE half on the same weights, keys and samples."""
    jctx, tctx = jkeys.CkksContext.create(n=1024), keys.CkksContext.create(n=1024)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(51))
    rng = np.random.default_rng(52)
    shapes = {"Conv_0": {"bias": (4,), "kernel": (3, 3, 2, 4)},
              "Dense_0": {"bias": (10,), "kernel": (300, 10)}}
    gp = {layer: {leaf: rng.normal(0, 0.2, shape).astype(np.float32)
                  for leaf, shape in leaves.items()} for layer, leaves in shapes.items()}
    trees = [jax.tree_util.tree_map(lambda g: (g + rng.normal(0, 0.01, g.shape)).astype(
        np.float32), gp) for _ in MASK]
    jstack = jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)), *trees)
    enc_keys = jax.random.split(jax.random.key(53), len(MASK))
    jspec = JPackSpec.for_params(gp, jctx.n)
    samples = jax.jit(jax.vmap(lambda k: jops.encrypt_samples(jctx, k, (jspec.n_ct,))))(enc_keys)
    jcfg = jconfig.TrainConfig(**MASKED_KW)

    def j_half(jstack, jpk, enc_keys):
        p_out = jax.vmap(jfaults.poison_tree)(jstack, jnp.asarray(CODES))
        overflow = jax.vmap(lambda prm: jencoding.encode_overflow_count(
            jpack_pytree(prm, jctx.n), jctx.scale))(p_out)
        bits = jfaults.exclusion_bits(jcfg, gp, p_out, jnp.asarray(MASK), overflow)
        ct = jsecure.encrypt_stack(jctx, jpk, p_out, enc_keys)
        sel = (bits == 0).reshape((-1, 1, 1, 1))
        p = jnp.asarray(jctx.ntt.p)
        ct_sum = jops.Ciphertext(
            jsecure._lazy_sum_mod(jnp.where(sel, ct.c0, jnp.uint32(0)), p),
            jsecure._lazy_sum_mod(jnp.where(sel, ct.c1, jnp.uint32(0)), p), ct.scale)
        return overflow, bits, ct, ct_sum

    joverflow, jbits, jct, jsum = jax.jit(j_half)(jstack, jpk, enc_keys)
    jmeta = jfaults.RoundMeta.from_bits(np.asarray(jbits))
    javg = jsecure.decrypt_average(jctx, jsk, jsum, len(MASK), jspec, meta=jmeta)

    sk, pk = convert.keys_from_jax(jsk, jpk)
    tgp = convert.from_flax(gp)
    p_out = [faults.poison_tree(convert.from_flax(t), int(c)) for t, c in zip(trees, CODES)]
    overflow = torch.stack([secure.encoding.encode_overflow_count(
        secure.pack_params(prm, tctx.n), tctx.scale) for prm in p_out])
    bits = faults.exclusion_bits(TrainConfig(**MASKED_KW), tgp, p_out, MASK, overflow)
    ct = secure.encrypt_stack(tctx, pk, p_out, samples=tuple(_t(s) for s in samples))
    ct_sum = secure.aggregate_encrypted(tctx, secure.zero_excluded(ct, bits == 0))
    meta = faults.RoundMeta.from_bits(bits)
    avg = secure.decrypt_average(tctx, sk, ct_sum, len(MASK), PackSpec.for_params(tgp, tctx.n),
                                 meta=meta)
    return dict(joverflow=joverflow, jbits=jbits, jct=jct, jsum=jsum, jmeta=jmeta, javg=javg,
                overflow=overflow, bits=bits, ct=ct, ct_sum=ct_sum, meta=meta, avg=avg,
                trees=trees)


@pytest.mark.parametrize("stage", ["overflow_and_bits", "encrypt_stack", "lazy_sum_mod",
                                   "decrypt_average"])
def test_masked_he_half_bitwise_equal_jax(masked_half, stage):
    h = masked_half
    if stage == "overflow_and_bits":
        np.testing.assert_array_equal(h["overflow"].numpy(), np.asarray(h["joverflow"]))
        np.testing.assert_array_equal(h["bits"].numpy(), np.asarray(h["jbits"]))
        assert h["meta"].record() == h["jmeta"].record() and h["meta"].bits == h["jmeta"].bits
        assert h["meta"].surviving == 3
        assert h["meta"].excluded["nonfinite"] == 1 and h["meta"].excluded["norm"] == 1
        assert h["meta"].excluded["overflow"] == 1 and h["meta"].excluded["scheduled"] == 1
    elif stage == "encrypt_stack":
        # Every client's rows, the NaN client's (encoded to 0) and the
        # saturated client's included.
        for got, want in ((h["ct"].c0, h["jct"].c0), (h["ct"].c1, h["jct"].c1)):
            np.testing.assert_array_equal(_u(got), np.asarray(want))
    elif stage == "lazy_sum_mod":
        for got, want in ((h["ct_sum"].c0, h["jsum"].c0), (h["ct_sum"].c1, h["jsum"].c1)):
            np.testing.assert_array_equal(_u(got), np.asarray(want))
    else:
        # Within 1 float32 ulp of the JAX decode, and within 5e-6 of the
        # kept clients' plaintext mean.
        got = convert.to_flax(h["avg"])
        kept = [t for t, b in zip(h["trees"], np.asarray(h["jbits"])) if b == 0]
        for layer, leaves in h["javg"].items():
            for leaf, want in leaves.items():
                want = np.asarray(want)
                ulp = np.spacing(np.abs(want).astype(np.float32))
                assert np.all(np.abs(got[layer][leaf] - want) <= ulp), (layer, leaf)
                mean = np.mean([t[layer][leaf] for t in kept], axis=0)
                assert np.max(np.abs(got[layer][leaf] - mean)) <= 5e-6


@pytest.mark.parametrize("keep", [[1, 0, 1, 1, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]])
def test_masked_mean_tree_matches_jax(keep):
    from jax.sharding import PartitionSpec as P

    # Weights of a trained model's size (|w| < 0.5, where a float32 ulp is
    # at most 6e-8): the two packages sum the clients in different orders.
    rng = np.random.default_rng(60)
    gp = {"Dense_0": {"bias": rng.uniform(-0.3, 0.3, (7,)).astype(np.float32),
                      "kernel": rng.uniform(-0.3, 0.3, (20, 7)).astype(np.float32)}}
    trees = [jax.tree_util.tree_map(lambda g: (g + rng.uniform(-0.1, 0.1, g.shape)).astype(
        np.float32), gp) for _ in keep]
    stack = jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)), *trees)
    mesh = make_mesh(1)
    axes = client_axes(mesh)
    fn = shard_map(lambda g, p, k: jfedavg.masked_mean_tree(g, p, k, axes, len(keep)),
                   mesh=mesh, in_specs=(P(), P(axes), P(axes)), out_specs=(P(), P()))
    want, jcount = fn(gp, stack, jnp.asarray(np.array(keep, bool)))
    got, count = fedavg.masked_mean_tree(convert.from_flax(gp),
                                         [convert.from_flax(t) for t in trees],
                                         torch.tensor(keep, dtype=torch.bool), len(keep))
    assert float(count) == float(jcount) == sum(keep)
    want = convert.from_flax(jax.tree_util.tree_map(np.asarray, want))
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= 1e-7, k
    if not any(keep):
        assert all(torch.equal(got[k], convert.from_flax(gp)[k]) for k in got)
    if all(keep):      # all kept: bitwise the unmasked mean
        plain = fedavg.plain_mean([convert.from_flax(t) for t in trees])
        assert all(torch.equal(got[k], plain[k]) for k in got)


@pytest.fixture(scope="module")
def small_round():
    (x, y), _, _ = make_dataset("mnist", seed=3, n_train=96, n_test=8)
    xs, ys = stack_federated(x, y, iid_contiguous(len(y), 4))
    model = create_model("smallcnn", gen=torch.Generator().manual_seed(4), device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=256)
    sk, pk = keys.keygen(ctx, torch.Generator().manual_seed(5), device="cpu")
    return model, params, ctx, sk, pk, torch.from_numpy(xs), torch.from_numpy(ys)


ROUND_CFG = dict(epochs=1, batch_size=8, num_classes=10, augment=False, val_fraction=0.25)


@pytest.mark.parametrize("with_dp", [False, True])
def test_masked_round_decrypts_within_yardstick_of_its_masked_mean(small_round, with_dp):
    # 4 clients: one scheduled out, one NaN-poisoned; the sanitizing knobs
    # on. With DP each client's share is calibrated to the 2 survivors.
    # (A DP round takes no norm bound: the noise alone has norm ~sigma*C/sqrt(2)
    # * sqrt(225,034) >> 50.)
    model, params, ctx, sk, pk, xs, ys = small_round
    cfg = TrainConfig(**ROUND_CFG, **(dict(on_overflow="exclude") if with_dp else MASKED_KW))
    dp = DpConfig(clip_norm=1.0, noise_multiplier=1.0, min_surviving=2) if with_dp else None
    ct_sum, mets, overflow, meta, ref = secure.secure_fedavg_round(
        model, cfg, ctx, pk, params, xs, ys, torch.Generator().manual_seed(6),
        with_plain_reference=True, dp=dp, participation=[1, 1, 0, 1], poison=[0, 1, 0, 0])
    assert meta.bits == (0, faults.EXCLUDED_NONFINITE, faults.EXCLUDED_SCHEDULED, 0)
    assert meta.surviving == 2 and meta.sanitized
    assert overflow.tolist() == [0, 0, 0, 0] and tuple(mets.shape) == (4, 1, 4)
    avg = secure.decrypt_average(ctx, sk, ct_sum, 4, PackSpec.for_params(params, ctx.n),
                                 meta=meta)
    assert max((avg[k] - ref[k]).abs().max().item() for k in ref) <= 5e-6
    assert all(torch.isfinite(v).all() for v in avg.values())
    moved = max((ref[k] - params[k]).abs().max().item() for k in ref)
    assert moved > (0.1 if with_dp else 1e-4)      # DP noise moves the weights far more


def test_dp_round_below_its_floor_raises(small_round):
    model, params, ctx, _, pk, xs, ys = small_round
    with pytest.raises(ValueError, match="below the declared noise-calibration floor 4 of 4"):
        secure.secure_fedavg_round(
            model, TrainConfig(**ROUND_CFG), ctx, pk, params, xs, ys,
            torch.Generator().manual_seed(6), dp=DpConfig(), participation=[1, 1, 0, 1])


def test_clean_schedule_is_the_unmasked_round_bitwise(small_round):
    model, params, ctx, _, pk, xs, ys = small_round
    cfg = TrainConfig(**ROUND_CFG)
    want = secure.secure_fedavg_round(model, cfg, ctx, pk, params, xs, ys,
                                      torch.Generator().manual_seed(7))
    got = secure.secure_fedavg_round(model, cfg, ctx, pk, params, xs, ys,
                                     torch.Generator().manual_seed(7),
                                     participation=[1, 1, 1, 1], poison=[0, 0, 0, 0])
    assert len(want) == 3 and len(got) == 4
    assert got[3] == faults.RoundMeta.full_participation(4) and not got[3].sanitized
    assert torch.equal(got[0].c0, want[0].c0) and torch.equal(got[0].c1, want[0].c1)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_cli_runs_end_to_end_on_cpu():
    cmd = [sys.executable, "-m", "hefl_tpu_torch.cli", "--model", "smallcnn",
           "--dataset", "mnist", "--num-clients", "2", "--epochs", "1",
           "--n-train", "40", "--n-test", "8", "--he-n", "1024", "--no-augment",
           "--json", "--no-save-model", "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["round"] == 0 and rec["encode_overflow"] == [0, 0]
    assert 0.0 <= rec["accuracy"] <= 1.0 and len(rec["val_loss"]) == 2


@pytest.mark.parametrize("argv,want", [
    (["--data-dir=images"], dict(data_dir="images", image_size=(256, 256))),
    (["--data-dir", "x", "--image-size", "64"], dict(data_dir="x", image_size=(64, 64))),
    (["--image-size=32"], dict(data_dir=None, image_size=(32, 32))),
    (["--mesh-ct=2"], dict(mesh_ct=2)),
    ([], dict(data_dir=None, image_size=(256, 256), mesh_ct=0)),
], ids=["data_dir_default_size", "data_dir_size", "size_alone", "mesh_ct", "defaults"])
def test_cli_parses_the_folder_and_mesh_flags(argv, want):
    cfg = cli.config_from_args(cli.parse_args(["--device", "cpu", *argv]))
    assert {k: getattr(cfg, k) for k in want} == want


def test_cli_flags_cover_the_jax_cli():
    # The port's flags are exactly hefl_tpu.cli's (same defaults) plus
    # --device.
    from hefl_tpu.cli import build_parser as jax_parser

    def defaults(parser):
        return {o: a.default for a in parser._actions for o in a.option_strings
                if o.startswith("--")}

    jflags, tflags = defaults(jax_parser()), defaults(cli.build_parser())
    assert set(tflags) - set(jflags) == {"--device"}
    assert set(jflags) - set(tflags) == set()
    assert all(tflags[f] == jflags[f] for f in tflags if f in jflags)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("root", ["hefl_tpu_torch", "chip_smoke.py"])
def test_port_imports_no_jax_flax_or_hefl_tpu(root):
    files = sorted((REPO / root).rglob("*.py")) if root == "hefl_tpu_torch" else [REPO / root]
    assert files
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "hefl_tpu"):
                bad.append((path.relative_to(REPO).as_posix(), mod))
    assert not bad, bad


def test_entry_points_raise_without_cuda_or_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = keys.CkksContext.create(n=256)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hefl_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError):
        create_model("smallcnn")
    with pytest.raises(RuntimeError):
        keys.keygen(ctx, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        cli.run(cli.parse_args(["--model", "smallcnn", "--dataset", "mnist",
                                "--n-train", "8", "--n-test", "4"]))
    assert hefl_tpu_torch.resolve_device("cpu") == torch.device("cpu")
