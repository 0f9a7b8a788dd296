"""The port's hybrid-HE uplink against the JAX package.

The stream cipher (keystream words, mod-2**62 add/sub, center-mod, keys),
the transcipher's plain version (against the XLA reference and the Pallas
kernel in interpret mode), pad provisioning on the JAX package's samples,
the online fold, and the whole HHE stack -> fold -> decrypt are held
BITWISE against the JAX package. The port's own streaming round is held
bitwise against its direct packed round, and its certificates, engine and
CLI refuse what they do not run, by name.
"""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.ckks import encoding as jenc
from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import ops as jops
from hefl_tpu.ckks import pallas_ntt
from hefl_tpu.ckks import quantize as jq
from hefl_tpu.fl import secure as jsecure
from hefl_tpu.fl.stream import OnlineAccumulator as JOnlineAccumulator
from hefl_tpu.hhe import cipher as jcipher
from hefl_tpu.hhe import transcipher as jtc

from hefl_tpu_torch import cli, convert
from hefl_tpu_torch.analysis import ranges
from hefl_tpu_torch.ckks import encoding, keys, ops, packing, quantize
from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
from hefl_tpu_torch.data.synthetic import make_dataset
from hefl_tpu_torch.fl import secure, stream
from hefl_tpu_torch.fl.config import HheConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.hhe import cipher, transcipher
from hefl_tpu_torch.models import create_model

from test_torch_packing import _client_trees, _t, _tree, _u, jax_spec

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _field_sha(v, spec) -> str:
    """sha256 of the decoded integer field sums (guard band shifted away)."""
    fields = quantize.deinterleave_fields(np.asarray(v), spec.k, spec.field_bits, spec.guard)
    return hashlib.sha256(np.ascontiguousarray(fields.astype(np.int64)).tobytes()).hexdigest()


# --- the cipher -----------------------------------------------------------------


def test_derive_client_keys_equal_jax():
    for seed, c in ((0, 3), (7, 8), (2**31, 2)):
        np.testing.assert_array_equal(cipher.derive_client_keys(seed, c),
                                      jcipher.derive_client_keys(seed, c))


@pytest.mark.parametrize("round_index", [0, 1, 3, 2**31 + 5, 2**32 - 1])
@pytest.mark.parametrize("shape", [(2, 64), (1, 1024), (3, 256)])
def test_keystream_pair_bitwise_vs_jax(round_index, shape):
    for key in cipher.derive_client_keys(round_index % 5, 3):
        jhi, jlo = jcipher.keystream_pair(jnp.asarray(key), jnp.uint32(round_index), shape)
        hi, lo = cipher.keystream_pair(key, round_index, shape)
        assert hi.dtype == torch.int32 and tuple(hi.shape) == shape
        np.testing.assert_array_equal(_u(hi), np.asarray(jhi))
        np.testing.assert_array_equal(_u(lo), np.asarray(jlo))


def test_keystream_round_counter_wraps_mod_2_32():
    key = cipher.derive_client_keys(0, 1)[0]
    for a, b in zip(cipher.keystream_pair(key, 2**32 + 9, (1, 64)),
                    cipher.keystream_pair(key, 9, (1, 64))):
        assert torch.equal(a, b)


def _words(rng, shape):
    return rng.integers(0, 2**31, shape).astype(np.uint32)


def test_add_sub_packed_mod_bitwise_vs_jax():
    rng = np.random.default_rng(1)
    a_hi, a_lo, b_hi, b_lo = (_words(rng, (4, 512)) for _ in range(4))
    a_lo[0, :4] = b_lo[0, :4] = 2**31 - 1        # carries and borrows at the edges
    a_hi[0, :4], b_hi[0, :4] = 2**31 - 1, 1
    for fn, jfn in ((cipher.add_packed_mod, jcipher.add_packed_mod),
                    (cipher.sub_packed_mod, jcipher.sub_packed_mod)):
        got = fn(*(_t(x) for x in (a_hi, a_lo, b_hi, b_lo)))
        want = jfn(*(jnp.asarray(x) for x in (a_hi, a_lo, b_hi, b_lo)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_u(g), np.asarray(w))


def test_stream_encrypt_round_trips_and_equals_jax():
    rng = np.random.default_rng(2)
    hi, lo = _words(rng, (3, 256)), _words(rng, (3, 256))
    key = cipher.derive_client_keys(4, 2)[1]
    w_hi, w_lo = cipher.stream_encrypt(_t(hi), _t(lo), key, 17)
    jw = jcipher.stream_encrypt(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(key), jnp.uint32(17))
    np.testing.assert_array_equal(_u(w_hi), np.asarray(jw[0]))
    np.testing.assert_array_equal(_u(w_lo), np.asarray(jw[1]))
    back = cipher.stream_decrypt(w_hi, w_lo, key, 17)
    np.testing.assert_array_equal(_u(back[0]), hi)
    np.testing.assert_array_equal(_u(back[1]), lo)
    assert not np.array_equal(_u(w_hi), hi)


def test_hhe_center_mod_equal_jax():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 2**60, 1000, dtype=np.int64) + rng.integers(-2**17, 2**17, 1000)
    wrapped = v - (np.int64(1) << 62) * rng.integers(0, 9, 1000)
    got = cipher.hhe_center_mod(wrapped, 19)
    np.testing.assert_array_equal(got, jcipher.hhe_center_mod(wrapped, 19))
    np.testing.assert_array_equal(got, v)


def test_hhe_wire_record_equal_jax():
    jctx, tctx = jkeys.CkksContext.create(n=256), keys.CkksContext.create(n=256)
    base = _tree(np.random.default_rng(4))
    for k in (1, 4):
        spec = packing.PackedSpec.for_params(
            convert.from_flax(base), tctx, quantize.PackingConfig(bits=8, interleave=k, clip=0.25), 3)
        jspec = jax_spec(base, jctx, jq.PackingConfig(bits=8, interleave=k, clip=0.25), 3)
        rec = cipher.hhe_bytes_on_wire_record(spec, 3)
        assert rec == jcipher.hhe_bytes_on_wire_record(jspec, 3)
        assert rec["expansion_hhe"] <= 1.1 and rec["hhe_upload"] == cipher.sym_wire_bytes(spec)


# --- the transcipher and the pads -----------------------------------------------


@pytest.fixture(scope="module")
def ring1024():
    jctx, tctx = jkeys.CkksContext.create(n=1024), keys.CkksContext.create(n=1024)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(3))
    sk, pk = convert.keys_from_jax(jsk, jpk)
    return jctx, tctx, jpk, pk


def _jax_samples(jctx, enc_keys, n_ct):
    return jax.vmap(lambda k: jops.encrypt_samples(jctx, k, (n_ct,)))(enc_keys)


def test_transcipher_plain_bitwise_vs_xla_and_pallas_interpret(ring1024):
    # K7's plain version on pads from the JAX package's provision_pads, at
    # n=1024: bitwise the XLA reference and the interpret-mode Pallas kernel.
    jctx, tctx, jpk, _ = ring1024
    keys_c = jnp.asarray(jcipher.derive_client_keys(0, 2))
    rng = np.random.default_rng(0)
    w_hi, w_lo = _words(rng, (2, 3, 1024)), _words(rng, (2, 3, 1024))
    enc_keys = jax.random.split(jax.random.key(1), 2)
    pad = jtc.provision_pads(jctx, jpk, keys_c, jnp.uint32(5), enc_keys, 3)
    c0_x, c1_x = jtc._transcipher_core_xla(jctx.ntt, jnp.asarray(w_hi), jnp.asarray(w_lo),
                                           pad.c0, pad.c1)
    c0_p, c1_p = pallas_ntt.transcipher_fused_pallas(
        jctx.ntt, jnp.asarray(w_hi), jnp.asarray(w_lo), pad.c0, pad.c1, interpret=True)
    c0, c1 = transcipher.transcipher_core(tctx, _t(w_hi), _t(w_lo), _t(pad.c0), _t(pad.c1))
    for got, xla, pal in ((c0, c0_x, c0_p), (c1, c1_x, c1_p)):
        np.testing.assert_array_equal(_u(got), np.asarray(xla))
        np.testing.assert_array_equal(_u(got), np.asarray(pal))


@pytest.mark.parametrize("n_ct,round_index", [(3, 5), (3, 2**32 - 1)])
def test_provision_pads_bitwise_vs_jax(ring1024, n_ct, round_index):
    # Fed the JAX package's (u, e0, e1), the port's pads are the JAX pads.
    jctx, tctx, jpk, pk = ring1024
    keys_c = jcipher.derive_client_keys(3, 2)
    enc_keys = jax.random.split(jax.random.key(8), 2)
    want = jtc.provision_pads(jctx, jpk, jnp.asarray(keys_c), jnp.uint32(round_index),
                              enc_keys, n_ct)
    samples = tuple(_t(s) for s in _jax_samples(jctx, enc_keys, n_ct))
    got = transcipher.provision_pads(tctx, pk, keys_c, round_index, n_ct, samples=samples)
    assert tuple(got.c0.shape) == (2, n_ct, 3, 1024)
    np.testing.assert_array_equal(_u(got.c0), np.asarray(want.c0))
    np.testing.assert_array_equal(_u(got.c1), np.asarray(want.c1))


def test_online_accumulator_bitwise_vs_jax_any_order():
    ctx = keys.CkksContext.create(n=256)
    p = np.asarray(ctx.ntt.p).astype(np.int64)
    rng = np.random.default_rng(6)
    rows = (rng.integers(0, 2**40, (5, 2, 3, 256)) % p).astype(np.uint32)
    rows1 = (rng.integers(0, 2**40, (5, 2, 3, 256)) % p).astype(np.uint32)
    jacc = JOnlineAccumulator(ctx.ntt.p)
    for c in range(5):
        jacc.fold((c, 0), rows[c], rows1[c])
    want = jacc.value()
    for trial in range(3):
        acc = stream.OnlineAccumulator(ctx.ntt.p)
        for c in rng.permutation(5):
            assert acc.fold((int(c), 0), _t(rows[c]), _t(rows1[c]))
            assert not acc.fold((int(c), 0), _t(rows[c]), _t(rows1[c]))   # idempotent
        assert acc.folded == 5 and acc.duplicates == 5
        for g, w in zip(acc.value(), want):
            np.testing.assert_array_equal(_u(g), w)
    batch = stream.OnlineAccumulator(ctx.ntt.p)
    assert batch.fold_batch([(0, 0), (1, 0), (0, 0)], _t(rows[:3]), _t(rows1[:3])) == 2
    assert batch.fold_batch([(1, 0), (2, 0), (3, 0), (4, 0)], _t(rows[1:]), _t(rows1[1:])) == 3
    for g, w in zip(batch.value(), want):
        np.testing.assert_array_equal(_u(g), w)
    z0, z1 = stream.OnlineAccumulator(ctx.ntt.p).value(like_shape=(2, 3, 256))
    assert z0.dtype == torch.int32 and not z0.any() and not z1.any()


# --- the HHE stack against the JAX package ------------------------------------------


@pytest.fixture(scope="module")
def hhe_stacks():
    """Both packages' HHE stack (symmetric encrypt -> provision + transcipher
    -> fold in a permuted order with a duplicate -> decrypt) and the direct
    packed stack on the same weights, keys and samples, at n=256, C=3, k=4."""
    jctx, tctx = jkeys.CkksContext.create(n=256), keys.CkksContext.create(n=256)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(21))
    sk, pk = convert.keys_from_jax(jsk, jpk)
    base = _tree(np.random.default_rng(22))
    trees = _client_trees(base, 3, 23, huge=2)
    jspec = jax_spec(base, jctx, jq.PackingConfig(bits=8, interleave=4, clip=0.25), 3)
    spec = packing.PackedSpec.for_params(
        convert.from_flax(base), tctx, quantize.PackingConfig(bits=8, interleave=4, clip=0.25), 3)
    keys_c = cipher.derive_client_keys(0, 3)
    enc_keys = jax.random.split(jax.random.key(24), 3)
    samples = _jax_samples(jctx, enc_keys, jspec.n_ct)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)), *trees)

    jw_hi, jw_lo, jsat = jsecure.hhe_encrypt_stack(stacked, base, jnp.asarray(keys_c),
                                                   jnp.uint32(3), jspec)
    jtcb, _ = jtc.transcipher_batch(jctx, jspec, jpk, jw_hi, jw_lo, keys_c, 3, enc_keys)
    jacc = JOnlineAccumulator(jctx.ntt.p)
    for c in (2, 0, 1):
        jacc.fold((c, 0), np.asarray(jtcb.c0)[c], np.asarray(jtcb.c1)[c])
    js0, js1 = jacc.value()
    jsum = jops.Ciphertext(c0=jnp.asarray(js0), c1=jnp.asarray(js1), scale=jspec.guard_scale)
    jv = jcipher.hhe_center_mod(jenc.decode_int_center(jctx.ntt, jops.decrypt(jctx, jsk, jsum)),
                                jspec.guard)
    javg = jsecure.decrypt_average(jctx, jsk, jsum, 3, packing=jspec, base_params=base, hhe=True)

    p_out = [convert.from_flax(t) for t in trees]
    tbase = convert.from_flax(base)
    w_hi, w_lo, sat = secure.hhe_encrypt_stack(p_out, tbase, keys_c, 3, spec)
    tcb, pad = transcipher.transcipher_batch(tctx, spec, pk, w_hi, w_lo, keys_c, 3,
                                             samples=tuple(_t(s) for s in samples))
    acc = stream.OnlineAccumulator(tctx.ntt.p)
    for c in (1, 2, 1, 0):                     # a permuted order, one redelivery
        acc.fold((c, 0), tcb.c0[c], tcb.c1[c])
    s0, s1 = acc.value()
    hsum = ops.Ciphertext(c0=s0, c1=s1, scale=spec.guard_scale)
    v = cipher.hhe_center_mod(encoding.decode_int_center(tctx.ntt, ops.decrypt(tctx, sk, hsum)),
                              spec.guard)
    avg = secure.decrypt_average(tctx, sk, hsum, 3, packing=spec, base_params=tbase, hhe=True)

    direct, dsat = secure.encrypt_stack_packed(tctx, pk, p_out, tbase, None, spec,
                                               samples=tuple(_t(s) for s in samples))
    dsum = secure.aggregate_encrypted(tctx, direct)
    dv = encoding.decode_int_center(tctx.ntt, ops.decrypt(tctx, sk, dsum))
    davg = secure.decrypt_average(tctx, sk, dsum, 3, packing=spec, base_params=tbase)
    return dict(spec=spec, jw=(jw_hi, jw_lo), jsat=jsat, jtc=jtcb, jv=jv, javg=javg,
                w=(w_hi, w_lo), sat=sat, tc=tcb, v=v, avg=avg, dv=dv, dsat=dsat, davg=davg,
                dups=acc.duplicates, base=base, trees=trees)


def test_hhe_upload_and_transcipher_bitwise_vs_jax(hhe_stacks):
    h = hhe_stacks
    for got, want in zip(h["w"], h["jw"]):
        assert tuple(got.shape) == (3, h["spec"].n_ct, 256)
        np.testing.assert_array_equal(_u(got), np.asarray(want))
    np.testing.assert_array_equal(h["sat"].numpy(), np.asarray(h["jsat"]))
    assert int(h["sat"][2]) >= 3 and torch.equal(h["sat"], h["dsat"])
    np.testing.assert_array_equal(_u(h["tc"].c0), np.asarray(h["jtc"].c0))
    np.testing.assert_array_equal(_u(h["tc"].c1), np.asarray(h["jtc"].c1))
    assert h["tc"].scale == h["jtc"].scale


def test_hhe_stack_decrypt_equal_jax_and_direct(hhe_stacks):
    # Field sums sha256-equal to the JAX HHE stack's and to the port's direct
    # packed stack's; averaged params bitwise equal to both; one duplicate
    # redelivery folded once.
    h = hhe_stacks
    assert h["dups"] == 1
    want = _field_sha(h["jv"], h["spec"])
    assert _field_sha(h["v"], h["spec"]) == want == _field_sha(h["dv"], h["spec"])
    got, direct = convert.to_flax(h["avg"]), convert.to_flax(h["davg"])
    for layer, leaves in h["javg"].items():
        for leaf, w in leaves.items():
            np.testing.assert_array_equal(got[layer][leaf], np.asarray(w))
            np.testing.assert_array_equal(direct[layer][leaf], np.asarray(w))
    # And within the packing's error budget of the plaintext mean, on the
    # tensors no client saturated (client 2's Dense kernel did).
    for layer, leaf in (("Conv_0", "bias"), ("Conv_0", "kernel"), ("Dense_0", "bias")):
        mean = np.mean([t[layer][leaf] for t in h["trees"]], axis=0)
        assert np.max(np.abs(got[layer][leaf] - mean)) <= h["spec"].error_budget


# --- the port's streaming round ---------------------------------------------------


@pytest.fixture(scope="module")
def round_setup():
    (x, y), _, _ = make_dataset("mnist", seed=5, n_train=48, n_test=8)
    xs, ys = stack_federated(x, y, iid_contiguous(len(y), 3))
    gen = torch.Generator().manual_seed(6)
    model = create_model("smallcnn", gen=gen, device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=256)
    sk, pk = keys.keygen(ctx, gen, device="cpu")
    # A fine grid (clip 0.05), so one epoch's small Adam steps quantize to
    # non-zero codes.
    spec = packing.PackedSpec.for_params(params, ctx, quantize.PackingConfig(bits=8, clip=0.05), 3)
    cfg = TrainConfig(epochs=1, batch_size=8, num_classes=10, augment=False)
    return model, params, torch.from_numpy(xs), torch.from_numpy(ys), ctx, sk, pk, spec, cfg


def _engine_round(round_setup, kind, seed=7, round_index=4):
    model, params, xs, ys, ctx, sk, pk, spec, cfg = round_setup
    engine = stream.StreamEngine(StreamConfig(upload_kind=kind))
    ct_sum, mets, overflow, smeta = engine.run_round(
        model, cfg, ctx, pk, params, xs, ys, torch.Generator().manual_seed(seed), round_index,
        packing=spec, hhe=HheConfig(key_seed=2) if kind == "hhe" else None)
    avg = secure.decrypt_average(ctx, sk, ct_sum, 3, meta=smeta.meta, packing=spec,
                                 base_params=params, hhe=kind == "hhe")
    return avg, overflow, smeta


def test_engine_hhe_round_bitwise_equals_direct_packed(round_setup):
    h_avg, h_ov, h_meta = _engine_round(round_setup, "hhe")
    d_avg, d_ov, d_meta = _engine_round(round_setup, "ckks")
    assert h_avg.keys() == d_avg.keys()
    for k in h_avg:
        assert torch.equal(h_avg[k], d_avg[k]), k
    assert torch.equal(h_ov, d_ov) and int(h_ov.sum()) == 0
    assert h_meta.record() == d_meta.record()
    assert h_meta.committed and h_meta.meta.surviving == 3 and h_meta.fresh == 3
    params = round_setup[1]
    assert max((h_avg[k] - params[k]).abs().max().item() for k in params) > 1e-4


@pytest.mark.parametrize("extra", [{}, {"host_quorum": 0.5}, {"ship_deadline_s": 1.0},
                                   {"host_staleness_rounds": 1}],
                         ids=["num_hosts", "host_quorum", "ship_deadline_s", "host_staleness_rounds"])
def test_engine_refuses_unported_stream_knobs_by_name(extra):
    # The hierarchical fold's knobs (num_hosts >= 2 and the tier knobs,
    # which StreamConfig accepts only with num_hosts >= 2) are ported now:
    # the hybrid-HE engine takes them, and refuses them only without tiers.
    eng = stream.StreamEngine(StreamConfig(upload_kind="hhe", num_hosts=2, **extra))
    assert eng.stream.num_hosts == 2 and eng._pending_tiers == []
    assert all(getattr(eng.stream, k) == v for k, v in extra.items())
    if extra:
        with pytest.raises(ValueError, match="set num_hosts >= 2 to define the tiers"):
            StreamConfig(upload_kind="hhe", **extra)


@pytest.mark.parametrize("field,value,bad", [
    ("cohort_size", 2, -1), ("quorum", 0.5, 0.0), ("deadline_s", 1.0, -1.0),
    ("staleness_rounds", 1, -1), ("cohort_only", False, None), ("seed", 3, None),
])
def test_ported_stream_knobs_reach_the_engine_with_jax_validation(field, value, bad):
    from hefl_tpu.fl.config import StreamConfig as JStreamConfig

    engine = stream.StreamEngine(StreamConfig(upload_kind="hhe", **{field: value}))
    assert getattr(engine.stream, field) == value
    if bad is not None:
        with pytest.raises(ValueError) as want:
            JStreamConfig(**{field: bad})
        with pytest.raises(ValueError) as got:
            StreamConfig(**{field: bad})
        assert str(got.value) == str(want.value)


def test_engine_refuses_unported_arguments_and_unpacked_hhe(round_setup):
    # dp, a journal session and a fault schedule run; num_real_clients (one
    # device never pads) and an unpacked hhe round stay refused.
    from hefl_tpu_torch.fl.dp import DpConfig
    from hefl_tpu_torch.fl.faults import FaultConfig
    from hefl_tpu_torch.fl.journal import RoundSession

    model, params, xs, ys, ctx, sk, pk, spec, cfg = round_setup
    engine = stream.StreamEngine(StreamConfig(upload_kind="hhe"),
                                 faults=FaultConfig(seed=1, duplicate_clients=1))
    gen = torch.Generator().manual_seed(0)
    session = RoundSession(None)
    _, _, _, sm = engine.run_round(model, cfg, ctx, pk, params, xs, ys, gen, 0, packing=spec,
                                   dp=DpConfig(noise_multiplier=0.5), session=session)
    assert sm.committed and sm.fresh == 3 and sm.duplicates == 1
    with pytest.raises(ValueError, match="num_real_clients"):
        engine.run_round(model, cfg, ctx, pk, params, xs, ys, gen, 0, packing=spec,
                         num_real_clients=2)
    with pytest.raises(ValueError, match="PACKED"):
        engine.run_round(model, cfg, ctx, pk, params, xs, ys, gen, 0)


# --- the certificates --------------------------------------------------------------


@pytest.mark.parametrize("certify", [ranges.certify_packing, ranges.certify_transciphering])
def test_certificates_accept_default_geometry_and_name_the_violation(certify):
    q = keys.CkksContext.create(n=4096).modulus
    good = certify(q, 8, 3, 8, 16)           # the HHE round's geometry (k=3, C=8)
    assert good.ok and "CERTIFIED" in good.summary()
    bad = certify(q, 16, 16, 1024, 2)
    assert not bad.ok and "UNSAFE" in bad.summary()
    assert not any("carry-free" in f for f in bad.findings)   # fields are sized for C
    wall = "transciphered total (q/2 wall)" if certify is ranges.certify_transciphering \
        else "packed client-sum (q/2 & 2**62 wall)"
    assert wall in bad.summary()


def test_transcipher_certificate_names_the_q_wall_and_recovery_window():
    q = keys.CkksContext.create(n=256).modulus
    small_q = ranges.certify_transciphering(1 << 40, 8, 3, 8, 16)
    assert not small_q.ok
    assert [f.split(":")[0] for f in small_q.findings] == ["transciphered total (q/2 wall)"]
    # A guard so wide the shifted recovery leaves the mod-2**62 window.
    window = ranges.certify_transciphering(q, 8, 4, 2, 30)
    assert not window.ok and any("mod-2**62 window" in f for f in window.findings)


# --- the CLI -------------------------------------------------------------------------


def test_cli_parses_the_hhe_flags():
    args = cli.parse_args(["--device", "cpu", "--pack-bits", "8", "--pack-clip", "0.25",
                           "--pack-interleave", "2", "--hhe", "--hhe-key-seed", "5",
                           "--quorum", "1.0"])
    assert (args.pack_bits, args.pack_clip, args.pack_interleave) == (8, 0.25, 2)
    assert args.hhe and args.hhe_key_seed == 5 and not args.stream
    assert cli.parse_args(["--stream", "--device", "cpu"]).stream


@pytest.mark.parametrize("argv,flag", [
    (["--hhe"], "--hhe"),
    (["--hhe-key-seed", "3"], "--hhe-key-seed"),
    (["--pack-clip", "0.3"], "--pack-clip"),
    (["--pack-interleave", "2"], "--pack-interleave"),
    (["--stream", "--quorum", "1.5"], "--quorum"),
    (["--pack-bits", "1"], "bits"),
])
def test_cli_refuses_invalid_hhe_combinations_by_name(argv, flag, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.parse_args(["--device", "cpu", *argv])
    assert exc.value.code == 2
    assert flag in capsys.readouterr().err


def test_cli_hhe_round_end_to_end_on_cpu():
    cmd = [sys.executable, "-m", "hefl_tpu_torch.cli", "--model", "smallcnn",
           "--dataset", "mnist", "--num-clients", "4", "--epochs", "1", "--n-train", "64",
           "--n-test", "8", "--he-n", "1024", "--pack-bits", "8", "--hhe", "--no-augment",
           "--json", "--no-save-model", "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["encode_overflow"] == [0] * 4 and rec["stream"]["committed"]
    assert rec["stream"]["fresh"] == 4 and rec["packing"]["bits"] == 8
    assert rec["hhe"]["expansion_hhe"] <= 1.1 and rec["hhe"]["key_seed"] == 0
    assert 0.0 <= rec["accuracy"] <= 1.0
