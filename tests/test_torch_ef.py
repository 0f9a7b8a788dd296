"""The port's error-feedback packing (`ckks.quantize.ef_quantize`, the `_ef`
packers, `fl.secure`'s EF stacks and the streaming engine's residual)
against the JAX package, on the CPU.

`ef_quantize` and the packers are float32 -> int32 -> uint32 maps in the
JAX package's order, so on the same float32 arrays they give its codes,
words and residuals bit for bit. The engine's residual is a function of the
trained weights, which come from torch generators here: the tests hold it
to its definition (the uploads it quantized), to the cohort it may touch,
and the engine's records to the JAX engine's. The JAX engine's certifiers
need `jax.experimental.enable_x64`, gone in JAX 0.9 (ROADMAP caveat R1):
they are stubbed with monkeypatch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hefl_tpu.analysis.ranges as jranges
from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import packing as jpack
from hefl_tpu.ckks import quantize as jq
from hefl_tpu.fl import client as jclient
from hefl_tpu.fl import config as jconfig
from hefl_tpu.fl import faults as jfaults
from hefl_tpu.fl import stream as jstream
from hefl_tpu.models import SmallCNN as JSmallCNN
from hefl_tpu.parallel import make_mesh

from hefl_tpu_torch import convert
from hefl_tpu_torch.ckks import keys, packing, quantize
from hefl_tpu_torch.data import partition, synthetic
from hefl_tpu_torch.fl import client, secure, stream
from hefl_tpu_torch.fl.config import HheConfig, PackingConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.dp import DpConfig
from hefl_tpu_torch.fl.faults import FaultConfig
from hefl_tpu_torch.models import create_model

from test_torch_packing import _client_trees, _tree, _u, jax_spec

torch.set_num_threads(2)

C = 8
TRAIN = dict(epochs=1, batch_size=4, num_classes=10, augment=False, val_fraction=0.25)


class _Ok:
    ok = True

    def summary(self):
        return "stubbed"


def _stub_jax_certifiers(monkeypatch):
    for name in ("certify_fold_inductive", "certify_transciphering", "certify_packing",
                 "certify_fold_tree"):
        monkeypatch.setattr(jranges, name, lambda *a, **k: _Ok())


@pytest.mark.parametrize("bits,clip", [(4, 0.5), (8, 0.25), (2, 0.1)])
def test_ef_quantize_is_bitwise_jax(bits, clip):
    step = quantize.symmetric_step(clip, bits)
    rng = np.random.default_rng(bits)
    x = rng.normal(0, clip, 3000).astype(np.float32)
    x[:5] = [4 * clip, -4 * clip, 0.5 * step, -0.5 * step, 0.0]
    res = rng.uniform(-step, step, 3000).astype(np.float32)
    q, r = quantize.ef_quantize(torch.from_numpy(x), torch.from_numpy(res), step, bits)
    jqq, jr_ = jq.ef_quantize(jnp.asarray(x), jnp.asarray(res), step, bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr_))
    inside = np.abs((x + res) / np.float32(step)) <= quantize.qmax(bits) + 0.5
    assert np.all(np.abs(r.numpy()[inside]) <= step / 2 * (1 + 1e-6))
    assert not inside[:2].any() and np.abs(r.numpy()[:2]).min() > step


@pytest.fixture(scope="module")
def ctx256():
    return jkeys.CkksContext.create(n=256), keys.CkksContext.create(n=256)


@pytest.mark.parametrize("clip", [0.25, "per_tensor"])
def test_ef_packers_are_bitwise_jax(ctx256, clip):
    jctx, tctx = ctx256
    rng = np.random.default_rng(3)
    base = _tree(rng)
    (cl,) = _client_trees(base, 1, 4, huge=0)
    if clip == "per_tensor":
        clip = (0.1, 0.2, 0.25, 0.3)
    cfg = quantize.PackingConfig(bits=4, clip=clip, error_feedback=True)
    spec = packing.PackedSpec.for_params(convert.from_flax(base), tctx, cfg, C)
    jspec = dataclasses.replace(
        jax_spec(base, jctx, jq.PackingConfig(bits=4, clip=clip, error_feedback=True), C),
        error_feedback=True)
    assert (spec.k, spec.n_ct, spec.error_feedback) == (jspec.k, jspec.n_ct, True)
    res = rng.uniform(-0.05, 0.05, spec.total).astype(np.float32)
    hi, lo, sat, new_res = packing.pack_quantized_delta_ef(
        convert.from_flax(cl), convert.from_flax(base), torch.from_numpy(res), spec)
    jhi, jlo, jsat, jres = jpack.pack_quantized_delta_ef(cl, base, jnp.asarray(res), jspec)
    np.testing.assert_array_equal(_u(hi), np.asarray(jhi))
    np.testing.assert_array_equal(_u(lo), np.asarray(jlo))
    np.testing.assert_array_equal(new_res.numpy(), np.asarray(jres))
    assert int(sat) == int(jsat) > 0
    flat = packing.flat_params(convert.from_flax(cl)) - packing.flat_params(
        convert.from_flax(base))
    f = packing.pack_quantized_flat_ef(flat, torch.from_numpy(res), spec)
    jf = jpack.pack_quantized_flat_ef(jnp.asarray(flat.numpy()), jnp.asarray(res), jspec)
    for a, b in zip(f[:2], jf[:2]):
        np.testing.assert_array_equal(_u(a), np.asarray(b))
    # A zero residual is the plain packer.
    z = packing.pack_quantized_flat_ef(flat, torch.zeros(spec.total), spec)
    plain = packing.pack_quantized_flat(flat, spec)
    assert torch.equal(z[0], plain[0]) and torch.equal(z[1], plain[1])


def test_residual_telescopes_and_stays_within_half_a_step():
    step = quantize.symmetric_step(0.5, 4)
    rng = np.random.default_rng(0)
    res = torch.zeros(5000)
    sent = torch.zeros(5000, dtype=torch.float64)
    total = torch.zeros(5000, dtype=torch.float64)
    for _ in range(6):
        x = torch.from_numpy(rng.normal(0, 0.02, 5000).astype(np.float32))
        q, res = quantize.ef_quantize(x, res, step, 4)
        sent += quantize.dequantize(q, step).double()
        total += x.double()
        assert float(res.abs().max()) <= step / 2 * (1 + 1e-6)
    # What was sent plus what is still carried is what was to be sent.
    assert float((sent + res.double() - total).abs().max()) < 1e-5
    # Small updates: the plain quantizer sends nothing, EF sends the drift.
    assert float(sent.abs().sum()) > 0


def test_packing_config_with_error_feedback_builds_and_describe_is_jax():
    q = int(keys.CkksContext.create(n=256).modulus)
    for ef in (False, True):
        # interleave given: the JAX max_interleave's certificate is R1-broken.
        cfg = quantize.PackingConfig(bits=4, interleave=6, error_feedback=ef)
        jcfg = jq.PackingConfig(bits=4, interleave=6, error_feedback=ef)
        assert quantize.describe(cfg, q, C) == jq.describe(jcfg, q, C)
        auto = quantize.describe(dataclasses.replace(cfg, interleave=0), q, C)
        assert auto == quantize.describe(cfg, q, C) and auto["error_feedback"] is ef
    with pytest.raises(ValueError, match="error_feedback needs packing"):
        quantize.PackingConfig(error_feedback=True)


def _data():
    (x, y), _, _ = synthetic.make_dataset("mnist", seed=0, n_train=8 * C, n_test=8)
    return partition.stack_federated(x, y, partition.iid_contiguous(8 * C, C))


def _setup(bits=4):
    xs, ys = (torch.from_numpy(a) for a in _data())
    model = create_model("smallcnn", device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=256)
    sk, pk = keys.keygen(ctx, torch.Generator().manual_seed(21), device="cpu")
    spec = packing.PackedSpec.for_params(
        params, ctx, PackingConfig(bits=bits, clip=0.05, error_feedback=True), C)
    return model, params, xs, ys, ctx, sk, pk, spec


S_KW = dict(cohort_size=4, quorum=0.5, deadline_s=2.0, staleness_rounds=1)
F_KW = dict(seed=3, straggler_fraction=0.25, straggler_delay_s=3.0, duplicate_clients=1)


def _rounds(eng, setup, rounds, uploads=None, **kw):
    model, params, xs, ys, ctx, sk, pk, spec = setup
    out = []
    for r in range(rounds):
        before = None if eng._ef_residual is None else eng._ef_residual.clone()
        ct, _, _, sm = eng.run_round(model, TrainConfig(**TRAIN), ctx, pk, params, xs, ys,
                                     torch.Generator().manual_seed(100 + r), r, packing=spec,
                                     **kw)
        out.append((before, eng._ef_residual.clone(), ct, sm,
                    None if uploads is None else uploads[-1]))
    return out


def test_engine_residual_is_the_uploads_error_on_cohort_rows_only(monkeypatch):
    setup = _setup()
    params, spec = setup[1], setup[7]
    captured = []
    real = stream.client_uploads

    def spy(*a, **k):
        out = real(*a, **k)
        captured.append((k["cohort"], out[3], k["ef_residual"].clone()))
        return out

    monkeypatch.setattr(stream, "client_uploads", spy)
    eng = stream.StreamEngine(StreamConfig(**S_KW), FaultConfig(**F_KW))
    base = packing.flat_params(params)
    step = spec.step
    for before, after, _, sm, (cohort, p_out, res_in) in _rounds(eng, setup, 2, captured):
        before = torch.zeros_like(after) if before is None else before
        assert torch.equal(res_in, before)
        others = [c for c in range(C) if c not in cohort]
        assert torch.equal(after[others], before[others])
        for row, c in enumerate(cohort):
            q, want = quantize.ef_quantize(packing.flat_params(p_out[row]) - base, before[c],
                                           step, spec.bits)
            assert torch.equal(after[c], want)
            carried = packing.flat_params(p_out[row]) - base + before[c]
            inside = (carried / step).abs() <= quantize.qmax(spec.bits) + 0.5
            assert float(after[c][inside].abs().max()) <= step / 2 * (1 + 1e-6)
        assert not torch.equal(after[list(cohort)], before[list(cohort)])


def test_engine_records_with_error_feedback_match_jax(monkeypatch):
    _stub_jax_certifiers(monkeypatch)
    setup = _setup()
    eng = stream.StreamEngine(StreamConfig(**S_KW), FaultConfig(**F_KW))
    got = [sm for *_, sm, _ in _rounds(eng, setup, 2)]
    xs, ys = _data()
    jmodel = JSmallCNN(num_classes=10)
    jparams = jmodel.init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"]
    jctx = jkeys.CkksContext.create(n=256)
    _, jpk = jkeys.keygen(jctx, jax.random.key(21))
    jspec = dataclasses.replace(jax_spec(jparams, jctx, jq.PackingConfig(bits=4, clip=0.05), C),
                                error_feedback=True)
    jeng = jstream.StreamEngine(jconfig.StreamConfig(**S_KW), jfaults.FaultConfig(**F_KW))
    for r, g in enumerate(got):
        _, _, _, w = jeng.run_round(jmodel, jconfig.TrainConfig(**TRAIN), make_mesh(C), jctx,
                                    jpk, jparams, jnp.asarray(xs), jnp.asarray(ys),
                                    jax.random.key(100 + r), r, packing=jspec)
        assert g.record() == w.record() and g.meta.bits == w.meta.bits
    assert jeng._ef_residual.shape == tuple(eng._ef_residual.shape)
    zero = jclient.init_ef_residuals(jparams, C)
    mine = client.init_ef_residuals(setup[1], C)
    assert tuple(mine.shape) == tuple(zero.shape) and not mine.any()


def test_hhe_error_feedback_is_bitwise_the_ckks_path():
    setup = _setup()
    model, params, xs, ys, ctx, sk, pk, spec = setup
    out = {}
    for kind in ("ckks", "hhe"):
        eng = stream.StreamEngine(StreamConfig(**S_KW, upload_kind=kind), FaultConfig(**F_KW))
        kw = {"hhe": HheConfig()} if kind == "hhe" else {}
        runs = _rounds(eng, setup, 2, **kw)
        avgs = [secure.decrypt_average(ctx, sk, ct, C, meta=sm.meta, packing=spec,
                                       base_params=params, hhe=kind == "hhe")
                for _, _, ct, sm, _ in runs]
        out[kind] = (avgs, runs[-1][1])
    for a, b in zip(out["ckks"][0], out["hhe"][0]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(out["ckks"][1], out["hhe"][1])


def test_fused_and_per_client_training_give_the_residual_of_their_uploads(monkeypatch):
    setup = _setup()
    model, params, xs, ys, ctx, sk, pk, spec = setup
    base = packing.flat_params(params)
    res = {}
    real = stream.client_uploads
    for backend in ("fused", "vmap"):
        captured = []

        def spy(*a, captured=captured, **k):
            out = real(*a, **k)
            captured.append((k["cohort"], out[3]))
            return out

        monkeypatch.setattr(stream, "client_uploads", spy)
        eng = stream.StreamEngine(StreamConfig(**S_KW), FaultConfig(**F_KW))
        eng.run_round(model, TrainConfig(**TRAIN, client_fusion=backend), ctx, pk, params, xs,
                      ys, torch.Generator().manual_seed(100), 0, packing=spec)
        cohort, p_out = captured[-1]
        for row, c in enumerate(cohort):
            _, want = quantize.ef_quantize(packing.flat_params(p_out[row]) - base,
                                           torch.zeros(spec.total), spec.step, spec.bits)
            assert torch.equal(eng._ef_residual[c], want)
        res[backend] = eng._ef_residual
    # The two backends train to float tolerance, so their residuals differ
    # by at most a step where a code flipped.
    assert float((res["fused"] - res["vmap"]).abs().max()) <= spec.step * (1 + 1e-5)


def test_error_feedback_refusals_are_the_jax_packages():
    setup = _setup()
    model, params, xs, ys, ctx, sk, pk, spec = setup
    eng = stream.StreamEngine(StreamConfig())
    with pytest.raises(ValueError, match="dp cannot be combined with error-feedback"):
        eng.run_round(model, TrainConfig(**TRAIN), ctx, pk, params, xs, ys,
                      torch.Generator().manual_seed(1), 0, packing=spec, dp=DpConfig())
    with pytest.raises(ValueError, match=r"needs the per-client residual rows \(ef_residual\)"):
        secure.client_uploads(model, TrainConfig(**TRAIN), ctx, pk, params, xs, ys,
                              torch.Generator().manual_seed(1), packing=spec)
    with pytest.raises(ValueError, match="requires the streaming engine's cross-round residual"):
        secure.secure_fedavg_round(model, TrainConfig(**TRAIN), ctx, pk, params, xs, ys,
                                   torch.Generator().manual_seed(1), packing=spec)


def test_ef_packing_record_grid_and_bytes():
    from hefl_tpu_torch.fl import load

    rec = load.ef_packing_record(cohort=16, device="cpu")
    q = int(keys.CkksContext.create(n=256).modulus)
    # The grid's k from the JAX headroom formula (its max_interleave
    # certifies through the R1-broken analysis).
    for b, g in rec["grid"].items():
        guard = 16 + (C - 1).bit_length()
        assert g == {"k": jq.payload_bits(q, guard) // jq.field_bits(int(b), C),
                     "certified": True}
    assert rec["n_ct"] == {"2": 110, "4": 147, "8": 294}
    assert rec["bytes_ratio_b4_vs_b8"] == 0.5 and rec["bytes_ratio_ok"] and rec["certified"]
