"""The port's packed quantized uplink against the JAX package.

Quantizer codes, the (hi, lo) interleave, `pack_quantized_delta`, the exact
integer codec (`encode_packed`, `decode_int_center`), `unpack_quantized`
and the direct packed stack -> decrypt are held BITWISE against the JAX
package on the same weights (carried across by `convert.from_flax`), keys
and encryption samples. The JAX `PackedSpec` is built with its dataclass
constructor: its `for_params` needs a range-analysis API this JAX lacks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.ckks import encoding as jenc
from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import ops as jops
from hefl_tpu.ckks import packing as jpack
from hefl_tpu.ckks import quantize as jq
from hefl_tpu.fl import secure as jsecure

from hefl_tpu_torch import convert
from hefl_tpu_torch.analysis import ranges
from hefl_tpu_torch.ckks import encoding, keys, packing, quantize
from hefl_tpu_torch.fl import secure

torch.set_num_threads(2)

SHAPES = {"Conv_0": {"bias": (4,), "kernel": (3, 3, 2, 4)},
          "Dense_0": {"bias": (10,), "kernel": (100, 10)}}     # 1,086 params


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _tree(rng, scale=0.3):
    return {layer: {leaf: (rng.normal(0, scale, shape)).astype(np.float32)
                    for leaf, shape in leaves.items()}
            for layer, leaves in SHAPES.items()}


def _client_trees(base, num_clients, seed, eps=0.05, huge=None):
    """Clients = base + eps * noise; client `huge` gets a few saturating
    coefficients."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(num_clients):
        t = {layer: {leaf: (a + eps * rng.normal(size=a.shape)).astype(np.float32)
                     for leaf, a in leaves.items()} for layer, leaves in base.items()}
        if c == huge:
            t["Dense_0"]["kernel"][0, :3] += 7.0
        out.append(t)
    return out


def jax_spec(tree, jctx, cfg: jq.PackingConfig, clients: int, k: int | None = None):
    """The JAX PackedSpec from its dataclass constructor, every field from the
    JAX package's own formulas (k from the headroom formula unless given)."""
    base = jpack.PackSpec.for_params(tree, jctx.n)
    guard = cfg.guard_bits + max(clients - 1, 0).bit_length()
    fb = jq.field_bits(cfg.bits, clients)
    if k is None:
        k = cfg.interleave or jq.payload_bits(int(jctx.modulus), guard) // fb
    clips = spans = None
    if cfg.per_tensor:
        clips = cfg.clip
        spans = tuple(int(leaf.size) for leaf in jax.tree_util.tree_leaves(tree))
    step = cfg.step
    return jpack.PackedSpec(
        base=base, bits=cfg.bits, k=k, field_bits=fb, guard=guard,
        step=max(step) if isinstance(step, tuple) else float(step),
        clip=max(cfg.clip) if cfg.per_tensor else float(cfg.clip), clients=clients,
        n_ct=-(-base.n_ct // k), error_budget=jq.quant_error_budget(cfg), clips=clips,
        spans=spans,
    )


@pytest.fixture(scope="module")
def ctx256():
    return jkeys.CkksContext.create(n=256), keys.CkksContext.create(n=256)


@pytest.mark.parametrize("bits,clip", [(8, 0.25), (4, 0.5), (16, 0.1)])
def test_quantize_codes_bitwise_vs_jax(bits, clip):
    # Codes bitwise, half-way points included (round half to even in float32).
    step = quantize.symmetric_step(clip, bits)
    rng = np.random.default_rng(bits)
    x = rng.normal(0, clip, 4000).astype(np.float32)
    halves = ((np.arange(-40, 40) + 0.5) * np.float32(step)).astype(np.float32)
    x = np.concatenate([x, halves, np.float32([3 * clip, -3 * clip, 0.0])])
    got = quantize.quantize(torch.from_numpy(x), step, bits).numpy()
    want = np.asarray(jq.quantize(jnp.asarray(x), step, bits))
    np.testing.assert_array_equal(got, want)
    assert int(quantize.saturation_count(torch.from_numpy(x), step, bits)) == int(
        jq.saturation_count(jnp.asarray(x), step, bits))
    np.testing.assert_array_equal(
        quantize.dequantize(torch.from_numpy(got), step).numpy(),
        np.asarray(jq.dequantize(jnp.asarray(want), step)))


@pytest.mark.parametrize("k,fbits,guard", [(1, 11, 19), (3, 11, 19), (4, 10, 18), (2, 9, 5)])
def test_interleave_deinterleave_bitwise_vs_jax(k, fbits, guard):
    rng = np.random.default_rng(k)
    u = rng.integers(0, 1 << fbits, (3, k, 64)).astype(np.uint32)
    hi, lo = quantize.interleave_fields(torch.from_numpy(u.astype(np.int64)), k, fbits, guard)
    jhi, jlo = jq.interleave_fields(jnp.asarray(u), k, fbits, guard)
    np.testing.assert_array_equal(_u(hi), np.asarray(jhi))
    np.testing.assert_array_equal(_u(lo), np.asarray(jlo))
    v = quantize.packed_value_int64(hi, lo)
    np.testing.assert_array_equal(v, jq.packed_value_int64(np.asarray(jhi), np.asarray(jlo)))
    noise = rng.integers(-(1 << (guard - 2)), 1 << (guard - 2), v.shape)
    got = quantize.deinterleave_fields(v + noise, k, fbits, guard)
    np.testing.assert_array_equal(got, jq.deinterleave_fields(v + noise, k, fbits, guard))
    np.testing.assert_array_equal(got, u.astype(np.int64))


@pytest.mark.parametrize("clip", [0.25, "per_tensor"])
def test_pack_quantized_delta_bitwise_vs_jax(ctx256, clip):
    jctx, tctx = ctx256
    rng = np.random.default_rng(3)
    base = _tree(rng)
    (client,) = _client_trees(base, 1, 4, huge=0)
    if clip == "per_tensor":
        clip = (0.1, 0.2, 0.25, 0.3)
    cfg = quantize.PackingConfig(bits=8, interleave=4, clip=clip)
    jspec = jax_spec(base, jctx, jq.PackingConfig(bits=8, interleave=4, clip=clip), 3)
    spec = packing.PackedSpec.for_params(convert.from_flax(base), tctx, cfg, 3)
    hi, lo, sat = packing.pack_quantized_delta(convert.from_flax(client),
                                               convert.from_flax(base), spec)
    jhi, jlo, jsat = jpack.pack_quantized_delta(client, base, jspec)
    assert tuple(hi.shape) == (spec.n_ct, 256) == tuple(jhi.shape)
    np.testing.assert_array_equal(_u(hi), np.asarray(jhi))
    np.testing.assert_array_equal(_u(lo), np.asarray(jlo))
    assert int(sat) == int(jsat) >= 3


@pytest.mark.parametrize("n", [256, 1024])
def test_encode_packed_and_decode_int_center_exact_vs_jax(n):
    jctx = jkeys.CkksContext.create(n=n)
    tctx = keys.CkksContext.create(n=n)
    rng = np.random.default_rng(n)
    hi = rng.integers(0, 1 << 31, (2, n)).astype(np.uint32)
    lo = rng.integers(0, 1 << 31, (2, n)).astype(np.uint32)
    got = encoding.encode_packed(tctx.ntt, _t(hi), _t(lo))
    want = jenc.encode_packed(jctx.ntt, jnp.asarray(hi), jnp.asarray(lo))
    np.testing.assert_array_equal(_u(got), np.asarray(want))
    # The centered CRT value of the residues IS hi*2**31 + lo (< 2**62 < q/2).
    v = encoding.decode_int_center(tctx.ntt, got)
    np.testing.assert_array_equal(v, jenc.decode_int_center(jctx.ntt, want))
    np.testing.assert_array_equal(v, quantize.packed_value_int64(hi, lo))
    # Negative values (the centered half) are exact too: residues of -v.
    p = np.asarray(jctx.ntt.p).astype(np.int64)
    neg = ((p - np.asarray(want).astype(np.int64)) % p).astype(np.uint32)
    np.testing.assert_array_equal(encoding.decode_int_center(tctx.ntt, _t(neg)), -v)


@pytest.mark.parametrize("clip", [0.25, "per_tensor"])
def test_unpack_quantized_bitwise_vs_jax(ctx256, clip):
    jctx, tctx = ctx256
    base = _tree(np.random.default_rng(5))
    if clip == "per_tensor":
        clip = (0.1, 0.2, 0.25, 0.3)
    spec = packing.PackedSpec.for_params(
        convert.from_flax(base), tctx, quantize.PackingConfig(bits=8, clip=clip), 3)
    jspec = jax_spec(base, jctx, jq.PackingConfig(bits=8, clip=clip), 3, k=spec.k)
    rng = np.random.default_rng(6)
    fields = rng.integers(0, 3 * 254 + 1, (spec.n_ct, spec.k, 256)).astype(np.uint32)
    hi, lo = jq.interleave_fields(jnp.asarray(fields), spec.k, spec.field_bits, spec.guard)
    v = jq.packed_value_int64(np.asarray(hi), np.asarray(lo))
    v = v + rng.integers(-1000, 1000, v.shape)
    got = packing.unpack_quantized(v, spec, 3)
    want = np.asarray(jpack.unpack_quantized(v, jspec, 3))
    assert got.dtype == np.float32 and got.shape == (spec.total,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits,clip,clients", [(8, 0.5, 8), (8, 0.25, 3), (4, 0.5, 16),
                                               (16, 0.1, 2), (8, (0.1, 0.2, 0.3, 0.4), 8)])
def test_packed_spec_fields_equal_jax_formulas(ctx256, bits, clip, clients):
    jctx, tctx = ctx256
    base = _tree(np.random.default_rng(7))
    spec = packing.PackedSpec.for_params(
        convert.from_flax(base), tctx, quantize.PackingConfig(bits=bits, clip=clip), clients)
    jspec = jax_spec(base, jctx, jq.PackingConfig(bits=bits, clip=clip), clients)
    for name in ("bits", "k", "field_bits", "guard", "step", "clip", "clients", "n_ct",
                 "error_budget", "clips", "spans", "error_feedback"):
        assert getattr(spec, name) == getattr(jspec, name), name
    assert (spec.base.n, spec.base.total, spec.base.n_ct) == (
        jspec.base.n, jspec.base.total, jspec.base.n_ct)
    assert spec.guard_scale == jspec.guard_scale and spec.offset == jspec.offset
    assert spec.geometry_record() == jspec.geometry_record()
    assert packing.bytes_on_wire_record(spec, 3) == jpack.bytes_on_wire_record(jspec, 3)
    steps = packing.step_vector(spec)
    jsteps = jpack.step_vector(jspec)
    assert (steps is None) == (jsteps is None)
    if steps is not None:
        np.testing.assert_array_equal(steps, jsteps)


def test_packed_spec_refuses_error_feedback_and_uncertified_interleave(ctx256):
    # Error feedback is ported: the spec builds and records it; an
    # uncertified interleave is still refused.
    _, tctx = ctx256
    params = convert.from_flax(_tree(np.random.default_rng(8)))
    spec = packing.PackedSpec.for_params(
        params, tctx, quantize.PackingConfig(bits=8, error_feedback=True), 2)
    assert spec.error_feedback and spec.geometry_record()["error_feedback"] is True
    with pytest.raises(ValueError, match="carry-free|wall"):
        packing.PackedSpec.for_params(
            params, tctx, quantize.PackingConfig(bits=16, interleave=16), 1024)


@pytest.mark.parametrize("clients", [1, 2, 8, 33, 1000])
def test_max_interleave_is_the_largest_certified_k(clients):
    q = keys.CkksContext.create(n=256).modulus
    k = quantize.max_interleave(q, 8, clients, 16)
    assert ranges.certify_packing(q, 8, k, clients, 16).ok
    assert not ranges.certify_packing(q, 8, k + 1, clients, 16).ok


def test_direct_packed_stack_then_decrypt_bitwise_vs_jax(ctx256):
    # encrypt_stack_packed (one encrypt core over the stack) -> lazy sum ->
    # decrypt -> integer decode: every ciphertext word, the decoded field
    # sums and the averaged params bitwise equal to the JAX package's.
    jctx, tctx = ctx256
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(11))
    sk, pk = convert.keys_from_jax(jsk, jpk)
    base = _tree(np.random.default_rng(9))
    trees = _client_trees(base, 3, 10, huge=1)
    cfg = quantize.PackingConfig(bits=8, interleave=4, clip=0.25)
    jspec = jax_spec(base, jctx, jq.PackingConfig(bits=8, interleave=4, clip=0.25), 3)
    spec = packing.PackedSpec.for_params(convert.from_flax(base), tctx, cfg, 3)
    enc_keys = jax.random.split(jax.random.key(12), 3)
    samples = jax.vmap(lambda k: jops.encrypt_samples(jctx, k, (jspec.n_ct,)))(enc_keys)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)), *trees)
    jct, jsat = jsecure.encrypt_stack_packed(jctx, jpk, stacked, base, enc_keys, jspec)
    jsum = jsecure.aggregate_encrypted(jctx, jct)
    javg = jsecure.decrypt_average(jctx, jsk, jsum, 3, packing=jspec, base_params=base)
    p_out = [convert.from_flax(t) for t in trees]
    ct, sat = secure.encrypt_stack_packed(tctx, pk, p_out, convert.from_flax(base), None,
                                          spec, samples=tuple(_t(s) for s in samples))
    assert ct.scale == jct.scale == spec.guard_scale
    np.testing.assert_array_equal(_u(ct.c0), np.asarray(jct.c0))
    np.testing.assert_array_equal(_u(ct.c1), np.asarray(jct.c1))
    np.testing.assert_array_equal(sat.numpy(), np.asarray(jsat))
    ct_sum = secure.aggregate_encrypted(tctx, ct)
    avg = secure.decrypt_average(tctx, sk, ct_sum, 3, packing=spec,
                                 base_params=convert.from_flax(base))
    got = convert.to_flax(avg)
    for layer, leaves in javg.items():
        for leaf, want in leaves.items():
            np.testing.assert_array_equal(got[layer][leaf], np.asarray(want))
