"""The port's CKKS layer held against the JAX package on the same inputs.

Integer HE functions must agree BITWISE: every output is a canonical residue
mod p, so any exact modular arithmetic gives the same words (the port's int32
tensors hold the JAX package's uint32 bit patterns). Inputs are made from a
seed with numpy and handed to both packages. The JAX side runs its XLA
reference path (the default off-TPU), which its own tests show is bitwise
equal to its Pallas kernels.

The CUDA kernels are held against their plain versions in
tests/test_torch_cuda.py, which needs a card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.ckks import encoding as jenc
from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import modular as jmod
from hefl_tpu.ckks import ntt as jntt
from hefl_tpu.ckks import ops as jops
from hefl_tpu.ckks.primes import find_ntt_primes

from hefl_tpu_torch.ckks import encoding, keys, modular, ntt, ops
from hefl_tpu_torch.convert import keys_from_jax

torch.set_num_threads(2)

# The JAX references, jitted with the context static: one compile per shape
# instead of an eager dispatch of every stage op.
_j_fwd = jax.jit(jntt.ntt_forward, static_argnums=0)
_j_inv = jax.jit(jntt.ntt_inverse, static_argnums=0)
_j_polymul = jax.jit(jntt.negacyclic_poly_mul, static_argnums=0)
_j_encrypt_core = jax.jit(jops._encrypt_core_xla, static_argnums=0)
_j_add_plain = jax.jit(jops.ct_add_plain, static_argnums=0)


def _t(a) -> torch.Tensor:
    """JAX uint32 array -> port int32 tensor with the same bits."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    """Port int32 tensor -> uint32 numpy with the same bits."""
    return t.contiguous().numpy().view(np.uint32)


def _rand_res(p_col: np.ndarray, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**40, size=shape, dtype=np.int64) % p_col).astype(np.uint32)


@pytest.fixture(scope="module")
def ctxs():
    """(JAX context, port context) at the default ring: N=4096, L=3."""
    return jkeys.CkksContext.create(), keys.CkksContext.create()


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_ntt_tables_equal_jax(n):
    # Exact host number theory on both sides: tables must be identical words.
    prime_list = find_ntt_primes(3, 27, 2 * n)
    j = jntt.NTTContext.build(prime_list, n, seed=3)
    t = ntt.NTTContext.build(prime_list, n, seed=3)
    for field in ("p", "pinv_neg", "r2", "psi_rev", "psi_inv_rev", "n_inv_mont"):
        assert np.array_equal(getattr(j, field), getattr(t, field)), field
    js, ts = jntt.shoup_tables(j), ntt.shoup_tables(t)
    for field in ("psi", "psi_shoup", "psi_inv", "psi_inv_shoup", "n_inv", "n_inv_shoup"):
        assert np.array_equal(getattr(js, field), getattr(ts, field)), field
    assert t == ntt.NTTContext.build(prime_list, n, seed=3)


def test_modular_helpers_bitwise(ctxs):
    # Bitwise: canonical residues in, canonical residues out.
    jctx, _ = ctxs
    p = np.asarray(jctx.ntt.p)                                   # uint32[L, 1]
    pinv = np.asarray(jctx.ntt.pinv_neg)
    a = _rand_res(p, (3, 4096), 1)
    b = _rand_res(p, (3, 4096), 2)
    a64, b64 = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    p64, pinv64 = torch.from_numpy(p.astype(np.int64)), torch.from_numpy(pinv.astype(np.int64))
    ja, jb, jp, jpinv = map(jnp.asarray, (a, b, p, pinv))
    check = lambda got, want: np.testing.assert_array_equal(  # noqa: E731
        got.numpy().astype(np.uint32), np.asarray(want)
    )
    check(modular.add_mod(a64, b64, p64), jmod.add_mod(ja, jb, jp))
    check(modular.sub_mod(a64, b64, p64), jmod.sub_mod(ja, jb, jp))
    check(modular.neg_mod(a64, p64), jmod.neg_mod(ja, jp))
    check(modular.mont_mul(a64, b64, p64, pinv64), jmod.mont_mul(ja, jb, jp, jpinv))
    w_shoup = ((b.astype(object) << 32) // p.astype(object)).astype(np.uint32)
    check(
        modular.shoup_mul(a64, b64, torch.from_numpy(w_shoup.astype(np.int64)), p64),
        jmod.shoup_mul(ja, jb, jnp.asarray(w_shoup), jp),
    )
    x = np.random.default_rng(3).integers(0, 2**32, size=(3, 4096), dtype=np.int64)
    check(modular.barrett_mod(torch.from_numpy(x), p64),
          jmod.barrett_mod(jnp.asarray(x.astype(np.uint32)), jp))
    xs = np.random.default_rng(4).integers(-(2**31) + 1, 2**31, size=(3, 4096), dtype=np.int64)
    check(modular.barrett_mod_signed(torch.from_numpy(xs), p64),
          jmod.barrett_mod_signed(jnp.asarray(xs.astype(np.int32)), jp))
    np.testing.assert_array_equal(
        modular.to_signed_center(a64, p64).numpy(),
        np.asarray(jmod.to_signed_center(ja, jp)).astype(np.int64),
    )


@pytest.mark.parametrize("n", [256, 4096])
def test_ntt_forward_inverse_bitwise(n):
    # Bitwise against hefl_tpu.ckks.ntt (XLA path), and an exact round trip.
    prime_list = find_ntt_primes(3, 27, 2 * n)
    jctx, tctx = jntt.NTTContext.build(prime_list, n), ntt.NTTContext.build(prime_list, n)
    x = _rand_res(np.asarray(jctx.p), (4, 3, n), 5)
    fwd = ntt.ntt_forward(tctx, _t(x))
    np.testing.assert_array_equal(_u(fwd), np.asarray(_j_fwd(jctx, jnp.asarray(x))))
    inv = ntt.ntt_inverse(tctx, _t(x))
    np.testing.assert_array_equal(_u(inv), np.asarray(_j_inv(jctx, jnp.asarray(x))))
    np.testing.assert_array_equal(_u(ntt.ntt_inverse(tctx, fwd)), x)


def test_negacyclic_product_via_ntt(ctxs):
    # Bitwise: forward, pointwise Montgomery product, inverse = the JAX
    # package's negacyclic_poly_mul.
    jctx, tctx = ctxs
    a = _rand_res(np.asarray(jctx.ntt.p), (3, 4096), 6)
    b = _rand_res(np.asarray(jctx.ntt.p), (3, 4096), 7)
    got = ntt.ntt_inverse(tctx.ntt, ntt.pointwise_mul(
        tctx.ntt, ntt.ntt_forward(tctx.ntt, _t(a)),
        ntt.to_mont(tctx.ntt, ntt.ntt_forward(tctx.ntt, _t(b))),
    ))
    want = _j_polymul(jctx.ntt, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(_u(got), np.asarray(want))


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.1, size=shape).astype(np.float32)
    flat = w.reshape(-1)
    # Edge cases: zeros, exact halves of the quantum, large and saturating values.
    flat[:8] = [0.0, -0.0, 2.0**-31, -(2.0**-31), 3.5, -1000.25, 7.0e4, -9.9e4]
    return w


def test_encode_bitwise(ctxs):
    # Bitwise: same float32 steps (round half to even), same integer reduction.
    jctx, tctx = ctxs
    w = _weights((5, 4096), 8)
    got = encoding.encode(tctx.ntt, torch.from_numpy(w), tctx.scale)
    want = jenc.encode(jctx.ntt, jnp.asarray(w), jctx.scale)
    np.testing.assert_array_equal(_u(got), np.asarray(want))
    assert int(encoding.encode_overflow_count(torch.from_numpy(w), tctx.scale)) == int(
        jenc.encode_overflow_count(jnp.asarray(w), jctx.scale)
    ) == 2


@pytest.mark.parametrize("n", [256, 4096])
def test_encode_of_nan_and_saturated_values_bitwise(n):
    # A poisoned upload: NaN encodes to residue 0 in every prime (XLA's
    # float->int conversion in the JAX package), +-1e15 saturates at the
    # envelope, +-inf too; every residue canonical (< p). The overflow count
    # is JAX's: NaN is not counted (5: +-1e15, +-inf, and _weights' -9.9e4).
    jctx, tctx = jkeys.CkksContext.create(n=n), keys.CkksContext.create(n=n)
    w = _weights((2, n), 9)
    w[0, :7] = [np.nan, 1e15, -1e15, 0.5, np.inf, -np.inf, np.nan]
    w[1, 100:] = np.nan
    got = encoding.encode(tctx.ntt, torch.from_numpy(w), tctx.scale)
    want = np.asarray(jenc.encode(jctx.ntt, jnp.asarray(w), jctx.scale))
    np.testing.assert_array_equal(_u(got), want)
    assert np.all(_u(got) < np.asarray(tctx.ntt.p)[None, :, :])
    assert np.all(_u(got)[0, :, 0] == 0) and np.all(_u(got)[1, :, 100:] == 0)
    count = int(encoding.encode_overflow_count(torch.from_numpy(w), tctx.scale))
    assert count == int(jenc.encode_overflow_count(jnp.asarray(w), jctx.scale)) == 5


def test_decode_within_one_ulp(ctxs):
    # Tolerance: 1 float32 ulp of the JAX result. The integer digits are
    # bitwise equal; only the float32 recombination may round differently
    # where XLA contracts a multiply-add.
    jctx, tctx = ctxs
    res = _rand_res(np.asarray(jctx.ntt.p), (4, 3, 4096), 9)
    w = _weights((4, 4096), 10)
    res[:2] = np.asarray(jenc.encode(jctx.ntt, jnp.asarray(w[:2]), jctx.scale))
    got = encoding.decode(tctx.ntt, _t(res), 2 * tctx.scale).numpy()
    want = np.asarray(jenc.decode(jctx.ntt, jnp.asarray(res), 2 * jctx.scale))
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


def _jax_keygen_samples(jctx, key):
    k_s, k_a, k_e = jax.random.split(key, 3)
    return (
        jkeys.sample_ternary_residues(jctx, k_s),
        jkeys.sample_uniform_eval(jctx, k_a),
        jkeys.sample_gaussian_residues(jctx, k_e),
    )


@pytest.fixture(scope="module")
def jax_keys(ctxs):
    jctx, _ = ctxs
    key = jax.random.key(11)
    return key, jkeys.keygen(jctx, key)


def test_keygen_core_bitwise(ctxs, jax_keys):
    # Bitwise: the port's deterministic keygen on the JAX package's samples.
    jctx, tctx = ctxs
    key, (jsk, jpk) = jax_keys
    s, a, e = (_t(v) for v in _jax_keygen_samples(jctx, key))
    sk, pk = keys.keygen_core(tctx, s, a, e)
    np.testing.assert_array_equal(_u(sk.s_mont), np.asarray(jsk.s_mont))
    np.testing.assert_array_equal(_u(pk.b_mont), np.asarray(jpk.b_mont))
    np.testing.assert_array_equal(_u(pk.a_mont), np.asarray(jpk.a_mont))


def test_encrypt_core_bitwise(ctxs, jax_keys):
    # Bitwise against ops._encrypt_core_xla at n=4096, L=3, on the JAX
    # package's (u, e0, e1), message and keys.
    jctx, tctx = ctxs
    _, (jsk, jpk) = jax_keys
    m = jenc.encode(jctx.ntt, jnp.asarray(_weights((3, 4096), 12)), jctx.scale)
    u, e0, e1 = jops.encrypt_samples(jctx, jax.random.key(13), (3,))
    want0, want1 = _j_encrypt_core(jctx, m, u, e0, e1, jpk.b_mont, jpk.a_mont)
    _, pk = keys_from_jax(jsk, jpk)
    ct = ops.encrypt_core(tctx, pk, *(_t(v) for v in (m, u, e0, e1)))
    np.testing.assert_array_equal(_u(ct.c0), np.asarray(want0))
    np.testing.assert_array_equal(_u(ct.c1), np.asarray(want1))
    assert ct.scale == jctx.scale


def test_decrypt_bitwise(ctxs, jax_keys):
    # Bitwise against the XLA branch of ops.decrypt on random ciphertexts.
    jctx, tctx = ctxs
    _, (jsk, jpk) = jax_keys
    p = np.asarray(jctx.ntt.p)
    c0, c1 = _rand_res(p, (3, 3, 4096), 14), _rand_res(p, (3, 3, 4096), 15)
    want = jops.decrypt(jctx, jsk, jops.Ciphertext(jnp.asarray(c0), jnp.asarray(c1), jctx.scale))
    sk, _ = keys_from_jax(jsk, jpk)
    got = ops.decrypt(tctx, sk, ops.Ciphertext(_t(c0), _t(c1), tctx.scale))
    np.testing.assert_array_equal(_u(got), np.asarray(want))


def test_ciphertext_arithmetic_bitwise(ctxs, jax_keys):
    # Bitwise: ct_add, ct_add_plain and ct_mul_scalar on the same ciphertexts.
    jctx, tctx = ctxs
    p = np.asarray(jctx.ntt.p)
    a = [_rand_res(p, (2, 3, 4096), s) for s in (16, 17)]
    b = [_rand_res(p, (2, 3, 4096), s) for s in (18, 19)]
    m = _rand_res(p, (2, 3, 4096), 20)
    ja = jops.Ciphertext(*map(jnp.asarray, a), jctx.scale)
    jb = jops.Ciphertext(*map(jnp.asarray, b), jctx.scale)
    ta = ops.Ciphertext(*map(_t, a), tctx.scale)
    tb = ops.Ciphertext(*map(_t, b), tctx.scale)
    for got, want in (
        (ops.ct_add(tctx, ta, tb), jops.ct_add(jctx, ja, jb)),
        (ops.ct_add_plain(tctx, ta, _t(m)), _j_add_plain(jctx, ja, jnp.asarray(m))),
        (ops.ct_mul_scalar(tctx, ta, 7), jops.ct_mul_scalar(jctx, ja, 7)),
    ):
        np.testing.assert_array_equal(_u(got.c0), np.asarray(want.c0))
        np.testing.assert_array_equal(_u(got.c1), np.asarray(want.c1))
        assert got.scale == want.scale


def test_encrypt_decrypt_roundtrip_with_port_keys(ctxs):
    # Tolerance 5e-6: the repo's fresh-roundtrip yardstick (encode quantum
    # 2**-30 plus RLWE noise of ~sigma*sqrt(N) over the scale).
    _, tctx = ctxs
    gen = torch.Generator().manual_seed(21)
    sk, pk = keys.keygen(tctx, gen, device="cpu")
    w = torch.from_numpy(_weights((3, 4096), 22))
    w[:, :8] = 0.5
    ct = ops.encrypt(tctx, pk, encoding.encode(tctx.ntt, w, tctx.scale), gen)
    got = encoding.decode(tctx.ntt, ops.decrypt(tctx, sk, ct), ct.scale)
    assert torch.max(torch.abs(got - w)).item() < 5e-6


def test_sampler_moments(ctxs):
    # Moment checks with 5-sigma-safe bounds for 3*4096 / 8*4096 draws:
    # ternary mean ~ 0 and P(0) ~ 1/3; gaussian sigma ~ 3.2, |e| <= 6 sigma;
    # uniform eval residues below p with mean ~ p/2.
    _, tctx = ctxs
    gen = torch.Generator().manual_seed(23)
    p = torch.from_numpy(np.asarray(tctx.ntt.p).astype(np.int64))
    center = lambda r: torch.where(r.to(torch.int64) > p // 2, r.to(torch.int64) - p, r.to(torch.int64))  # noqa: E731
    tern = center(keys.sample_ternary_residues(tctx, gen, (3,)))[:, 0]
    assert tern.abs().max().item() <= 1
    assert abs(tern.float().mean().item()) < 0.03
    assert abs((tern == 0).float().mean().item() - 1 / 3) < 0.03
    gauss = center(keys.sample_gaussian_residues(tctx, gen, (8,)))
    assert torch.equal(gauss[:, 0], gauss[:, 1]) and torch.equal(gauss[:, 0], gauss[:, 2])
    assert abs(gauss[:, 0].float().std().item() - 3.2) < 0.1
    assert gauss.abs().max().item() <= 19
    uni = keys.sample_uniform_eval(tctx, gen, (4,)).to(torch.int64)
    assert torch.all((uni >= 0) & (uni < p))
    assert torch.allclose(uni.float().mean(dim=(0, 2)) / p[:, 0].float(),
                          torch.full((3,), 0.5), atol=0.01)
