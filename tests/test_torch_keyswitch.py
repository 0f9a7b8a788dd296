"""The port's key-switching layer held against the JAX package: the plain
versions of K5 (fused gadget key-switch) and K6 (hoisted-rotation products),
the Galois tables, and the key-switching keys.

Every output is a canonical residue, so the port must agree BITWISE with the
JAX package's XLA references (`ops._keyswitch_coeff_xla`,
`ops._hoisted_products_xla`) and, at n=1024, with its Pallas kernels run in
interpret mode as tests/test_pallas_he.py and tests/test_hoisted.py run
them. Inputs are made from a seed with numpy; JAX keys reach the port
through `hefl_tpu_torch.convert`. The CUDA kernels themselves are held
against these plain versions on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu import he_inference as jhei
from hefl_tpu.ckks import galois as jgalois
from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import ntt as jntt
from hefl_tpu.ckks import ops as jops
from hefl_tpu.ckks import pallas_ntt

from hefl_tpu_torch import he_inference as hei
from hefl_tpu_torch.ckks import cuda_ntt, galois, keys, ntt
from hefl_tpu_torch.convert import keys_from_jax

torch.set_num_threads(2)


def _t(a) -> torch.Tensor:
    """JAX uint32 array -> port int32 tensor with the same bits."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _ctx_pair(n: int, num_primes: int):
    return (jkeys.CkksContext.create(n=n, num_primes=num_primes),
            keys.CkksContext.create(n=n, num_primes=num_primes))


def _canon(ctx, shape, seed) -> np.ndarray:
    """Canonical residues uint32[*shape, L, N] from a seed."""
    p = np.asarray(ctx.ntt.p).astype(np.int64)
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**40, size=(*shape, ctx.num_primes, ctx.n), dtype=np.int64)
    return (raw % p).astype(np.uint32)


_j_ks_coeff = jax.jit(jops._keyswitch_coeff_xla, static_argnums=0)
_j_ks_eval = jax.jit(
    lambda ctx, x, b, a: jops._keyswitch_coeff_xla(ctx, jntt.ntt_inverse(ctx.ntt, x), b, a),
    static_argnums=0,
)
_j_hoist = jax.jit(jops._hoisted_products_xla, static_argnums=0)


@pytest.mark.parametrize("eval_input", [False, True], ids=["coeff", "eval"])
@pytest.mark.parametrize("num_primes", [3, 5])
@pytest.mark.parametrize("n", [256, 1024])
def test_keyswitch_plain_bitwise_vs_xla(n, num_primes, eval_input):
    # Bitwise: K5's plain version against ops._keyswitch_coeff_xla (after
    # the inverse NTT in eval-input mode, as ops._keyswitch_d2 runs it), for
    # a single polynomial and a batch of two. L=5 makes a mix-up between a
    # limb's own prime and the output prime show.
    jctx, tctx = _ctx_pair(n, num_primes)
    num_c = num_primes * jctx.ksk_num_digits + 1
    bk, ak = _canon(jctx, (num_c,), 1), _canon(jctx, (num_c,), 2)
    ref = _j_ks_eval if eval_input else _j_ks_coeff
    for batch, seed in (((), 3), ((2,), 4)):
        x = _canon(jctx, batch, seed)
        want = ref(jctx, jnp.asarray(x), jnp.asarray(bk), jnp.asarray(ak))
        got = cuda_ntt.keyswitch_fused_plain(
            tctx.ntt, _t(x), _t(bk), _t(ak), tctx.ksk_digit_bits, tctx.ksk_num_digits,
            eval_input=eval_input,
        )
        for g, w in zip(got, want):
            assert g.shape == x.shape
            np.testing.assert_array_equal(_u(g), np.asarray(w))


@pytest.mark.parametrize("eval_input,num_primes,batch", [
    (False, 3, (2,)), (True, 5, ()),
], ids=["coeff-L3-B2", "eval-L5"])
def test_keyswitch_plain_bitwise_vs_pallas_interpret(eval_input, num_primes, batch):
    # Bitwise: K5's plain version against keyswitch_fused_pallas run in
    # interpret mode at n=1024, the smallest ring the TPU kernel tiles.
    jctx, tctx = _ctx_pair(1024, num_primes)
    num_c = num_primes * jctx.ksk_num_digits + 1
    bk, ak = _canon(jctx, (num_c,), 5), _canon(jctx, (num_c,), 6)
    x = _canon(jctx, batch, 7)
    want = pallas_ntt.keyswitch_fused_pallas(
        jctx.ntt, jnp.asarray(x), jnp.asarray(bk), jnp.asarray(ak),
        digit_bits=jctx.ksk_digit_bits, num_digits=jctx.ksk_num_digits,
        eval_input=eval_input, interpret=True,
    )
    got = cuda_ntt.keyswitch_fused_plain(
        tctx.ntt, _t(x), _t(bk), _t(ak), tctx.ksk_digit_bits, tctx.ksk_num_digits,
        eval_input=eval_input,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g), np.asarray(w))


@pytest.mark.parametrize("n", [256, 1024])
def test_hoisted_products_plain_bitwise_vs_xla(n):
    # Bitwise: K6's plain version against ops._hoisted_products_xla for one
    # ciphertext and a batch of two, and S=0 gives empty outputs.
    jctx, tctx = _ctx_pair(n, 3)
    num_r = jctx.num_primes * jctx.ksk_num_digits
    bk, ak = _canon(jctx, (3, num_r), 8), _canon(jctx, (3, num_r), 9)
    for batch, seed in (((), 10), ((2,), 11)):
        c0, d = _canon(jctx, batch, seed), _canon(jctx, (*batch, num_r), seed + 10)
        want = _j_hoist(jctx, *map(jnp.asarray, (c0, d, bk, ak)))
        got = cuda_ntt.hoisted_products_plain(tctx.ntt, *map(_t, (c0, d, bk, ak)))
        for g, w in zip(got, want):
            assert tuple(g.shape) == (3, *batch, 3, n)
            np.testing.assert_array_equal(_u(g), np.asarray(w))
        empty = cuda_ntt.hoisted_products(tctx.ntt, _t(c0), _t(d), _t(bk[:0]), _t(ak[:0]))
        assert all(tuple(e.shape) == (0, *batch, 3, n) for e in empty)


def test_hoisted_products_plain_bitwise_vs_pallas_interpret():
    # Bitwise at n=1024 against hoisted_rotations_pallas in interpret mode,
    # B=2, and the kernel's own S=0 contract.
    jctx, tctx = _ctx_pair(1024, 3)
    num_r = jctx.num_primes * jctx.ksk_num_digits
    bk, ak = _canon(jctx, (2, num_r), 12), _canon(jctx, (2, num_r), 13)
    c0, d = _canon(jctx, (2,), 14), _canon(jctx, (2, num_r), 15)
    want = pallas_ntt.hoisted_rotations_pallas(
        jctx.ntt, *map(jnp.asarray, (c0, d, bk, ak)), interpret=True
    )
    got = cuda_ntt.hoisted_products_plain(tctx.ntt, *map(_t, (c0, d, bk, ak)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g), np.asarray(w))
    want0 = pallas_ntt.hoisted_rotations_pallas(
        jctx.ntt, *map(jnp.asarray, (c0, d, bk[:0], ak[:0])), interpret=True
    )
    got0 = cuda_ntt.hoisted_products_plain(tctx.ntt, *map(_t, (c0, d, bk[:0], ak[:0])))
    assert tuple(got0[0].shape) == tuple(want0[0].shape) == (0, 2, 3, 1024)


# --- Galois tables -----------------------------------------------------------


@pytest.mark.parametrize("n", [256, 1024])
def test_galois_tables_equal_jax(n):
    # Array-equal host tables: the coefficient automorphism and the
    # evaluation permutation (derived from each package's own NTT).
    jctx, tctx = _ctx_pair(n, 3)
    gs = [galois.galois_elt_rotation(n, s) for s in (1, 2, 5, n // 4 - 1)]
    gs.append(galois.galois_elt_conjugation(n))
    for g in gs:
        for got, want in zip(galois.automorphism_tables(n, g), jgalois.automorphism_tables(n, g)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(galois.eval_permutation(tctx.ntt, g),
                             jgalois.eval_permutation(jctx.ntt, g)):
            np.testing.assert_array_equal(got, want)
    assert galois.galois_elt_rotation(n, 3) == jgalois.galois_elt_rotation(n, 3)
    assert galois.galois_elt_conjugation(n) == jgalois.galois_elt_conjugation(n)


def test_eval_permutation_is_the_automorphism_in_eval_domain():
    # Bitwise: NTT(phi_g(a)) == NTT(a)[..., perm], for rotations and the
    # conjugation (the identity tests/test_hoisted.py pins for JAX).
    _, tctx = _ctx_pair(256, 3)
    tabs = ntt.plain_tables(tctx.ntt, "cpu")
    a = _t(_canon(tctx, (2,), 16))
    for g in [galois.galois_elt_rotation(256, s) for s in (1, 2, 5, 31)] + [511]:
        src, flip = galois.automorphism_tensors(256, g, "cpu")
        lhs = ntt.ntt_forward(tctx.ntt, galois.apply_automorphism(a, tabs.p, src, flip))
        perm, inv_perm = galois.eval_permutation(tctx.ntt, g)
        rhs = ntt.ntt_forward(tctx.ntt, a)[..., torch.from_numpy(perm.astype(np.int64))]
        assert torch.equal(lhs, rhs)
        assert (perm[inv_perm] == np.arange(256)).all()


def test_apply_automorphism_bitwise_vs_jax():
    jctx, tctx = _ctx_pair(256, 3)
    a = _canon(jctx, (2,), 17)
    g = galois.galois_elt_rotation(256, 7)
    src, flip = jgalois.automorphism_tables(256, g)
    want = jgalois.apply_automorphism(jnp.asarray(a), jnp.asarray(jctx.ntt.p), src, flip)
    got = galois.apply_automorphism(
        _t(a), ntt.plain_tables(tctx.ntt, "cpu").p, *galois.automorphism_tensors(256, g, "cpu")
    )
    np.testing.assert_array_equal(_u(got), np.asarray(want))


# --- Key-switching keys --------------------------------------------------------


@pytest.fixture(scope="module")
def key_setup():
    jctx, tctx = _ctx_pair(256, 3)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(30))
    sk, _ = keys_from_jax(jsk, jpk)
    return jctx, tctx, jsk, sk


def _jax_ksk_samples(jctx, key):
    num_c = jctx.num_primes * jctx.ksk_num_digits + 1
    k_a, k_e = jax.random.split(key)
    return (_t(jkeys.sample_uniform_eval(jctx, k_a, (num_c,))),
            _t(jkeys.sample_gaussian_residues(jctx, k_e, (num_c,))))


def test_context_gadget_geometry_equals_jax(key_setup):
    jctx, tctx, _, _ = key_setup
    assert tctx.ksk_digit_bits == jctx.ksk_digit_bits == 5
    assert tctx.ksk_num_digits == jctx.ksk_num_digits == 6
    np.testing.assert_array_equal(keys._crt_gadget_residues(tctx), jkeys._crt_gadget_residues(jctx))
    np.testing.assert_array_equal(keys._center_correction_residues(tctx),
                                  jkeys._center_correction_residues(jctx))
    assert hash(tctx) == hash(keys.CkksContext.create(n=256)) and tctx == keys.CkksContext.create(n=256)
    import dataclasses
    assert dataclasses.replace(tctx, ksk_digit_bits=9) != tctx


def test_gen_relin_key_core_bitwise(key_setup):
    # Bitwise: the port's deterministic key core on the JAX package's samples.
    jctx, tctx, jsk, sk = key_setup
    key = jax.random.key(31)
    want = jkeys.gen_relin_key(jctx, jsk, key)
    b, a = keys.gen_ksk_core(tctx, sk, keys.relin_target(tctx, sk), *_jax_ksk_samples(jctx, key))
    np.testing.assert_array_equal(_u(b), np.asarray(want.b_mont))
    np.testing.assert_array_equal(_u(a), np.asarray(want.a_mont))


def test_gen_galois_key_core_bitwise(key_setup):
    jctx, tctx, jsk, sk = key_setup
    key = jax.random.key(32)
    g = galois.galois_elt_rotation(256, 5)
    want = jkeys.gen_galois_key(jctx, jsk, key, g)
    b, a = keys.gen_ksk_core(tctx, sk, keys.galois_target(tctx, sk, g), *_jax_ksk_samples(jctx, key))
    np.testing.assert_array_equal(_u(b), np.asarray(want.b_mont))
    np.testing.assert_array_equal(_u(a), np.asarray(want.a_mont))


def test_rotation_keys_depend_on_seed_and_step_only(key_setup):
    # The same (seed, step) gives the same key in any step set; another seed
    # or step gives another key.
    _, tctx, _, sk = key_setup
    small = hei.gen_rotation_keys_for_steps(tctx, sk, 40, [3])
    big = hei.gen_rotation_keys_for_steps(tctx, sk, 40, [0, 1, 3, 9, 3])
    other = hei.gen_rotation_keys_for_steps(tctx, sk, 41, [3])
    assert sorted(big) == [1, 3, 9]
    assert torch.equal(small[3].b_mont, big[3].b_mont) and small[3].g == big[3].g
    assert not torch.equal(small[3].b_mont, other[3].b_mont)
    assert not torch.equal(big[1].a_mont[0], big[3].a_mont[0])
    assert tuple(big[9].b_mont.shape) == (tctx.num_primes * tctx.ksk_num_digits + 1, 3, 256)
    assert jhei.rotation_steps(128) == hei.rotation_steps(128)
