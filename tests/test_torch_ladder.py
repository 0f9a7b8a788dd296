"""The port's rotate-and-sum ladder serving held against the JAX package.

The JAX package makes the keys and encrypts the queries; both go to the port
through `hefl_tpu_torch.convert`, and both packages score the same
ciphertexts with the same Galois/relin keys. Every output is a canonical
residue, so the port's ciphertexts must be BITWISE equal to the JAX
package's: the HE ops the ladder adds (`ct_mul_plain_poly`, `ct_conjugate`,
`negacyclic_poly_mul`), the stage loop, the linear scorer at n=256 and the
depth-2 MLP at n=512, L=5 (the JAX tests' geometries). The decrypted scores
sit within 0.05 of the plaintext model, the JAX tests' tolerance.
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

from hefl_tpu_torch import he_inference as hei
from hefl_tpu_torch.ckks import cuda_ntt, encoding, keys, ntt, ops
from hefl_tpu_torch.convert import (
    ciphertext_from_jax,
    galois_keys_from_jax,
    keys_from_jax,
    relin_key_from_jax,
)

torch.set_num_threads(2)

D, K = 100, 3          # features < 128 slots: the zero padding is summed too


def _same(got, want) -> None:
    """Bitwise equality of a port Ciphertext and a JAX one."""
    for g, w in ((got.c0, want.c0), (got.c1, want.c1)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.contiguous().numpy().view(np.uint32), np.asarray(w))
    assert got.scale == want.scale


@pytest.fixture(scope="module")
def setup():
    """n=256 (128 slots), L=3: JAX keys and the ladder's 7 Galois keys,
    converted to the port."""
    jctx = jkeys.CkksContext.create(n=256)
    tctx = keys.CkksContext.create(n=256)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(0))
    sk, pk = keys_from_jax(jsk, jpk)
    jgks = jhei.gen_rotation_keys(jctx, jsk, jax.random.key(1))
    rng = np.random.default_rng(4)
    model = rng.normal(0, 0.3, (K, D)), rng.normal(0, 0.2, K)
    return dict(jctx=jctx, tctx=tctx, jsk=jsk, jpk=jpk, sk=sk, pk=pk, jgks=jgks,
                gks=galois_keys_from_jax(jgks), model=model, rng=rng)


def _query(s, x, seed):
    jct = jhei.encrypt_features(s["jctx"], s["jpk"], x, jax.random.key(seed))
    return jct, ciphertext_from_jax(jct)


def _decode(ctx, sk, ct):
    res = ops.decrypt(ctx, sk, ct).numpy().view(np.uint32)
    return np.real(encoding.decode_slots(ctx.ntt, res, ct.scale))


def test_ct_mul_plain_poly_and_conjugate_bitwise(setup):
    s = setup
    jctx, tctx = s["jctx"], s["tctx"]
    x = s["rng"].normal(0, 0.5, 128) + 1j * s["rng"].normal(0, 0.5, 128)
    res = encoding.encode_slots(tctx.ntt, x, tctx.scale)
    jct = jax.jit(jops.encrypt, static_argnums=0)(jctx, s["jpk"], jnp.asarray(res),
                                                  jax.random.key(2))
    ct = ciphertext_from_jax(jct)
    w = s["rng"].normal(0, 0.3, (2, 128))
    w_res = encoding.encode_slots(tctx.ntt, w, 2.0**14)
    got = ops.ct_mul_plain_poly(tctx, ops.Ciphertext(ct.c0[None], ct.c1[None], ct.scale),
                                torch.from_numpy(w_res.view(np.int32)), 2.0**14)
    want = jax.jit(jops.ct_mul_plain_poly, static_argnums=(0, 3))(
        jctx, jops.Ciphertext(jct.c0[None], jct.c1[None], jct.scale), jnp.asarray(w_res), 2.0**14)
    _same(got, want)
    np.testing.assert_allclose(
        encoding.decode_slots(tctx.ntt, ops.decrypt(tctx, s["sk"], got).numpy().view(np.uint32),
                              got.scale), x * w, atol=1e-3)

    g = jgalois.galois_elt_conjugation(256)
    jgk = jkeys.gen_galois_key(jctx, s["jsk"], jax.random.key(3), g)
    gk = galois_keys_from_jax({0: jgk})[0]
    conj = ops.ct_conjugate(tctx, ct, gk)
    _same(conj, jax.jit(jops.ct_conjugate, static_argnums=0)(jctx, jct, jgk))
    z = encoding.decode_slots(tctx.ntt, ops.decrypt(tctx, s["sk"], conj).numpy().view(np.uint32),
                              conj.scale)
    np.testing.assert_allclose(z, np.conj(x), atol=1e-2)
    with pytest.raises(ValueError, match="conjugation needs"):
        ops.ct_conjugate(tctx, ct, s["gks"][1])


def test_negacyclic_poly_mul_bitwise():
    tctx = keys.CkksContext.create(n=256)
    rng = np.random.default_rng(5)
    p = np.asarray(tctx.ntt.p).astype(np.int64)
    a, b = ((rng.integers(0, 2**40, (2, 3, 256)) % p).astype(np.uint32) for _ in range(2))
    got = ntt.negacyclic_poly_mul(tctx.ntt, torch.from_numpy(a.view(np.int32)),
                                  torch.from_numpy(b.view(np.int32)))
    jctx = jkeys.CkksContext.create(n=256)
    want = jntt.negacyclic_poly_mul(jctx.ntt, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    # Against the schoolbook negacyclic product under the first prime.
    p0 = int(p[0, 0])
    x, y = a[0, 0].astype(object), b[0, 0].astype(object)
    full = np.zeros(512, dtype=object)
    for i in range(256):
        full[i:i + 256] += x[i] * y
    ref = np.array([(full[k] - full[k + 256]) % p0 for k in range(256)], dtype=np.int64)
    np.testing.assert_array_equal(got[0, 0].numpy().astype(np.int64), ref)


def test_rotate_and_sum_scan_matches_unrolled_and_jax(setup):
    s = setup
    tctx = s["tctx"]
    x = s["rng"].normal(0, 0.5, 128)
    jct, ct = _query(s, x, 9)
    ladder = hei.stack_rotation_ladder(tctx, s["gks"], "cpu")
    cuda_ntt.reset_launch_counts()
    got = hei.rotate_and_sum_scan(tctx, ct, ladder)
    assert cuda_ntt.launch_counts() == dict.fromkeys(cuda_ntt.LAUNCHES, 0)
    ref = hei.rotate_and_sum(tctx, ct, s["gks"])
    assert torch.equal(got.c0, ref.c0) and torch.equal(got.c1, ref.c1)
    jladder = jhei.stack_rotation_ladder(s["jctx"], s["jgks"])
    _same(got, jhei.rotate_and_sum_scan(s["jctx"], jct, jladder))
    np.testing.assert_allclose(_decode(tctx, s["sk"], got), x.sum(), atol=5e-2 * np.sqrt(128))
    assert hei.ladder_stage_forward_ntts(tctx) == jhei.ladder_stage_forward_ntts(s["jctx"])
    assert hei.ladder_stage_forward_ntts(tctx) == 3 * tctx.ksk_num_digits + 1


def test_linear_scorer_bitwise_vs_jax(setup):
    # score (K ciphertexts), score_batched, score_many on B=3 and the
    # one-shot encrypted_linear: bitwise the JAX scorer's; decrypt_scores
    # and decrypt_score_matrix equal the JAX decrypts.
    s = setup
    W, b = s["model"]
    tctx, jctx = s["tctx"], s["jctx"]
    x = s["rng"].normal(0, 0.5, D)
    jct, ct = _query(s, x, 5)
    scorer = hei.LinearScorer(tctx, W, b, s["gks"], device="cpu")
    jscorer = jhei.LinearScorer(jctx, W, b, s["jgks"])
    outs = scorer.score(ct)
    jouts = jscorer.score(jct)
    assert len(outs) == K
    for got, want in zip(outs, jouts):
        _same(got, want)
    for got, want in zip(hei.encrypted_linear(tctx, ct, W, b, s["gks"]), jouts):
        _same(got, want)
    scores = hei.decrypt_scores(tctx, s["sk"], outs)
    np.testing.assert_array_equal(scores, jhei.decrypt_scores(jctx, s["jsk"], jouts))
    np.testing.assert_allclose(scores, x @ W.T + b, atol=0.05)
    assert np.argmax(scores) == np.argmax(x @ W.T + b)

    xs = s["rng"].normal(0, 0.5, (3, D))
    jcts = jhei.encrypt_features(jctx, s["jpk"], xs, jax.random.key(6))
    out = scorer.score_many(ciphertext_from_jax(jcts))
    jout = jscorer.score_many(jcts)
    _same(out, jout)
    mat = hei.decrypt_score_matrix(tctx, s["sk"], out)
    assert mat.shape == (3, K)
    np.testing.assert_array_equal(mat, jhei.decrypt_score_matrix(jctx, s["jsk"], jout))
    np.testing.assert_allclose(mat, xs @ W.T + b, atol=0.05)


def test_linear_scorer_checks(setup):
    s = setup
    W, b = s["model"]
    tctx = s["tctx"]
    _, ct = _query(s, s["rng"].normal(0, 0.5, D), 7)
    scorer = hei.LinearScorer(tctx, W, b, s["gks"], device="cpu")
    with pytest.raises(ValueError, match="batched"):
        scorer.score_many(ct)
    with pytest.raises(ValueError, match="scale"):
        scorer.score(ops.Ciphertext(ct.c0, ct.c1, 2.0))
    with pytest.raises(ValueError, match="rotation keys missing"):
        hei.LinearScorer(tctx, W, b, {1: s["gks"][1]}, device="cpu")
    with pytest.raises(ValueError, match="weights must be"):
        hei.LinearScorer(tctx, np.zeros((K, 129)), b, s["gks"], device="cpu")
    with pytest.raises(ValueError, match="bias must be"):
        hei.LinearScorer(tctx, W, np.zeros(K + 1), s["gks"], device="cpu")


def test_port_rotation_keys_decrypt_to_slot_total():
    # The port's own keys (its generator, seeded by (seed, step)): a
    # rotate-and-sum of its own encryption decrypts to the slot total, and
    # the ladder scorer to the plaintext scores.
    ctx = keys.CkksContext.create(n=256)
    gen = torch.Generator().manual_seed(11)
    sk, pk = keys.keygen(ctx, gen, device="cpu")
    gks = hei.gen_rotation_keys(ctx, sk, 12)
    assert sorted(gks) == hei.rotation_steps(128)
    again = hei.gen_rotation_keys_for_steps(ctx, sk, 12, [4])
    assert torch.equal(again[4].b_mont, gks[4].b_mont)
    rng = np.random.default_rng(13)
    x = rng.normal(0, 0.5, 128)
    ct = hei.encrypt_features(ctx, pk, x, gen)
    total = hei.rotate_and_sum(ctx, ct, gks)
    np.testing.assert_allclose(_decode(ctx, sk, total), x.sum(), atol=5e-2 * np.sqrt(128))
    W, b = rng.normal(0, 0.3, (K, D)), rng.normal(0, 0.2, K)
    got = hei.decrypt_scores(ctx, sk, hei.encrypted_linear(ctx, ct, W, b, gks))
    np.testing.assert_allclose(got, x[:D] @ W.T + b, atol=0.05)


def test_mlp_scorer_bitwise_vs_jax():
    # The depth-2 MLP (d=16, H=4, K=3) at n=512, L=5, tests/test_he_inference.py's
    # geometry: the hidden ladder, the square with relinearization, two
    # rescales, the constant output layer; bitwise vs the JAX scorer, within
    # 0.05 of the plaintext circuit, one sample and a batch of 3.
    jctx = jkeys.CkksContext.create(n=512, num_primes=5)
    tctx = keys.CkksContext.create(n=512, num_primes=5)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(10))
    sk, _ = keys_from_jax(jsk, jpk)
    jgks = jhei.gen_rotation_keys(jctx, jsk, jax.random.key(11))
    jrlk = jkeys.gen_relin_key(jctx, jsk, jax.random.key(12))
    gks, rlk = galois_keys_from_jax(jgks), relin_key_from_jax(jrlk)
    rng = np.random.default_rng(13)
    d, hidden = 16, 4
    x = rng.normal(0, 0.4, d)
    w1, b1 = rng.normal(0, 0.3, (hidden, d)), rng.normal(0, 0.2, hidden)
    w2, b2 = rng.normal(0, 0.3, (K, hidden)), rng.normal(0, 0.2, K)
    want = lambda v: ((v @ w1.T + b1) ** 2) @ w2.T + b2  # noqa: E731

    jct = jhei.encrypt_features(jctx, jpk, x, jax.random.key(14))
    jsub, jouts = jhei.encrypted_mlp(jctx, jct, w1, b1, w2, b2, jgks, jrlk)
    sub, outs = hei.encrypted_mlp(tctx, ciphertext_from_jax(jct), w1, b1, w2, b2, gks, rlk)
    assert sub.num_primes == jsub.num_primes == 3
    for got, exp in zip(outs, jouts):
        _same(got, exp)
    sk_dec = hei.slice_secret_key(sk, sub.num_primes)
    scores = hei.decrypt_scores(sub, sk_dec, outs)
    np.testing.assert_array_equal(
        scores, jhei.decrypt_scores(jsub, jhei.slice_secret_key(jsk, jsub.num_primes), jouts))
    np.testing.assert_allclose(scores, want(x), atol=0.05)
    assert np.argmax(scores) == np.argmax(want(x))

    xs = rng.normal(0, 0.4, (3, d))
    jcts = jhei.encrypt_features(jctx, jpk, xs, jax.random.key(15))
    scorer = hei.MlpScorer(tctx, w1, b1, w2, b2, gks, rlk, device="cpu")
    jscorer = jhei.MlpScorer(jctx, w1, b1, w2, b2, jgks, jrlk)
    out = scorer.score_many(ciphertext_from_jax(jcts))
    _same(out, jscorer.score_many(jcts))
    mat = hei.decrypt_score_matrix(scorer.sub_ctx, sk_dec, out)
    np.testing.assert_allclose(mat, want(xs), atol=0.05)
    assert scorer.num_keyswitches == hei.ladder_keyswitches(256, hidden) + hidden
    with pytest.raises(ValueError, match="w2 must be"):
        hei.MlpScorer(tctx, w1, b1, w2[:, :2], b2, gks, rlk, device="cpu")
